"""Data-availability restart log (paper §3.12).

Unlike Condor's rescue DAG (which tags *jobs* as finished), Swift logs
*datasets successfully produced*.  On restart, logged datasets are marked
available and only tasks whose outputs are missing re-run.  Side effects the
paper calls out — both supported and tested:

  (a) new inputs added after a partial run are picked up on restart;
  (b) the program can be modified and restarted, as long as prior data flows
      are unchanged (keys are dataflow-derived, not graph-position-derived).

Values must be JSON-serializable or `PhysicalRef`s (artifact pointers);
artifact entries are only honored on resume if the files still exist.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

from repro_torch.core.xdtm import PhysicalRef


def encode_value(value: Any):
    """JSON-encodable form of a task value: `PhysicalRef`s become tagged
    dicts, containers recurse, scalars pass through.  Shared by
    `RestartLog` and the sqlite `JobStore` so both durability layers
    agree on what a persisted value means."""
    if isinstance(value, PhysicalRef):
        return {"__ref__": value.path, "meta": list(value.meta)}
    if isinstance(value, (list, tuple)):
        return [encode_value(v) for v in value]
    if isinstance(value, dict):
        return {k: encode_value(v) for k, v in value.items()}
    return value


def decode_value(value: Any):
    """Inverse of `encode_value` (tagged dicts back to `PhysicalRef`s)."""
    if isinstance(value, dict) and "__ref__" in value:
        return PhysicalRef(value["__ref__"], tuple(value.get("meta", ())))
    if isinstance(value, list):
        return [decode_value(v) for v in value]
    if isinstance(value, dict):
        return {k: decode_value(v) for k, v in value.items()}
    return value


def physical_refs(value: Any) -> list[PhysicalRef]:
    """Every `PhysicalRef` reachable inside a value — resume only honors
    an entry if all of them still exist on disk."""
    out = []
    if isinstance(value, PhysicalRef):
        out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out.extend(physical_refs(v))
    elif isinstance(value, dict):
        for v in value.values():
            out.extend(physical_refs(v))
    return out


class RestartLog:
    """Append-only log of datasets successfully produced (paper §3.12).

    Pass to `Engine(restart_log=...)` and mark procedures/tasks
    ``durable=True``: their results are appended on success, and a rerun
    of the same program resolves logged outputs immediately instead of
    re-executing the producing tasks.

    Example::

        log = RestartLog("run.rlog")
        eng = Engine(restart_log=log)
        eng.submit("stage1", expensive_fn, durable=True)
        # ... crash, restart: the same submit returns the logged value
    """

    def __init__(self, path: str):
        self.path = path
        self._log: dict[str, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    self._log[rec["key"]] = decode_value(rec["value"])

    def append(self, key: str, value: Any) -> None:
        try:
            enc = encode_value(value)
            json.dumps(enc)
        except (TypeError, ValueError):
            return  # non-durable value; skip logging
        self._log[key] = value
        with open(self.path, "a") as f:
            f.write(json.dumps({"key": key, "value": enc}) + "\n")

    def lookup(self, key: str) -> Tuple[bool, Any]:
        if key not in self._log:
            return False, None
        value = self._log[key]
        # artifact entries only count if the physical data still exists
        for ref in physical_refs(value):
            if not ref.exists():
                return False, None
        return True, value

    def items(self):
        """(key, decoded value) pairs — `JobStore.import_restart_log`
        reads these to seed a durable store from a legacy .rlog file."""
        return self._log.items()

    def __len__(self):
        return len(self._log)

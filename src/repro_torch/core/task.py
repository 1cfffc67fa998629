"""Task records, dataflow keying, and task-body execution.

Lowest layer of the scheduler stack (see DESIGN.md §1): a task is a
lightweight record — no OS thread, Karajan-style — carrying its callable,
argument futures, output future, and retry/provenance bookkeeping.  Both the
engine and every provider operate on these records; execution of the body
(`execute_task`) and simulated-duration lookup (`sim_duration`) live here so
providers and the Falkon service share one implementation.
"""
from __future__ import annotations

import hashlib
import itertools
import weakref
from typing import Optional

import torch

from repro_torch.core.futures import DataFuture

_task_ids = itertools.count()


class FnKeyRegistry:
    """Stable, GC-safe identity keys for callables.

    ``id(fn)`` is only unique while `fn` is alive: once collected, a new
    callable can land at the same address, so any cache keyed on raw ids
    (vmap bundles, compiled-function caches, prediction caches) can
    silently serve results for the *wrong* callable.  This registry hands
    out monotonically increasing serials and invalidates an id's entry the
    moment its callable dies (weakref finalizer), so a reused address gets
    a fresh serial.  Callables that cannot be weak-referenced (builtins,
    some C extensions) are pinned with a strong reference instead — their
    id can then never be reused while the registry lives.

    Single-threaded by contract: call only from the clock thread (the
    same contract every scheduler object follows, DESIGN.md §10).
    """

    __slots__ = ("_serial", "_by_id")

    def __init__(self):
        self._serial = itertools.count()
        self._by_id: dict = {}     # id(fn) -> (serial, weakref-or-strong-ref)

    def __len__(self) -> int:
        return len(self._by_id)

    def key(self, fn) -> int:
        i = id(fn)
        ent = self._by_id.get(i)
        if ent is not None:
            serial, ref = ent
            target = ref() if isinstance(ref, weakref.ref) else ref
            if target is fn:
                return serial
        serial = next(self._serial)
        try:
            ref = weakref.ref(fn, self._make_reaper(i))
        except TypeError:
            ref = fn                       # un-weakrefable: pin it
        self._by_id[i] = (serial, ref)
        return serial

    def _make_reaper(self, i: int):
        by_id = self._by_id

        def reap(dead_ref):
            # only drop the entry if it still belongs to the dead callable
            # — the id may already have been reused and re-registered
            ent = by_id.get(i)
            if ent is not None and ent[1] is dead_ref:
                del by_id[i]

        return reap


_fn_keys = FnKeyRegistry()


def stable_fn_key(fn) -> int:
    """Process-wide stable identity key for a callable (see
    `FnKeyRegistry`).  Unlike ``id(fn)``, the key is never reused for a
    different callable, so it is safe in long-lived signature caches."""
    return _fn_keys.key(fn)


def arg_signature(args) -> tuple:
    """Structural signature of a call's argument values: per-argument
    ``(shape, dtype-or-type-name)``.  Array-likes (numpy, anything with
    `.shape`) contribute shape + dtype; a torch tensor adds its device, so
    tensors on the CPU and on a card never share a bundle; scalars and
    other literals contribute their type name.  Two calls with equal
    signatures can be stacked along a new leading axis and executed as one
    vmapped call."""
    sig = []
    for a in args:
        if isinstance(a, torch.Tensor):
            sig.append((tuple(a.shape), str(a.dtype), str(a.device)))
            continue
        shape = getattr(a, "shape", None)
        if shape is not None:
            sig.append((tuple(shape), str(getattr(a, "dtype", ""))))
        else:
            sig.append(((), type(a).__name__))
    return tuple(sig)


class Task:
    """One schedulable unit: a lightweight record, not an OS thread.

    Carries the callable (`fn`, None for pure-simulation tasks), argument
    futures (`args`), the output `DataFuture`, declared file `inputs` for
    the data layer, and retry/provenance bookkeeping.  Engines create these
    via `Engine.submit`; providers and the Falkon service consume them.

    Example (normally done for you by `Engine.submit`)::

        t = Task("double", lambda x: 2 * x, [21], DataFuture(),
                 duration=None, app=None, retries=0, durable=False, key="")
        ok, value, err = execute_task(t)      # -> (True, 42, None)
    """

    # "span"/"path0" are observability fields (DESIGN.md §12), deliberately
    # NOT initialized in __init__: the tracing-off hot path never touches
    # them, and the engine assigns both at submit/ready time when a tracer
    # is attached ("path0" encodes parent critical path minus ready time).
    __slots__ = ("id", "name", "key", "fn", "args", "output", "duration",
                 "sim_value", "app", "attempt", "retries_left", "site",
                 "host", "created_time", "submit_time", "start_time",
                 "durable", "fault_check", "_falkon_done", "vmap_key",
                 "site_failures", "inputs", "span", "path0")

    def __init__(self, name: str, fn, args, output: DataFuture,
                 duration: float | None, app: str | None,
                 retries: int, durable: bool, key: str,
                 inputs: tuple = ()):
        self.id = next(_task_ids)
        self.name = name
        self.key = key
        self.fn = fn
        self.args = args
        self.output = output
        self.duration = duration
        self.sim_value = None
        self.app = app
        self.attempt = 0
        self.retries_left = retries
        self.site = None
        self.host = ""
        self.created_time = 0.0
        self.submit_time = 0.0
        self.start_time = 0.0
        self.durable = durable
        self.fault_check = None
        self.vmap_key = None
        # declared file inputs (DataObject tuple) — the data layer's
        # cache-aware dispatch keys on these; empty for compute-only tasks
        self.inputs = inputs
        # lazily allocated on first failure: a dict per task is measurable
        # overhead at 10^6 tasks and almost all tasks never fail
        self.site_failures: Optional[dict] = None


def task_key(name: str, args: list) -> str:
    """Dataflow-stable key for restart-log lookups (paper §3.12).

    Derived from the task name and the *identity* of its inputs (future
    names, array fingerprints, literal reprs) — not from graph position — so
    a modified-and-restarted program still resolves unchanged flows.
    """
    parts = [name]
    for a in args:
        if isinstance(a, DataFuture):
            parts.append(f"f:{a.name or a.id}")
        elif hasattr(a, "shape") and hasattr(a, "dtype"):
            # arrays: cheap structural fingerprint (repr would format the
            # whole buffer)
            parts.append(f"arr:{a.shape}:{a.dtype}:{id(a)}")
        else:
            parts.append(repr(a))
    return name + "#" + hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


def sim_duration(task) -> float:
    d = getattr(task, "duration", None)
    return float(d) if d else 0.0


def execute_task(task):
    """Run a task body, returning (ok, value, error).

    Pure-simulation tasks (no callable, no fault check) take the early path:
    they dominate the paper-figure benchmarks and must cost O(ns), not a
    try/except plus an argument scan.
    """
    chk = getattr(task, "fault_check", None)
    fn = getattr(task, "fn", None)
    if chk is None and fn is None:
        return True, getattr(task, "sim_value", None), None
    if chk is not None:
        try:
            chk(task)
        except BaseException as err:  # noqa: BLE001
            return False, None, err
    if fn is None:
        return True, getattr(task, "sim_value", None), None
    try:
        args = [a.get() if hasattr(a, "get") and hasattr(a, "on_done") else a
                for a in task.args]
        return True, fn(*args), None
    except BaseException as err:  # noqa: BLE001 - engine handles retries
        return False, None, err

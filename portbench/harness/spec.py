"""Reading the benchmark: `BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

* `configs/<config>.json`: the configuration as it is run (its `file` in
  `BENCHMARK.json`), with its `family`;
* `traffic/<mix>.json`: the mix's parameters; its `kind` names the driver
  (`drivers/<kind>.py`) that generates and sends it;
* `metrics/<metric>.py`: the reader of one metric, `read(records)`;
* `adapters/<family>.py`: the family's configuration handed to the port;
* `reference/<family>.py`: the family's plain reference;
* `limits/<cell>.json`: the limit of each number compared in the cell.

A new configuration, mix or metric is new files and new entries; no file
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

def load_module(path: Path, name: str | None = None):
    """Import one file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_file.{path.stem}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    root: Path                  # the checkout (holds BENCHMARK.json)
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list[dict]      # the cell's end-to-end metrics, in file order
    per_layer: list[dict]       # the cell's per-layer metrics, in file order
    limits: dict

    @property
    def pkg(self) -> Path:
        return self.root / "portbench"

    @property
    def family(self) -> str:
        return self.config["family"]

    def driver(self):
        return load_module(self.pkg / "drivers" / f"{self.traffic['kind']}.py")

    def adapter(self):
        return load_module(self.pkg / "adapters" / f"{self.family}.py")

    def reference(self):
        return load_module(self.pkg / "reference" / f"{self.family}.py")

    def reader(self, metric: str):
        return load_module(self.pkg / "metrics" / f"{metric}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    # a per-layer metric without `workloads` goes to every cell that
    # reports the end-to-end metric it moves
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    lim_path = root / "portbench" / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    return Cell(root, name, int(w["chips"]), w["config"], config, w["traffic"], traffic,
                e2e, per, limits)

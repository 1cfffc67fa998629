"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

`run.py` calls `run_cell` after its look for a card; the benchmark's own
tests call it on the CPU at tiny sizes, with the timed path broken
underneath (`fault=`); they and `control.py` also put the control in the
program's place (`control=True`): the check then reads the control at the
positions it reads the program, and `correct` judges the control's
numbers (`control_<name>`) against the limits.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import time
from pathlib import Path

import torch

from portbench.harness import roofline
from portbench.harness.program import Program, import_port
from portbench.harness.spec import Cell, load_cell
from portbench.harness.stats import derive
from portbench.harness.trace import traced
from portbench.harness import weights as W


@dataclasses.dataclass
class Ctx:
    """What a driver works with."""
    cell: Cell
    seed: int
    device: torch.device
    cfg: object                 # the port's config
    program: Program
    params: dict
    reference: object           # the family's plain reference module
    control: bool = False

    @property
    def conf(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def limits(self) -> dict:
        return self.cell.limits

    @property
    def vocab(self) -> int:
        return self.cell.config["vocab_size"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Records:
    """What a metric reader reads (`metrics/<name>.py`, `read(records)`)."""
    cell: Cell
    setup_s: float
    window: dict
    slice: dict | None
    trace: object | None        # harness.trace.Trace of the traced slice
    reference: object
    peaks: dict

    @property
    def conf(self) -> dict:
        return self.cell.config


def make_params(ctx_cell: Cell, adapter, cfg, seed: int, device):
    """The run's weights, drawn on `device` from the seed in the
    configuration's serving dtype."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "weights"))
    dtype = getattr(torch, ctx_cell.config["torch_dtype"])
    return W.make(adapter.descriptors(cfg), g, device, dtype=dtype,
                  contracted=getattr(adapter, "CONTRACTED", None),
                  rules=ctx_cell.config.get("init"))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", fault: str | None = None, control: bool = False,
             t_start: float | None = None, cell: Cell | None = None, log=None) -> dict:
    """Run one cell; return {"result": the result line's dict, "checks":
    {name: (value, limit)}, "numbers": every number the check read}."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = cell or load_cell(Path(root), name)
    dev = torch.device(device)
    import_port()
    adapter, reference = cell.adapter(), cell.reference()
    cfg = adapter.port_config(cell.config)
    program = Program(cfg, fault=fault)
    driver = cell.driver()
    ctx = Ctx(cell, seed, dev, cfg, program,
              make_params(cell, adapter, cfg, seed, dev),
              reference, control)
    state = driver.setup(ctx)
    ctx.sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    w = driver.window(ctx, state, seconds)
    sl, tr = None, None
    if trace:
        path = Path(root) / "build" / "portbench" / "trace" / f"{name}.json"
        with traced(path, ctx.sync) as holder:
            sl = driver.traced_slice(ctx, state)
        tr = holder["trace"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted, failed = driver.counts(ctx, w)
    driver.release(ctx, state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec = Records(cell, setup_s, w, sl, tr, reference, roofline.peaks(kind))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    numbers = driver.check(ctx, state, w)
    check_s = time.perf_counter() - t_check
    log(f"check took {check_s:.1f} s")
    checks = {}
    for key, lim in cell.limits.get("limits", {}).items():
        checks[key] = (numbers[f"control_{key}" if control else key], lim["limit"])
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    if not checks:
        correct = False
        log("no limit is set for this cell: not judged correct")
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1 if dev.type == "cuda" else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return {"result": result, "checks": checks, "numbers": numbers,
            "window_s": w["t1"] - w["t0"], "setup_s": setup_s, "check_s": check_s}


def cache_dirs(root: Path) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = Path(root) / "build" / "portbench" / "cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "CUDA_CACHE_PATH": str(base / "nv")}


def set_cache_dirs(root: Path):
    for k, v in cache_dirs(root).items():
        os.environ[k] = v

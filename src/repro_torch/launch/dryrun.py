"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake world.

The counterpart of the JAX package's `repro/launch/dryrun.py`.  Each cell's
step (`train/steps.py`) runs once on DTensor stand-ins of its inputs
(`launch/specs.py`, local shards on the `meta` device: no memory, no
device work) over the production mesh (16 x 16 or 2 x 16 x 16) of a fake
process group, under `implicit_replication()` (plain tensors made inside the step count as
replicated), the cell's axis rules (so the models' `constrain` calls lay
out the activations) and `op_cost.analyze`, which counts each rank's local
FLOPs and bytes, the collectives' wire bytes and the peak of live bytes.
The step runs twice, the first pass's count dropped (it fills DTensor's
caches of each op's sharding and metadata, whose ops would otherwise be
counted).
`use_pallas` stays False, as the reference's dry run leaves it.  The host
does all of it; no card is used.  Every number is a prediction for a
cluster of H100s (`launch/roofline.py`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]

The JSON has the reference's keys.  `lower_s` is the time to build the
inputs and `compile_s` the time of the traced step; `memory.temp_bytes` is
the peak of the bytes the step's ops hold alive (eager execution reuses no
buffers the way XLA's allocator does); there is no generated code and no
XLA cost analysis.  A cell that fails writes `<tag>.err` and the run goes
on; the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import SHAPES, runnable_cells
from repro_torch.distributed.sharding import AxisRules, use_axis_rules
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HW, CollectiveStats, roofline
from repro_torch.launch.specs import input_specs
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch
    tokens per step; fwd-only shapes use 2·N·D."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


def local_bytes(tree) -> int:
    """Bytes of one rank's shards of the tensors in `tree`."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def _step_call(spec):
    """A no-argument call of the cell's step on its abstract args.  The
    scalars (`step`, `pos_t`) go in as Python ints: the train step at step
    0, the decode step at the cache's last position."""
    cfg = spec.cfg
    if spec.kind == "train":
        params, opt, batch, _ = spec.args
        fn = make_train_step(cfg, adamw.Hyper())
        return lambda: fn(params, opt, batch, 0)
    if spec.kind == "prefill":
        fn = make_prefill_step(cfg)
        return lambda: fn(*spec.args)
    params, caches, tokens, _ = spec.args
    fn = make_serve_step(cfg)
    return lambda: fn(params, caches, tokens, spec.cell.seq_len - 1)


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, mesh=None,
             cfg=None) -> dict:
    """Trace one cell; `mesh` defaults to the production mesh (built over a
    fake world of its size)."""
    t0 = time.time()
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    spec = input_specs(arch, shape, mesh, cfg=cfg)
    cfg = spec.cfg
    call = _step_call(spec)
    t_lower = time.time() - t0

    out = []
    with implicit_replication(), use_axis_rules(AxisRules(spec.rules, mesh)):
        # DTensor works out each new op's sharding and output metadata the
        # first time it meets it, running ops of its own (some torch
        # versions on meta tensors the counter cannot tell from the step's):
        # a first pass, whose count is dropped, fills those caches
        op_cost.analyze(call)
        cost = op_cost.analyze(lambda: out.append(call()))
    t_compile = time.time() - t0 - t_lower

    arg_b, out_b = local_bytes(spec.args), local_bytes(out)
    coll = CollectiveStats(
        per_device_wire_bytes=cost.coll_wire, by_kind=cost.coll_by_kind,
        count=int(sum(v["count"] for v in cost.coll_by_kind.values())))
    roof = roofline({"flops": cost.flops, "bytes accessed": cost.bytes}, coll,
                    n_chips, model_flops(cfg, spec.cell))
    return {
        "arch": arch,
        "shape": shape,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "n_chips": n_chips,
        "kind": spec.kind,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": int(cost.peak_bytes),
            "generated_code_bytes": None,
            "fits_80gb": arg_b + cost.peak_bytes <= HW["hbm_bytes"],
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "roofline": roof,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("pass --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    print(f"torch {torch.__version__}", flush=True)

    n_ok = n_fail = 0
    for mp in meshes:           # one fake world per mesh size
        mesh = make_production_mesh(multi_pod=mp)
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                n_ok += 1
                continue
            try:
                res = run_cell(arch, shape, multi_pod=mp, mesh=mesh)
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                r, m = res["roofline"], res["memory"]
                print(f"[ ok ] {tag}: trace={res['compile_s']}s "
                      f"dominant={r['dominant']} "
                      f"compute={r['compute_term_s']:.4f}s "
                      f"memory={r['memory_term_s']:.4f}s "
                      f"coll={r['collective_term_s']:.4f}s "
                      f"useful={r.get('useful_flops_ratio', 0):.3f} "
                      f"arg={m['argument_bytes'] / 1e9:.3f}GB "
                      f"temp={m['temp_bytes'] / 1e9:.3f}GB", flush=True)
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — one cell's failure is recorded
                n_fail += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}", flush=True)
                with open(os.path.join(args.out, tag + ".err"), "w") as f:
                    f.write(traceback.format_exc())
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

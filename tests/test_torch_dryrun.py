"""The port's dry run against the JAX package's.

- `run_cell` on reduced qwen2-1.5b and falcon-mamba-7b, for a train, a
  prefill and a decode cell (short sequences, so that the traced loops
  stay small), on a 2 x 2 fake world: it completes and writes the
  reference's JSON keys;
- for every runnable full-width cell at 16 x 16 and 2 x 16 x 16, the
  per-device argument bytes of the port's `input_specs` equal the shard
  bytes of the reference's `input_specs` (its own rules, dtypes and
  specs; its stand-ins are read as (shape, dtype, spec) instead of placed
  on 512 host devices).  qwen2-1.5b's `prefill_32k` gives 964,810,752,
  which is the reference's XLA `argument_bytes`;
- `model_flops` is equal in both packages for every runnable cell;
- at world 1 a prefill's traced FLOPs equal those of the plain, unsharded
  step on meta tensors.

Each fake world is torn down after its test, so no later test in the
worker meets a default process group.
"""
import contextlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import (destroy_fake_world, init_fake_world,  # noqa: E402
                                     make_mesh, make_production_mesh)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map_desc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"tiny_train": tbase.ShapeCell("tiny_train", 32, 4, "train"),
        "tiny_prefill": tbase.ShapeCell("tiny_prefill", 32, 4, "prefill"),
        "tiny_decode": tbase.ShapeCell("tiny_decode", 32, 4, "decode")}


@contextlib.contextmanager
def fake_world(n: int):
    init_fake_world(n)
    try:
        yield
    finally:
        destroy_fake_world()


@pytest.fixture
def tiny_shapes(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(tbase.SHAPES, k, v)


def _ref_keys():
    from repro.launch.hlo_analysis import CollectiveStats, roofline
    top = {"arch", "shape", "mesh", "n_chips", "kind", "lower_s", "compile_s",
           "memory", "params", "active_params", "roofline"}
    mem = {"argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes"}
    roof = set(roofline({"flops": 1.0, "bytes accessed": 1.0}, CollectiveStats(), 4, 1.0))
    return top, mem, roof


@pytest.mark.parametrize("shape", list(TINY))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "falcon-mamba-7b"])
def test_run_cell_reduced(arch, shape, tiny_shapes):
    cfg = treg.reduced(treg.get_config(arch))
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        res = dryrun.run_cell(arch, shape, mesh=mesh, cfg=cfg)
    top, mem, roof = _ref_keys()
    assert top <= set(res) and mem <= set(res["memory"]) and roof <= set(res["roofline"])
    json.dumps(res)
    assert res["n_chips"] == 4 and res["mesh"] == "2x2" and res["kind"] == TINY[shape].kind
    r, m = res["roofline"], res["memory"]
    assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["bound_time_s"] == max(r["compute_term_s"], r["memory_term_s"],
                                    r["collective_term_s"])
    assert m["argument_bytes"] > 0 and m["output_bytes"] > 0 and m["temp_bytes"] > 0
    if TINY[shape].kind == "train":
        # the gradients' reductions over the data axis
        assert r["collective_bytes_per_device"] > 0


def _ref_arg_bytes(arch, shape, names, sizes, monkeypatch):
    """The shard bytes of the reference's `input_specs(...).args`."""
    from repro.launch import specs as rspecs
    monkeypatch.setattr(rspecs, "_sds", lambda shape, dtype, mesh, spec: (shape, dtype, spec))
    mesh = type("M", (), {"axis_names": names,
                          "devices": type("D", (), {"shape": sizes})()})()
    ms = dict(zip(names, sizes))
    import jax
    leaves = jax.tree_util.tree_leaves(rspecs.input_specs(arch, shape, mesh).args,
                                       is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
                                       and isinstance(x[0], tuple))
    total = 0
    for shp, dtype, spec in leaves:
        n = math.prod(shp) * np.dtype(dtype).itemsize
        for part in spec:
            for nm in ((part,) if isinstance(part, str) else (part or ())):
                n //= ms[nm]
        total += n
    return total


@pytest.mark.parametrize("arch, shape", tbase.runnable_cells())
def test_argument_bytes_match_the_reference(arch, shape, monkeypatch):
    for multi_pod, names, sizes in ((False, ("data", "model"), (16, 16)),
                                    (True, ("pod", "data", "model"), (2, 16, 16))):
        want = _ref_arg_bytes(arch, shape, names, sizes, monkeypatch)
        with fake_world(math.prod(sizes)):
            mesh = make_production_mesh(multi_pod=multi_pod)
            spec = tspecs.input_specs(arch, shape, mesh)
            got = dryrun.local_bytes(spec.args)
            for t in tree_leaves(spec.args):
                assert t.to_local().device.type == "meta"
        assert got == want, (multi_pod, got, want)
        if (arch, shape, multi_pod) == ("qwen2-1.5b", "prefill_32k", False):
            assert got == 964_810_752


_REF_FLOPS = """
import json
from repro.configs.base import SHAPES, runnable_cells
from repro.configs import registry
from repro.launch.dryrun import model_flops
print(json.dumps({f"{a}/{s}": model_flops(registry.get_config(a), SHAPES[s])
                  for a, s in runnable_cells()}))
"""


def test_model_flops_equal():
    # in a process of its own: the reference's dry-run module asks JAX for
    # 512 host devices when it is imported
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_FLOPS], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {f"{a}/{s}": dryrun.model_flops(treg.get_config(a), tbase.SHAPES[s])
           for a, s in tbase.runnable_cells()}
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "falcon-mamba-7b"])
def test_world_one_prefill_flops_equal_the_plain_step(arch, tiny_shapes):
    cfg = treg.reduced(treg.get_config(arch))
    cell = TINY["tiny_prefill"]
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        res = dryrun.run_cell(arch, "tiny_prefill", mesh=mesh, cfg=cfg)
    params = tree_map_desc(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"),
                           TT.build_descriptors(cfg))
    tokens = torch.empty((cell.global_batch, cell.seq_len), dtype=torch.int32, device="meta")
    plain = op_cost.analyze(lambda: TT.prefill(cfg, params, tokens))
    assert res["roofline"]["hlo_flops_per_device"] == plain.flops
    assert res["roofline"]["collective_bytes_per_device"] == 0


def test_gradient_layout_cuts_the_train_step_wire_bytes(tiny_shapes):
    """The dry run's train step lays each gradient out as its optimizer
    state is (the reference's `grad_shardings`): the weight-gradient
    reductions are reduce-scatters into that layout, fewer bytes on the
    wire than the same step with `grad_placements` naming the parameters'
    layout (gradients all-reduced over the batch shards)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import AxisRules, use_axis_rules
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    cfg = treg.reduced(treg.get_config("qwen2-1.5b"))
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        base = dryrun.run_cell("qwen2-1.5b", "tiny_train", mesh=mesh, cfg=cfg)
        spec = tspecs.input_specs("qwen2-1.5b", "tiny_train", mesh, cfg=cfg)
        params, opt, batch, _ = spec.args
        step = make_train_step(cfg, adamw.Hyper(), grad_placements=tree_map(
            lambda t: list(t.placements), params))
        with implicit_replication(), use_axis_rules(AxisRules(spec.rules, mesh)):
            op_cost.analyze(lambda: step(params, opt, batch, 0))
            whole = op_cost.analyze(lambda: step(params, opt, batch, 0))
    assert base["roofline"]["collective_bytes_per_device"] < whole.coll_wire
    assert base["memory"]["argument_bytes"] == dryrun.local_bytes(spec.args)


def test_local_mesh_and_fake_world():
    from repro_torch.launch.mesh import make_local_mesh
    with fake_world(1):
        mesh = make_local_mesh("cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        init_fake_world(1)          # the same fake world: kept
    assert not torch.distributed.is_initialized()


def test_roofline_table_against_another_run(tmp_path):
    """`benchmarks.roofline --against DIR` puts each cell beside the other
    run's: the count ratios, both memory and collective terms, and the
    other's dominant term and fit worked out from its counts against the
    H100 figures (its own "dominant", made with another chip's figures, is
    not read)."""
    from repro_torch.benchmarks import roofline as troof

    def cell(flops, nbytes, wire, temp, dominant):
        return {"arch": "qwen2-1.5b", "shape": "prefill_32k", "mesh": "16x16", "n_chips": 256,
                "memory": {"argument_bytes": 1e9, "temp_bytes": temp},
                "roofline": {"hlo_flops_per_device": flops, "hlo_bytes_per_device": nbytes,
                             "collective_bytes_per_device": wire, "dominant": dominant}}

    for d, rec in (("port", cell(2e12, 6.7e12, 1e9, 90e9, "memory")),
                   ("other", cell(1e12, 3.35e12, 1e11, 9e9, "compute"))):
        (tmp_path / d).mkdir()
        (tmp_path / d / "qwen2-1.5b__prefill_32k__16x16.json").write_text(json.dumps(rec))
    lines = troof.against(str(tmp_path / "port"), str(tmp_path / "other"))
    assert len(lines) == 3
    assert lines[2] == ("| qwen2-1.5b | prefill_32k | 16x16 | 2.000 | 2.000 | 10.000 | 0.010 "
                        "| 90.00 / 9.00 | 2 / 1 | 0.02 / 2 | memory / collective | no / yes |")
    assert troof.main(["--dir", str(tmp_path / "port"), "--against", str(tmp_path / "other")]) == 0

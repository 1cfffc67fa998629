"""The port's sharded step against its unsharded step, and its structure.

Numeric cases run in a real 4-rank gloo world on the CPU
(`test_torch_tooling._gloo4`), all in one launch: each rank draws the same
numpy-seeded weights and tokens, runs the plain port, then the same step on
DTensors laid out by the dry run's rules (`launch/specs.axis_rules_for`) on
a ("data", "model") mesh, and compares the gathered results at f32 1e-5:

- qwen2 with 6 q heads and 2 kv heads on 1 x 4 (heads do not divide
  "model"): prefill logits and caches (query rows split, the causal
  zigzag), a train step's loss and gradients (the zigzag's all-to-all
  under autograd), one decode step on the T-sharded cache (split-T);
- reduced gemma3-27b cut to one local and one global layer, with 6 / 2
  heads and a window of 16 at a 24-token prompt: the windowed and the
  causal row split, then decode over the ring and the T-sharded global
  cache;
- reduced granite-moe-3b-a800m on 2 x 2 with 8 experts (the experts dim
  takes "data": an all-to-all to and from the batch-local dispatch) and
  with 5 (the buffer stays batch-sharded): prefill and decode;
- reduced falcon-mamba-7b on 1 x 4: in_proj's two halves without the
  product's gather, prefill and decode;
- reduced whisper-large-v3 with 6 heads on 1 x 4: the encoder's
  bidirectional rows over its 8 frames, the decoder's causal rows and
  its cross-attention's rows over the encoder's keys, then decode; and
  with 10 frames, which 4 does not divide (the rows padded to 12, the
  padded keys cut off): prefill, a train step and decode;
- stablelm-12b shaped, 8 q and 2 kv heads on 1 x 4 (the q heads divide
  "model", the kv heads do not): each rank projects only the kv head its
  q heads read; prefill (the cache's rows traded from those heads), a
  train step and decode, and a 30-token prefill, whose rows 4 does not
  divide (the cache whole, projected again); reduced gemma3-27b with the
  same heads and a
  window of 16 (the ring's k and v from the last 16 positions), prefill
  and decode; reduced recurrentgemma-9b (4 q heads, 1 kv head: read
  through a view), window 16, prefill and decode;
- reduced deepseek-v2-236b on 1 x 4: MLA's down projections on each
  rank's own rows, the latents gathered; prefill and a train step; and
  the absorbed decode over the T-sharded latent cache (split-T);
- qwen2 with 8 q heads and 2 kv heads on 1 x 4 (the q heads divide
  "model"): one decode step, each block output reduced at the residual
  add;
- qwen2 with a vocab of 500, padded to 512, on 1 x 4 and on 2 x 2: a
  train step whose loss runs in two chunks, each chunk's log-sum-exp and
  label pick on each rank's own vocab columns, the padded columns on the
  last "model" shard;
- reduced granite-moe-3b-a800m (8 experts) and deepseek-v2-236b on 2 x 2:
  a train step, the router on each rank's own batch rows; deepseek's
  shared experts pass their gradient of the norm's output back beside the
  routed experts'.

The same world holds `op_cost`'s live-byte count (the dry run's temp
bytes) against real per-rank allocations: each rank runs five sharded
steps on real DTensors under the CPU allocator's profiler (reduced
deepseek-v2-236b's train step, MLA and MoE in `per_shard`; qwen2's train
step, DTensor ops and row-split attention, and with a 500-token vocab, the
loss in two vocab-sharded chunks; falcon-mamba's prefill, its scan in
`per_shard`; granite's prefill on 2 x 2 with 8 experts, whose all-to-all
gloo runs as an all-gather and a chunk), the least peak of
three runs after a first one; a second launch of 4 processes, each a rank
of a fake world, counts the same steps on meta DTensors of the same
layouts, as gloo runs them (without `op_cost.alltoall_as_on_a_card`); the
count is within 5% of the peak on every rank.

Fake-world cases (`init_fake_world`, meta shards) check the structure by
`perf_debug`'s call sites and `op_cost`'s counts.
"""
import contextlib
import dataclasses
import json
import re

import pytest

torch = pytest.importorskip("torch")

from test_torch_tooling import _gloo4  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import dryrun, op_cost, perf_debug  # noqa: E402
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world, make_mesh  # noqa: E402

CASES = ["qwen2_prefill", "qwen2_train", "qwen2_decode", "gemma3_prefill", "gemma3_decode",
         "granite_e8_prefill", "granite_e8_decode", "granite_e5_prefill", "granite_e5_decode",
         "mamba_prefill", "mamba_decode", "mamba_train", "whisper_prefill", "whisper_decode",
         "whisper10_prefill", "whisper10_train", "whisper10_decode",
         "stablelm_prefill", "stablelm_train", "stablelm_decode", "stablelm_prefill_30",
         "gemma3_kv2_prefill", "gemma3_kv2_decode", "rgemma_prefill", "rgemma_decode",
         "rgemma_train", "deepseek_prefill", "deepseek_train", "deepseek_decode",
         "qwen2_h8_decode", "qwen2_step", "qwen2_v500_train", "qwen2_v500_train_2x2",
         "granite_e8_train", "deepseek_train_2x2"]
MEMORY_CASES = ["deepseek_train", "qwen2_train", "mamba_prefill", "granite_e8_prefill",
                "qwen2_v500_train"]

_COMMON = r'''
import dataclasses, json, pickle, sys, time, traceback
from datetime import timedelta
from types import SimpleNamespace
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.elastic import reshard_tree
from repro_torch.distributed.sharding import AxisRules, use_axis_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import axis_rules_for
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamDesc, tree_leaves, tree_map, tree_map_desc
from repro_torch.serve import grow_caches
sys.path.insert(0, "tests")
from test_torch_memory import cpu_peak

rank = int(sys.argv[1])
TOL = dict(rtol=1e-5, atol=1e-5)


def cfg_of(arch, **over):
    cfg = registry.reduced(registry.get_config(arch))
    return dataclasses.replace(cfg, **over)


def windows(cfg, w):
    return dataclasses.replace(cfg, blocks=tuple(
        (tuple(dataclasses.replace(s, window=w) if s.window else s for s in pat), n)
        for pat, n in cfg.blocks))


def draw(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def one(d: ParamDesc):
        if d.init in ("ones", "zeros"):
            return torch.full(d.shape, float(d.init == "ones"))
        scale = 0.5 / np.sqrt(max(1, int(np.prod(d.shape[:-1]))))
        return torch.from_numpy((rng.standard_normal(d.shape) * scale).astype(np.float32))

    return tree_map_desc(one, T.build_descriptors(cfg))


def world(cfg, mesh_shape, shape):
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    rules = axis_rules_for(cfg, SHAPES[shape], mesh)
    return mesh, rules, AxisRules(rules, mesh)


def dist_tree(tree, descs, mesh, rules):
    return reshard_tree(tree, descs, mesh, rules)


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def close(got, want):
    got, want = tree_leaves(tree_map(full, got)), tree_leaves(want)
    assert len(got) == len(want)
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
        if g.is_floating_point():
            err = max(err, (g - w).abs().max().item())
    return err


def tokens(cfg, B, S, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
                            .astype(np.int32))


def batch_spec_dt(t, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.specs import _batch_spec
    from repro_torch.models.params import placements
    return distribute_tensor(t, mesh, placements(_batch_spec(mesh, t.shape[0]), mesh))


def frames(cfg, B):
    if not cfg.enc_dec:
        return None
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.standard_normal((B, cfg.enc_frames, cfg.d_model))
                            .astype(np.float32))


def prefill_case(cfg, mesh_shape, B, S):
    params = draw(cfg)
    tok, feats = tokens(cfg, B, S), frames(cfg, B)
    with torch.no_grad():
        want = T.prefill(cfg, params, tok, feats)
    mesh, rules, ar = world(cfg, mesh_shape, "prefill_32k")
    dp = dist_tree(params, T.build_descriptors(cfg), mesh, rules)
    with torch.no_grad(), implicit_replication(), use_axis_rules(ar):
        got = T.prefill(cfg, dp, batch_spec_dt(tok, mesh),
                        None if feats is None else batch_spec_dt(feats, mesh))
    return close(got, want)


def decode_case(cfg, mesh_shape, B, S, Tlen):
    params = draw(cfg)
    tok = tokens(cfg, B, S)
    nxt = tokens(cfg, B, 1, seed=2)
    with torch.no_grad():
        _, caches = T.prefill(cfg, params, tok, frames(cfg, B))
        caches = grow_caches(caches, S, Tlen)
        start = tree_map(torch.clone, caches)
        want = T.decode_step(cfg, params, caches, nxt, S)
    mesh, rules, ar = world(cfg, mesh_shape, "decode_32k")
    dp = dist_tree(params, T.build_descriptors(cfg), mesh, rules)
    dc = dist_tree(start, T.build_cache_descriptors(cfg, B, Tlen), mesh, rules)
    with torch.no_grad(), implicit_replication(), use_axis_rules(ar):
        got = T.decode_step(cfg, dp, dc, batch_spec_dt(nxt, mesh), S)
    return close(got, want)


def train_case(cfg, mesh_shape, B, S):
    params = draw(cfg)
    batch = {"tokens": tokens(cfg, B, S), "labels": tokens(cfg, B, S, seed=3)}
    if cfg.enc_dec:
        batch["enc_feats"] = frames(cfg, B)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = T.forward_train(cfg, params, batch)
    loss.backward()
    mesh, rules, ar = world(cfg, mesh_shape, "train_4k")
    dp = dist_tree(tree_map(lambda t: t.detach(), params), T.build_descriptors(cfg), mesh, rules)
    dleaves = tree_leaves(dp)
    for t in dleaves:
        t.requires_grad_(True)
    with implicit_replication(), use_axis_rules(ar):
        dloss, _ = T.forward_train(cfg, dp, {k: batch_spec_dt(v, mesh) for k, v in batch.items()})
        dloss.backward()
    return close([dloss] + [t.grad for t in dleaves], [loss] + [t.grad for t in leaves])


def step_case(cfg, mesh_shape, B, S, steps=2):
    """`make_train_step`'s losses and grad norms over `steps` steps, then
    the parameters and moments, on DTensors under the rules (the moments
    laid out as the dry run lays them, `launch/specs.opt_specs`, and the
    gradients by default as the moments) against the plain step."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.specs import opt_specs
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    step = make_train_step(cfg, adamw.Hyper())
    params = draw(cfg)
    batch = {"tokens": tokens(cfg, B, S), "labels": tokens(cfg, B, S, seed=3)}
    mesh, rules, ar = world(cfg, mesh_shape, "train_4k")
    dp = dist_tree(tree_map(torch.clone, params), T.build_descriptors(cfg), mesh, rules)
    dopt = tree_map(lambda s: distribute_tensor(torch.zeros(s.shape), mesh, s.placements),
                    opt_specs(cfg, mesh, rules))
    opt = adamw.init(params)
    want, got = [], []
    for i in range(steps):
        params, opt, m = step(params, opt, batch, i)
        want += [m["loss"], m["grad_norm"]]
    with implicit_replication(), use_axis_rules(ar):
        db = {k: batch_spec_dt(v, mesh) for k, v in batch.items()}
        for i in range(steps):
            dp, dopt, m = step(dp, dopt, db, i)
            got += [m["loss"], m["grad_norm"]]
    return close(got + [dp, dopt], want + [params, opt])


qwen2 = cfg_of("qwen2-1.5b", n_heads=6, n_kv_heads=2)
gemma3 = cfg_of("gemma3-27b", n_heads=6, n_kv_heads=2)
gemma3 = windows(dataclasses.replace(gemma3, blocks=((gemma3.blocks[0][0][-2:], 1),)), 16)
granite = cfg_of("granite-moe-3b-a800m")
granite5 = dataclasses.replace(granite, moe=dataclasses.replace(granite.moe, n_experts=5))
mamba = cfg_of("falcon-mamba-7b")
whisper = cfg_of("whisper-large-v3", n_heads=6, n_kv_heads=6)
whisper10 = dataclasses.replace(whisper, enc_frames=10)
stablelm = cfg_of("stablelm-12b", n_heads=8, n_kv_heads=2)
gemma3_kv2 = windows(dataclasses.replace(
    cfg_of("gemma3-27b", n_heads=8, n_kv_heads=2), blocks=gemma3.blocks), 16)
rgemma = windows(cfg_of("recurrentgemma-9b"), 16)
deepseek = cfg_of("deepseek-v2-236b")
qwen2_h8 = cfg_of("qwen2-1.5b", n_heads=8, n_kv_heads=2)
# 500 tokens padded to 512: the last "model" shard of the vocab holds the
# 12 padded columns; the 32-token loss in two chunks
qwen2_v500 = dataclasses.replace(qwen2, vocab=500, loss_chunk=16)
CASES = {
    "qwen2_prefill": lambda: prefill_case(qwen2, (1, 4), 2, 32),
    "qwen2_train": lambda: train_case(qwen2, (1, 4), 2, 32),
    "qwen2_decode": lambda: decode_case(qwen2, (1, 4), 2, 32, 40),
    "gemma3_prefill": lambda: prefill_case(gemma3, (1, 4), 2, 24),
    "gemma3_decode": lambda: decode_case(gemma3, (1, 4), 2, 24, 32),
    "granite_e8_prefill": lambda: prefill_case(granite, (2, 2), 4, 16),
    "granite_e8_decode": lambda: decode_case(granite, (2, 2), 4, 16, 20),
    "granite_e5_prefill": lambda: prefill_case(granite5, (2, 2), 4, 16),
    "granite_e5_decode": lambda: decode_case(granite5, (2, 2), 4, 16, 20),
    "mamba_prefill": lambda: prefill_case(mamba, (1, 4), 2, 32),
    "mamba_decode": lambda: decode_case(mamba, (1, 4), 2, 32, 40),
    "mamba_train": lambda: train_case(mamba, (1, 4), 2, 32),
    "whisper_prefill": lambda: prefill_case(whisper, (1, 4), 2, 16),
    "whisper_decode": lambda: decode_case(whisper, (1, 4), 2, 16, 20),
    "whisper10_prefill": lambda: prefill_case(whisper10, (1, 4), 2, 16),
    "whisper10_train": lambda: train_case(whisper10, (1, 4), 2, 16),
    "whisper10_decode": lambda: decode_case(whisper10, (1, 4), 2, 16, 20),
    "stablelm_prefill": lambda: prefill_case(stablelm, (1, 4), 2, 32),
    "stablelm_train": lambda: train_case(stablelm, (1, 4), 2, 32),
    "stablelm_decode": lambda: decode_case(stablelm, (1, 4), 2, 32, 40),
    "stablelm_prefill_30": lambda: prefill_case(stablelm, (1, 4), 2, 30),
    "gemma3_kv2_prefill": lambda: prefill_case(gemma3_kv2, (1, 4), 2, 24),
    "gemma3_kv2_decode": lambda: decode_case(gemma3_kv2, (1, 4), 2, 24, 32),
    "rgemma_prefill": lambda: prefill_case(rgemma, (1, 4), 2, 24),
    "rgemma_decode": lambda: decode_case(rgemma, (1, 4), 2, 24, 32),
    "rgemma_train": lambda: train_case(rgemma, (1, 4), 2, 24),
    "deepseek_prefill": lambda: prefill_case(deepseek, (1, 4), 2, 32),
    "deepseek_train": lambda: train_case(deepseek, (1, 4), 2, 32),
    "deepseek_decode": lambda: decode_case(deepseek, (1, 4), 2, 32, 40),
    "qwen2_h8_decode": lambda: decode_case(qwen2_h8, (1, 4), 2, 32, 40),
    "qwen2_step": lambda: step_case(qwen2, (2, 2), 4, 32),
    "qwen2_v500_train": lambda: train_case(qwen2_v500, (1, 4), 2, 32),
    "qwen2_v500_train_2x2": lambda: train_case(qwen2_v500, (2, 2), 2, 32),
    "granite_e8_train": lambda: train_case(granite, (2, 2), 4, 16),
    "deepseek_train_2x2": lambda: train_case(deepseek, (2, 2), 2, 32),
}
# memory: each rank's allocator peak over a sharded step on CPU DTensors in
# the gloo world, and op_cost's count of the same step on meta DTensors of the
# same layouts, in a fake world at the same rank, in a process of its own
# (DTensor caches each redistribution's plan, meshes in it, by an equal mesh)
def train_step(cfg, params, batch):
    loss, _ = T.forward_train(cfg, params, batch)
    loss.backward()


def prefill_step(cfg, params, tok):
    with torch.no_grad():
        T.prefill(cfg, params, tok)


STEPS = {"train_4k": train_step, "prefill_32k": prefill_step}


def run_step(cfg, ar, shape, args):
    """The step once, as the dry run's first pass (it fills DTensor's
    caches), and -> the step again, each run from no gradients."""
    leaves = [t for t in tree_leaves(args[0]) if t.requires_grad]

    def one():
        for t in leaves:
            t.grad = None
        with implicit_replication(), use_axis_rules(ar):
            STEPS[shape](cfg, *args)
    one()
    return one


def memory_case(cfg, mesh_shape, shape, B, S):
    mesh, rules, ar = world(cfg, mesh_shape, shape)
    dp = dist_tree(draw(cfg), T.build_descriptors(cfg), mesh, rules)
    tok = batch_spec_dt(tokens(cfg, B, S), mesh)
    if shape == "train_4k":
        for t in tree_leaves(dp):
            t.requires_grad_(True)
        args = (dp, {"tokens": tok, "labels": batch_spec_dt(tokens(cfg, B, S, seed=3), mesh)})
    else:
        args = (dp, tok)
    layout = tree_map(lambda t: SimpleNamespace(
        local=t.to_local().shape, dtype=t.dtype, placements=t.placements, shape=t.shape,
        stride=t.stride(), requires_grad=t.requires_grad), args)
    # the least of three runs: a collective's buffer that gloo frees on its
    # own thread is sometimes still held at the peak
    one = run_step(cfg, ar, shape, args)
    return min(cpu_peak(one) for _ in range(3)), layout


def counted(cfg, mesh_shape, shape, layout):
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import op_cost
    mesh, _, ar = world(cfg, mesh_shape, shape)

    def meta(t):
        m = DTensor.from_local(torch.empty(t.local, dtype=t.dtype, device="meta"), mesh,
                               t.placements, run_check=False, shape=t.shape, stride=t.stride)
        return m.requires_grad_(t.requires_grad)

    one = run_step(cfg, ar, shape, tree_map(meta, layout))
    # gloo's "cpu" mesh runs DTensor's all-to-all as an all-gather and a
    # chunk: counted so too, without `op_cost.alltoall_as_on_a_card`
    counter = op_cost._OpCounter()
    with counter:
        one()
    return counter.cost.peak_bytes


MEMORY = {
    "deepseek_train": (deepseek, (1, 4), "train_4k", 2, 32),
    "qwen2_train": (qwen2, (1, 4), "train_4k", 2, 32),
    "mamba_prefill": (mamba, (1, 4), "prefill_32k", 2, 32),
    "granite_e8_prefill": (granite, (2, 2), "prefill_32k", 4, 16),
    "qwen2_v500_train": (qwen2_v500, (1, 4), "train_4k", 2, 32),
}
'''
_WORLD = _COMMON + r'''
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[2], 4), rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
for name, case in CASES.items():
    t0 = time.time()
    try:
        err = case()
        print("CASE", name, json.dumps({"ok": True, "err": err, "s": time.time() - t0}),
              flush=True)
    except Exception as e:
        traceback.print_exc()
        print("CASE", name, json.dumps({"ok": False, "why": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
layouts = {}
for name, (cfg, mesh_shape, shape, B, S) in MEMORY.items():
    try:
        layouts[name] = memory_case(cfg, mesh_shape, shape, B, S)
    except Exception as e:
        traceback.print_exc()
        print("CASE", "mem_" + name, json.dumps({"ok": False, "why": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
with open(f"{sys.argv[2]}.layouts{rank}", "wb") as f:
    pickle.dump(layouts, f)
dist.destroy_process_group()
'''
_COUNTS = _COMMON + r'''
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
with open(f"{sys.argv[2]}.layouts{rank}", "rb") as f:
    layouts = pickle.load(f)
for name, (peak, layout) in layouts.items():
    cfg, mesh_shape, shape, _, _ = MEMORY[name]
    try:
        c = counted(cfg, mesh_shape, shape, layout)
        print("CASE", "mem_" + name, json.dumps({"ok": True, "peak": peak, "counted": c,
                                                  "ratio": c / peak}), flush=True)
    except Exception as e:
        traceback.print_exc()
        print("CASE", "mem_" + name, json.dumps({"ok": False, "why": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """Every case's result on each of the 4 ranks, from one launch, and the
    memory cases' counts from a second launch of 4 fake-world ranks."""
    tmp = tmp_path_factory.mktemp("gloo")
    outs = _gloo4(_WORLD, tmp, timeout=240)
    outs = [(o + co, e + ce) for (o, e), (co, ce) in zip(outs, _gloo4(_COUNTS, tmp, timeout=240))]
    results = []
    for out, err in outs:
        got = {m.group(1): json.loads(m.group(2))
               for m in re.finditer(r"^CASE (\S+) (.*)$", out, re.M)}
        results.append((got, err))
    return results


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_the_plain_port(case, gloo_world):
    for rank, (got, err) in enumerate(gloo_world):
        assert case in got, f"rank {rank} did not finish {case}: {err[-3000:]}"
        assert got[case]["ok"], (rank, got[case], err[-3000:])


@pytest.mark.parametrize("case", MEMORY_CASES)
def test_sharded_step_count_matches_each_ranks_allocator(case, gloo_world):
    """`op_cost`'s live-byte count of a rank's step on meta DTensors (a
    fake world at that rank) within 5% of the CPU allocator's peak while
    the same rank ran the step on real DTensors in the gloo world."""
    for rank, (got, err) in enumerate(gloo_world):
        r = got.get("mem_" + case)
        assert r is not None, f"rank {rank} did not finish {case}: {err[-3000:]}"
        assert r["ok"], (rank, r, err[-3000:])
        assert r["counted"] == pytest.approx(r["peak"], rel=0.05), (rank, r)


# ---------------------------------------------------------------------------
# structure, on a fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    init_fake_world(n)
    try:
        yield
    finally:
        destroy_fake_world()


@pytest.fixture
def shapes(monkeypatch):
    cells = {"s_prefill": tbase.ShapeCell("s_prefill", 64, 4, "prefill"),
             "s_decode": tbase.ShapeCell("s_decode", 256, 8, "decode")}
    for k, v in cells.items():
        monkeypatch.setitem(tbase.SHAPES, k, v)
    return cells


def _qwen2(**over):
    return dataclasses.replace(treg.reduced(treg.get_config("qwen2-1.5b")),
                               n_heads=6, n_kv_heads=2, **over)


def _cell(cfg, shape, mesh_shape, arch="qwen2-1.5b"):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import AxisRules, use_axis_rules
    from repro_torch.launch.specs import input_specs

    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    spec = input_specs(arch, shape, mesh, cfg=cfg)
    call = dryrun._step_call(spec)
    return call, (implicit_replication, lambda: use_axis_rules(AxisRules(spec.rules, mesh)))


def _run(call, ctx, fn):
    """fn(call) under the cell's rules, after a first pass that fills
    DTensor's caches (as `run_cell` does)."""
    with ctx[0](), ctx[1]():
        call()
        return fn(call)


def test_decode_gathers_no_expanded_cache(shapes):
    """A decode step of 6-head qwen2 on 1 x 4 sends only the split-T
    merge's partials over the model axis: every collective at an attention
    call site is an all-gather smaller than one rank's slice of the
    unexpanded k cache, let alone the expanded cache."""
    cfg = _qwen2()
    with fake_world(4):
        call, ctx = _cell(cfg, "s_decode", (1, 4))
        coll, _ = _run(call, ctx, perf_debug.attribute)
    k_slice = 8 * 256 // 4 * cfg.n_kv_heads * cfg.head_dim * 4      # (B, T / 4, Hkv, D) f32
    attn = [r for r in coll if "models/attention.py" in r[4]]
    assert attn and all(r[3] == "all-gather" and r[2] < k_slice / 4 for r in attn), (attn, k_slice)


class _FlopsBySite(op_cost._OpCounter):
    """The counter, also summing FLOPs by `perf_debug`'s call site."""

    def __init__(self):
        super().__init__()
        self.sites: dict = {}

    def record(self, func, args, kwargs, out, cost):
        before = cost.flops
        super().record(func, args, kwargs, out, cost)
        if cost is self.cost and cost.flops > before:
            site = perf_debug._call_site()
            self.sites[site] = self.sites.get(site, 0.0) + cost.flops - before


def _core_flops(call, ctx) -> float:
    """FLOPs of one traced step inside the attention cores: the functions
    that `models/attention.py` defines above its layer (`attn_descs`)."""
    import inspect

    from repro_torch.models import attention
    first = inspect.getsourcelines(attention.attn_descs)[1]
    counter = _FlopsBySite()
    with ctx[0](), ctx[1]():
        call()
        with op_cost.alltoall_as_on_a_card(), counter:
            call()
    return sum(f for site, f in counter.sites.items()
               if site.startswith("repro_torch/models/attention.py:")
               and int(site.rsplit(":", 1)[1]) < first)


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_row_split_attention_flops_follow_the_model_axis(kind, shapes):
    """The attention FLOPs per device of a prefill whose heads do not divide
    "model" (6-head qwen2 on 1 x 4) are within 1.25x of the world-1 count
    over the axis size, and the whole step's FLOPs fall at least 3x."""
    cfg = _qwen2(attn_kv_block=8, attn_q_block=8)
    if kind == "local":
        cfg = dataclasses.replace(cfg, blocks=tuple(
            (tuple(dataclasses.replace(s, window=16) for s in pat), n) for pat, n in cfg.blocks))
    counts = {}
    for n in (1, 4):
        with fake_world(n):
            call, ctx = _cell(cfg, "s_prefill", (1, n))
            counts[n] = (_core_flops(call, ctx), _run(call, ctx, op_cost.analyze).flops)
    (attn1, total1), (attn4, total4) = counts[1], counts[4]
    assert 0 < attn4 <= 1.25 * attn1 / 4, counts
    assert total4 * 3 < total1, counts


@pytest.mark.parametrize("E", [5, 8])
def test_moe_dispatch_follows_the_batch_shard(E, shapes):
    """The slot count, dispatch and combine of reduced granite on 2 x 2
    scale with the data axis's batch shard: the bytes they move per device
    halve from a 1 x 2 world to a 2 x 2 one."""
    cfg = treg.reduced(treg.get_config("granite-moe-3b-a800m"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=E))
    moved = {}
    for data in (1, 2):
        with fake_world(2 * data):
            call, ctx = _cell(cfg, "s_prefill", (data, 2), arch="granite-moe-3b-a800m")
            _, byts = _run(call, ctx, perf_debug.attribute)
        moved[data] = sum(r[0] for r in byts
                          if "models/moe.py" in r[4] and r[3] in ("index_add_", "index",
                                                                  "scatter_", "cumsum"))
    assert moved[1] > 0 and moved[2] == pytest.approx(moved[1] / 2, rel=0.05), moved


def test_mamba_in_proj_is_not_gathered(shapes):
    """In a falcon-mamba prefill on 1 x 4 no collective at ssm.py carries
    the in_proj product: only the weight's all-gather (d x 2 din) and the
    x_proj reduction, each smaller than the product (B, S, 2 din)."""
    cfg = treg.reduced(treg.get_config("falcon-mamba-7b"))
    with fake_world(4):
        call, ctx = _cell(cfg, "s_prefill", (1, 4), arch="falcon-mamba-7b")
        coll, _ = _run(call, ctx, perf_debug.attribute)
    din = cfg.ssm.expand * cfg.d_model
    product = 4 * 64 * 2 * din * 4                      # f32, whole
    ssm = [r for r in coll if "models/ssm.py" in r[4]]
    assert ssm and all(r[2] < product / 4 for r in ssm), (ssm, product)


def _site_flops(cfg, arch, n, fn) -> float:
    """FLOPs per device of a prefill of `cfg` on a 1 x n fake world, summed
    over the call sites inside `fn` (a function of `models/attention.py`)."""
    import inspect

    lines, first = inspect.getsourcelines(fn)
    counter = _FlopsBySite()
    with fake_world(n):
        call, ctx = _cell(cfg, "s_prefill", (1, n), arch=arch)
        with ctx[0](), ctx[1]():
            call()
            with op_cost.alltoall_as_on_a_card(), counter:
                call()
    return sum(f for site, f in counter.sites.items()
               if site.startswith("repro_torch/models/attention.py:")
               and first <= int(site.rsplit(":", 1)[1]) < first + len(lines))


def test_kv_heads_projected_only_where_read(shapes):
    """stablelm-shaped, 8 q / 2 kv heads on 1 x 4 (q heads divide "model",
    kv heads do not): each rank projects its 2 q heads and the 1 kv head
    they read, for k and for v, (2 + 1 + 1) / (8 + 2 + 2) of the world-1
    projection FLOPs, where the whole kv heads on every rank gave 6 / 12;
    the cache's rows come from an all-to-all of those heads.  No whole
    repeated k or v is built (`_repeat_kv` records nothing), and the
    all-to-all moves no more than a quarter of the cache's k and v."""
    from repro_torch.models import attention

    cfg = dataclasses.replace(treg.reduced(treg.get_config("stablelm-12b")),
                              n_heads=8, n_kv_heads=2)
    one, four = (_site_flops(cfg, "stablelm-12b", n, attention._project) for n in (1, 4))
    assert 0 < four <= 1.02 * one * 4 / 12, (one, four)
    with fake_world(4):
        call, ctx = _cell(cfg, "s_prefill", (1, 4), arch="stablelm-12b")
        coll, byts = _run(call, ctx, perf_debug.attribute)
    kv_cache = 2 * 4 * 64 * cfg.n_kv_heads * cfg.head_dim * 4     # k and v (B, S, Hkv, D) f32
    trades = [r for r in coll if r[3] == "all-to-all" and "models/attention.py" in r[4]]
    assert trades and all(r[2] <= kv_cache / 4 for r in trades), (trades, kv_cache)
    import inspect
    lines, first = inspect.getsourcelines(attention._repeat_kv)
    at_repeat = [r for r in byts if r[4].startswith("repro_torch/models/attention.py:")
                 and first <= int(r[4].rsplit(":", 1)[1]) < first + len(lines)]
    assert not at_repeat, at_repeat


def test_mla_down_projections_follow_the_rows(shapes):
    """Reduced deepseek-v2-236b on 1 x 4: `wq_a` and `wkv_a` read each
    rank's quarter of the rows, a quarter of the world-1 FLOPs (whole
    rows on every rank gave all of them)."""
    from repro_torch.models import attention

    cfg = treg.reduced(treg.get_config("deepseek-v2-236b"))
    one, four = (_site_flops(cfg, "deepseek-v2-236b", n, attention._mla_latents)
                 for n in (1, 4))
    assert 0 < four <= 1.02 * one / 4, (one, four)


def test_uneven_bidirectional_rows_split(shapes, caplog):
    """Reduced whisper-large-v3 with 6 heads and 30 frames on 1 x 4: the
    encoder's rows are padded to 32 and split, so the attention cores'
    FLOPs per device are within 1.1x of the world-1 count over 4 (each
    rank scores 8 of 32 padded rows against the 30 frames: 32 / 30 of a
    quarter of the encoder's; whole rows on every rank gave 1.33x), and
    nothing says that rows do not split evenly."""
    from repro_torch.models import attention

    cfg = dataclasses.replace(treg.reduced(treg.get_config("whisper-large-v3")),
                              n_heads=6, n_kv_heads=6, enc_frames=30)
    attention._say_replicated.cache_clear()
    counts = {}
    with caplog.at_level("WARNING", logger=attention.__name__):
        for n in (1, 4):
            with fake_world(n):
                call, ctx = _cell(cfg, "s_prefill", (1, n), arch="whisper-large-v3")
                counts[n] = _core_flops(call, ctx)
    assert 0 < counts[4] <= 1.1 * counts[1] / 4, counts
    assert "do not split evenly" not in caplog.text

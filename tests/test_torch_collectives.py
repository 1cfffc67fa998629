"""The collectives of the port's sharded step, counted by kind.

Each case runs one step of a reduced arch on a 1 x 4 fake world (meta
shards, `launch/mesh.init_fake_world`) under the dry run's axis rules and
`perf_debug.attribute`, and holds the count of each kind of collective to
what the model must send.  The counts are written from the model's
structure, not read off one torch version: DTensor's own redistribution
rules differ between versions, and the step makes every reduction whose
kind they would choose explicit, so the same counts hold on each.

Decode, with the heads dividing "model" (4 q heads, the reduced configs'),
`perf_debug.decode_collectives`, which `chip_smoke.py` holds the full
gemma3-27b decode_32k cell to on the card's host:

- one all-reduce per block output (mixer, cross-attention, FFN), at the
  residual add, plus one for the embedding's sum over the vocab-sharded
  table;
- a global attention layer over the T-sharded cache: one all-gather each
  of the q heads, the new k row and the new v row, and of the split-T
  partials (`attention._merge_partials`); MLA: the absorbed query's two
  parts and the merge; a ring layer none (its slots are whole);
- RG-LRU: the two gate products, summed over the sharded width, each
  reduce-scattered into the state's layout; Mamba: `x_proj`'s product,
  one all-reduce, and the in_proj product's two halves, one all-gather
  each;
- MoE: the routed experts' sum over their sharded FFN width in the expert
  buffer; with shared experts, theirs at the residual add;
- cross-attention: the cross cache's k and v laid out by heads, one
  all-to-all each;
- the serve step's logits, gathered along the vocab for the argmax.

A train step of a dense transformer (reduced stablelm-12b, the sequence
sharded over "model" between the blocks, each layer's body recomputed in
the backward):

- forward: each norm (two a layer and the final one) gathers the sequence,
  each block output and the embedding's sum are reduce-scattered onto it;
  each loss chunk keeps its logits vocab-sharded: its log-sum-exp
  all-reduces the rows' maxes and then their sums of exponentials
  (`sharding.logsumexp_last`), and its label pick is all-reduced
  (`sharding.gather_last`); the chunks' sums, partial over the batch's
  shards, are summed as one and reduced once, over "data" (one rank here:
  nothing moves);
- recompute: each layer's norms gather again and its first block output is
  reduce-scattered again (the last one is not needed: checkpointing stops
  there), each loss chunk's two log-sum-exp all-reduces run again (its
  label pick is not needed: the recompute stops before it);
- backward: each gather's gradient is reduce-scattered, each
  reduce-scatter's gathered;
- optimizer: each gradient laid out as its optimizer state; the norm
  scales' gradients, partial sums over the sequence's shards, all-reduced
  (one a stacked leaf); the global norm's sum all-reduced once.

A MoE train step (reduced granite-moe-3b-a800m on 1 x 4 and 2 x 2): the
slot count, the dispatch and the combine run on each rank's batch rows
(`per_shard`) and the router's top-k weights are renormalized on each
rank's own rows (`sharding.per_row`), so the routing's backward sends
nothing of its own on any torch version; the counts are written out
beside `MOE_TRAIN`.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded_step import _cell, _run, fake_world  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import perf_debug  # noqa: E402

DECODE_ARCHS = ["qwen1.5-0.5b", "gemma3-27b", "stablelm-12b", "recurrentgemma-9b",
                "falcon-mamba-7b", "deepseek-v2-236b", "whisper-large-v3"]


@pytest.fixture
def shapes(monkeypatch):
    cells = {"s_decode": tbase.ShapeCell("s_decode", 256, 8, "decode"),
             "s_train": tbase.ShapeCell("s_train", 64, 4, "train")}
    for k, v in cells.items():
        monkeypatch.setitem(tbase.SHAPES, k, v)
    return cells


def counts(cfg, arch: str, shape: str, mesh=(1, 4)) -> dict:
    """Collectives by kind of one step of `cfg` on a fake world of `mesh`."""
    with fake_world(mesh[0] * mesh[1]):
        call, ctx = _cell(cfg, shape, mesh, arch=arch)
        coll, _ = _run(call, ctx, perf_debug.attribute)
    out: dict = {}
    for r in coll:
        out[r[3]] = out.get(r[3], 0) + r[1]
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_reduces_once_per_block_output(arch, shapes):
    cfg = treg.reduced(treg.get_config(arch))
    assert cfg.n_heads % 4 == 0 or cfg.family == "ssm"
    assert counts(cfg, arch, "s_decode") == perf_debug.decode_collectives(cfg)


def test_decode_counts_follow_the_layer_pattern(shapes):
    """Reduced gemma3-27b's 8 layers (one global): 16 block outputs and the
    embedding, 4 + 1 all-gathers; cut to two ring layers and the global
    one, then to three ring layers alone: the global layer's four
    all-gathers go with it, the block outputs' all-reduces follow the
    layer count."""
    cfg = treg.reduced(treg.get_config("gemma3-27b"))
    assert perf_debug.decode_collectives(cfg) == {"all-reduce": 17, "all-gather": 5}
    ring, glob = cfg.blocks[0][0][0], cfg.blocks[0][0][-1]
    for blocks in (((ring, ring, glob), 1), ((ring,), 3)):
        cut = dataclasses.replace(cfg, blocks=(blocks,))
        assert counts(cut, "gemma3-27b", "s_decode") == perf_debug.decode_collectives(cut), blocks


def train_counts(cfg, seq: int) -> dict:
    """What a dense transformer's train step must send, by kind (the
    module's docstring)."""
    layers = sum(reps * len(pattern) for pattern, reps in cfg.blocks)
    scale_leaves = sum(2 * len(pattern) for pattern, _ in cfg.blocks) + 1
    chunks = seq // min(cfg.loss_chunk, seq)
    norms, outs = 2 * layers + 1, 2 * layers
    return {"all-gather": norms + 2 * layers + outs + 1,
            "reduce-scatter": outs + 1 + layers + norms,
            # a loss chunk: max, sum and pick, then max and sum recomputed
            "all-reduce": 3 * chunks + 2 * chunks + scale_leaves + 1}


@pytest.mark.parametrize("reps,chunk", [(1, 64), (2, 32)])
def test_train_step_collectives(reps, chunk, shapes):
    """Reduced stablelm-12b, one or two layers, the 64-token sequence's loss
    in one chunk or two, on 1 x 4."""
    cfg = treg.reduced(treg.get_config("stablelm-12b"))
    assert cfg.remat == "nothing_saveable"
    cfg = dataclasses.replace(cfg, blocks=((cfg.blocks[0][0], reps),), loss_chunk=chunk)
    assert counts(cfg, "stablelm-12b", "s_train") == train_counts(cfg, 64)


def test_add_partial_makes_every_term_a_partial_sum():
    """A partial mean (torch 2.11's mean over a batch-sharded dim: the MoE
    balance loss), a partial sum and a whole term, added on a 2 x 2 fake
    world: one partial sum, each rank's part of the mean divided by the
    dim's size, the whole term kept on the dim's first rank; no
    collective (DTensor adds no two kinds of partial sum)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.sharding import AxisRules, add_partial, use_axis_rules
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import make_mesh

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        mean = DTensor.from_local(torch.tensor(3.0), mesh, [Partial("avg"), Replicate()])
        part = DTensor.from_local(torch.tensor(5.0), mesh, [Partial(), Replicate()])
        out = []
        with use_axis_rules(AxisRules({}, mesh)):
            cost = op_cost.analyze(lambda: out.append(add_partial(mean, part, 7.0)))
        total = out[0]
    assert cost.coll_wire == 0 and not cost.coll_by_kind
    assert list(total.placements) == [Partial(), Replicate()]
    assert total.to_local().item() == 3.0 / 2 + 5.0 + 7.0      # rank 0: the first on "data"


def test_add_partial_refuses_a_shard_beside_a_partial_sum():
    """A term sharded along a mesh dim on which another term is a partial
    sum has no partial-sum form without a collective: `add_partial` raises
    (the caller lays the term out first) and does not divide it."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.distributed.sharding import AxisRules, add_partial, use_axis_rules
    from repro_torch.launch.mesh import make_mesh

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        part = DTensor.from_local(torch.ones(2, 4), mesh, [Shard(0), Partial()],
                                  run_check=False)
        cut = DTensor.from_local(torch.ones(2, 2), mesh, [Shard(0), Shard(1)],
                                 run_check=False)
        with use_axis_rules(AxisRules({}, mesh)), pytest.raises(ValueError, match="lay the term out"):
            add_partial(part, cut)


# reduced granite-moe-3b-a800m (one attention + MoE layer, 8 experts, the
# 64-token loss in one chunk), by kind, on 1 x 4 and on 2 x 2:
MOE_TRAIN = {
    (1, 4): {
        # the two norms and the final one gather the sequence (3), two of
        # them again in the recompute (2); the backward gathers the
        # attention output's and the embedding's reduce-scattered
        # gradients (2 + 1)
        "all-gather": 3 + 2 + 2 + 1,
        # the attention output and the embedding's sum onto the sequence
        # (1 + 1), the attention output again in the recompute (1), the
        # gradients of the attention's and the final norm's gathers (2);
        # the MoE norm's output is read whole on each rank (`per_shard`),
        # its gradient comes back whole
        "reduce-scatter": 1 + 1 + 1 + 2,
        # the expert buffer's sum over its sharded FFN width (forward,
        # recompute, backward: 3), the three norm scales' gradients (3),
        # the loss chunk's max, sum and pick and again its max and sum
        # (5), the global norm (1); the router's product and its top-k
        # weights' renormalization send nothing
        "all-reduce": 3 + 3 + 5 + 1,
    },
    (2, 2): {
        # as on 1 x 4, and the router (its experts dim on "data") gathered
        # for its product in the forward, the recompute and the backward
        # (3), and the 8 parameters sharded along "data" gathered after
        # the update (8)
        "all-gather": 3 + 2 + 2 + 1 + 3 + 8,
        # as on 1 x 4, and the 9 gradients laid out as their optimizer
        # state (9)
        "reduce-scatter": 1 + 1 + 1 + 2 + 9,
        # as on 1 x 4, and the router's logits, a partial sum, reduced at
        # the softmax and again in the recompute (2), the chunks' sum and
        # the loss's add over "data" (1 + 1), the global norm over the
        # second mesh dim (1)
        "all-reduce": 3 + 3 + 5 + 1 + 2 + 2 + 1,
        # the buffer to the experts and back, in the forward, the
        # recompute and the backward (6), and the MoE norm's gradient
        # onto the sequence's shards (1)
        "all-to-all": 3 + 3 + 1,
    },
}


@pytest.mark.parametrize("mesh", list(MOE_TRAIN), ids=lambda m: "x".join(map(str, m)))
def test_moe_train_step_collectives(mesh, shapes):
    """Reduced granite-moe-3b-a800m's train step: `route` renormalizes its
    top-k weights on each rank's own rows (`sharding.per_row`), so that
    step's backward sends nothing whatever DTensor's rules for a row's
    division by its sum are (torch 2.11 all-gathered there)."""
    cfg = treg.reduced(treg.get_config("granite-moe-3b-a800m"))
    assert cfg.moe.n_experts == 8 and cfg.loss_chunk >= 64
    assert counts(cfg, "granite-moe-3b-a800m", "s_train", mesh) == MOE_TRAIN[mesh]

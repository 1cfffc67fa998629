"""`op_cost`'s live-byte count against the CPU allocator.

The count is `op_cost.analyze(step, *args).peak_bytes`, what the dry run
reports as a cell's temp bytes: the step runs once on meta tensors, and
each output's storage counts from the op that made it until the storage
is freed.  The truth is the CPU allocator's peak while the same step runs
on CPU tensors of the same shapes: the profiler's allocation events
(`profile_memory`, the events its memory timeline sums), each block the
step's thread allocates counted until it is freed.  Tensors made before
the step (its arguments) count on neither side.

- Unit steps where the rule is delicate, at 256 x 256 f32: a view that
  outlives its base, the outputs autograd saves, a parameter's gradient, an
  in-place op on an argument (nothing new) and on an intermediate (nothing
  new), autograd's index backward (in place, though the counter's dispatch
  mode turns it out of place), each within 2% (or 64 bytes: a Python
  scalar's own tensor) of the allocator; a reduce-scatter's result on a
  fake world, counted once; and `once_per_shape`'s replay of outputs that
  are views of one storage, equal to running the body each time.
- DTensor's all-to-all: a Shard -> Shard step on fake worlds of 4 and 16
  counts its result at its own bytes (the fake kernel returns a view of an
  n-fold `cat`) and the one copy torch's op holds beside it while it runs;
  torch's op itself, run in a 4-process gloo world (or over NCCL on 4
  cards), peaks at what the count says for each layout of `ALLTOALL`.
- Reduced qwen2-1.5b, deepseek-v2-236b (MLA and MoE), falcon-mamba-7b (its
  plain scan) and recurrentgemma-9b, batch 2 x 64 tokens: a train step
  (`forward_train` and `backward`, every floating parameter requiring
  grad) and a no-grad prefill, each within 2% of the allocator.

A CPU kernel's own scratch (`mm` on a broadcast operand copies it inside
the kernel) is allocated where no dispatched op shows it, so the unit
steps use no such operand.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_tree, tree_leaves, tree_map  # noqa: E402

N = 256
F32 = N * N * 4
REL = 0.02


def cpu_peak(fn) -> int:
    """Peak of the CPU allocator's live bytes while fn() runs, over what was
    live when it started: the profiler's allocation events in time order
    (what its memory timeline sums as CREATE and DESTROY, read without the
    data-flow graph it builds to name each tensor).  Only blocks allocated
    by the thread that runs fn count, until freed by any thread: a gloo
    world's transport threads allocate and free scratch of their own."""
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler._memory_profiler import OpTree

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        with record_function("cpu_peak"):
            fn()
    events = OpTree(prof.profiler.kineto_results).sorted_nodes
    tid = next(e.start_tid for e in events if e.name == "cpu_peak")
    held, live, peak = {}, 0, 0
    for e in events:
        if e.typed[0] != _EventType.Allocation:
            continue
        a = e.typed[1]
        if a.alloc_size > 0 and e.start_tid == tid:
            held[a.ptr] = a.alloc_size
            live += a.alloc_size
            peak = max(peak, live)
        elif a.alloc_size < 0:
            live -= held.pop(a.ptr, 0)
    return peak


def meta(t: torch.Tensor) -> torch.Tensor:
    m = torch.empty(t.shape, dtype=t.dtype, device="meta")
    return m.requires_grad_() if t.requires_grad else m


def counted_and_real(step, *args) -> tuple[float, int]:
    """(the count on meta tensors, the allocator's peak on `args`)."""
    counted = op_cost.analyze(step, *tree_map(meta, list(args))).peak_bytes
    return counted, cpu_peak(lambda: step(*args))


# ---------------------------------------------------------------------------
# unit steps
# ---------------------------------------------------------------------------

def _view_outlives_its_base(x):
    # the product's tensor dies here; the detached view of it, which keeps
    # no reference to it (no `_base`), holds its storage
    v = (x * 2).detach()[0]
    y = x + 1
    return v, y


def _saved_by_autograd(x, w):
    # each tanh saves its output for the backward; nothing else holds it
    loss = sum(torch.tanh(x @ w).sum() for _ in range(8))
    loss.backward()


def _parameter_gradient(x, w):
    torch.tanh(x @ w).sum().backward()


def _in_place_on_an_argument(x):
    x.add_(1)


def _in_place_on_an_intermediate(x):
    y = x * 2
    y.add_(1)
    return y


def _index_backward(x, idx):
    # autograd writes x's gradient into zeros by index, in place
    (x[idx] * 2).sum().backward()


def _x():
    return torch.from_numpy(np.random.default_rng(0).standard_normal((N, N), np.float32))


def _w():
    w = np.random.default_rng(1).standard_normal((N, N), np.float32) / np.float32(np.sqrt(N))
    return torch.from_numpy(w).requires_grad_()


# step, its arguments, the count it must reach exactly (None: the allocator's)
UNITS = {
    "view_outlives_its_base": (_view_outlives_its_base, lambda: (_x(),), 2 * F32),
    "saved_by_autograd": (_saved_by_autograd, lambda: (_x(), _w()), None),
    "parameter_gradient": (_parameter_gradient, lambda: (_x(), _w()), None),
    "in_place_on_an_argument": (_in_place_on_an_argument, lambda: (_x(),), 0),
    "in_place_on_an_intermediate": (_in_place_on_an_intermediate, lambda: (_x(),), F32),
    "index_backward": (_index_backward,
                       lambda: (_x().requires_grad_(), torch.arange(0, N, 2)), None),
}


@pytest.mark.parametrize("name", UNITS)
def test_unit_step_count_matches_the_allocator(name):
    step, args, exact = UNITS[name]
    counted, real = counted_and_real(step, *args())
    assert abs(counted - real) <= max(REL * real, 64), (counted, real)
    if exact is not None:
        assert counted == exact
    if name == "saved_by_autograd":
        assert counted >= 8 * F32       # the eight saved tanh outputs at once
    if name == "parameter_gradient":
        assert counted >= 2 * F32       # w's gradient beside the saved tanh output


def test_collective_result_counts_once():
    """A reduce-scatter's result on a fake world of 4, kept while another
    tensor of its size is made: both count, once each."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.launch.mesh import destroy_fake_world, init_fake_world, make_mesh

    init_fake_world(4)
    try:
        mesh = make_mesh((4,), ("d",), "cpu")
        x = DTensor.from_local(torch.empty(N, N, device="meta"), mesh, [Partial()],
                               run_check=False)

        def step(x):
            y = x.redistribute(mesh, [Shard(0)])
            return y, y * 2

        c = op_cost.analyze(step, x)
    finally:
        destroy_fake_world()
    assert c.peak_bytes == 2 * F32 // 4


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("src,dst", [(1, 0), (0, 1)], ids=["alltoall_1_to_0", "alltoall_0_to_1"])
def test_alltoall_result_counts_at_its_own_bytes(src, dst, n):
    """DTensor's Shard(src) -> Shard(dst) step of a 4-D bf16 tensor on a fake
    world of n, as a card's mesh runs it (one all-to-all): its result holds
    its own bytes once the op returns (the fake kernel hands it back as a
    view of the n-fold `cat` when dst is the outermost dim), the op holds one
    more buffer of that size while it runs (the received chunks, copied to
    the gather dim; or the input's copy with the shard dim first), and the
    wire bytes are the result's at the all-to-all formula."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import destroy_fake_world, init_fake_world, make_mesh

    init_fake_world(n)
    try:
        mesh = make_mesh((n,), ("d",), "cpu")
        local = [32, 64, 8, 8]
        local[src] //= n
        x = DTensor.from_local(torch.empty(local, dtype=torch.bfloat16, device="meta"), mesh,
                               [Shard(src)], run_check=False)
        counter = op_cost._OpCounter()
        with op_cost.alltoall_as_on_a_card(), counter:
            y = x.redistribute(mesh, [Shard(dst)])
            live = counter.live
    finally:
        destroy_fake_world()
    result = 32 * 64 * 8 * 8 // n * 2
    assert y.to_local().numel() * 2 == result
    assert live == result
    assert counter.cost.peak_bytes == 2 * result
    assert counter.cost.coll_by_kind["all-to-all"] == {"bytes": result * (n - 1) / n, "count": 1}


# (gather dim, shard dim, local input shape) of `_dtensor::shard_dim_alltoall`
# over 4 ranks, and the buffers of the result's size torch's op holds at
# its peak: with the result, the input's copy with the shard dim first
# unless that is its layout, and the received chunks when the result is
# their copy to the gather dim
ALLTOALL = [(1, 0, (32, 4, 8, 512), 2), (0, 1, (8, 16, 8, 512), 2),
            (2, 1, (8, 16, 8, 512), 3), (1, 0, (4, 1, 8, 512), 1),
            (0, 1, (1, 16, 8, 512), 1)]

_ALLTOALL_RANK = """
import json, sys
import torch, torch.distributed as dist
sys.path.insert(0, "tests")
from test_torch_memory import ALLTOALL, cpu_peak
rank, backend = int(sys.argv[1]), "{backend}"
if backend == "nccl":
    torch.cuda.set_device(rank)
dist.init_process_group(backend, store=dist.FileStore(sys.argv[2], 4), rank=rank, world_size=4)
group = dist.group.WORLD.group_name


def card_peak(fn):
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


peaks = []
for gather, shard, shape, _ in ALLTOALL:
    x = torch.randn(shape, device="cuda" if backend == "nccl" else "cpu")
    kept = []
    peak = (card_peak if backend == "nccl" else cpu_peak)(
        lambda: kept.append(torch.ops._dtensor.shard_dim_alltoall(x, gather, shard, group)))
    peaks.append(peak)
print("PEAKS", json.dumps(peaks), flush=True)
dist.destroy_process_group()
"""


def _alltoall_peaks(backend, tmp_path):
    from test_torch_tooling import _gloo4

    ranks = []
    for out, err in _gloo4(_ALLTOALL_RANK.format(backend=backend), tmp_path, timeout=120):
        got = [line for line in out.splitlines() if line.startswith("PEAKS ")]
        assert got, err[-3000:]
        ranks.append(json.loads(got[0][6:]))
    return ranks


def _alltoall_counts():
    from repro_torch.launch.mesh import destroy_fake_world, init_fake_world

    init_fake_world(4)
    try:
        group = torch.distributed.group.WORLD.group_name
        return [op_cost.analyze(
            lambda x: torch.ops._dtensor.shard_dim_alltoall(x, gather, shard, group),
            torch.empty(shape, device="meta")).peak_bytes for gather, shard, shape, _ in ALLTOALL]
    finally:
        destroy_fake_world()


def _hold_alltoall(ranks):
    counts = _alltoall_counts()
    for (_, _, shape, units), count in zip(ALLTOALL, counts):
        assert count == units * int(np.prod(shape)) * 4, (shape, count)
    for rank, peaks in enumerate(ranks):
        for case, peak, count in zip(ALLTOALL, peaks, counts):
            assert count == pytest.approx(peak, rel=REL), (rank, case, count, peak)


def test_alltoall_count_matches_the_allocator(tmp_path):
    """torch's `_dtensor::shard_dim_alltoall` run in a 4-process gloo world
    on the CPU: each rank's allocator peak inside the op, over the input it
    was given, equals `op_cost`'s count of the same call on meta tensors
    over a fake world of 4, for each layout of `ALLTOALL`."""
    _hold_alltoall(_alltoall_peaks("gloo", tmp_path))


@pytest.mark.cuda
def test_alltoall_count_matches_the_cards(tmp_path):
    """The same, over NCCL on 4 cards: each card's `max_memory_allocated`
    inside the op against the count."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    _hold_alltoall(_alltoall_peaks("nccl", tmp_path))


def test_once_per_shape_replays_views_of_one_storage():
    """A body whose outputs are two views of one buffer: a replay holds the
    whole buffer while either view lives, as running the body does."""
    def body(x, w):
        y = torch.tanh(x @ w)
        return y[:, :N // 4], y[:, N // 4:]

    x, w = torch.empty(N, N, device="meta"), torch.empty(N, N, device="meta")

    def run(call):
        kept = [call(body, x, w)[0] for _ in range(4)]   # only the narrow views kept
        return torch.cat(kept, dim=1)

    full = op_cost.analyze(lambda: run(lambda f, *a: f(*a)))
    counter = op_cost._OpCounter()
    with counter:
        run(counter.once_per_shape)
    assert counter.cost.peak_bytes == full.peak_bytes
    assert full.peak_bytes >= 4 * F32   # each kept view holds its whole buffer


# ---------------------------------------------------------------------------
# reduced models: a train step and a prefill
# ---------------------------------------------------------------------------

ARCHS = ("qwen2-1.5b", "deepseek-v2-236b", "falcon-mamba-7b", "recurrentgemma-9b")
B, S = 2, 64


def _model(arch, train: bool):
    cfg = treg.reduced(treg.get_config(arch))
    params = init_tree(T.build_descriptors(cfg), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
                              .astype(np.int32))
    if not train:
        def prefill(params, tokens):
            with torch.no_grad():
                return T.prefill(cfg, params, tokens)
        return prefill, (params, tokens)
    for t in tree_leaves(params):
        if t.is_floating_point():
            t.requires_grad_()

    def train_step(params, batch):
        loss, _ = T.forward_train(cfg, params, batch)
        loss.backward()
    return train_step, (params, {"tokens": tokens, "labels": tokens})


@pytest.mark.parametrize("train", [True, False], ids=["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_step_count_matches_the_allocator(arch, train):
    step, args = _model(arch, train)
    counted, real = counted_and_real(step, *args)
    assert counted == pytest.approx(real, rel=REL), (counted, real, counted / real)

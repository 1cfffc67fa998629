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
- Reduced qwen2-1.5b, deepseek-v2-236b (MLA and MoE), falcon-mamba-7b (its
  plain scan) and recurrentgemma-9b, batch 2 x 64 tokens: a train step
  (`forward_train` and `backward`, every floating parameter requiring
  grad) and a no-grad prefill, each within 2% of the allocator.

A CPU kernel's own scratch (`mm` on a broadcast operand copies it inside
the kernel) is allocated where no dispatched op shows it, so the unit
steps use no such operand.
"""
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

"""Price a task body before running it, from the aten ops it calls.

The counterpart of the JAX package's `repro/launch/hlo_cost.py` (its
`Cost`, `DeviceModel` and `DurationPredictor`, DESIGN.md §11).  That
module walks the optimized HLO of a jitted body; eager torch has no HLO,
so this one runs the body once on *meta* tensors of the arguments' shapes
and dtypes — no data, no device work, no CUDA context — under a
`TorchDispatchMode` that counts every aten op the call dispatches, with
the HLO walk's rules:

  * a matrix product (mm, bmm, mv, dot, addmm, baddbmm) costs
    2 * result elements * contracted elements FLOPs;
  * a reduction (sum, mean, amax, ...) costs its operand bytes / 4;
  * a view, copy, factory or indexing op is free; any other op costs one
    FLOP per output element;
  * bytes are every non-view op's tensor inputs plus outputs.

Eager torch does not fuse, so the byte count is what an op-by-op run
moves: an upper bound on what the reference's fused HLO reads and writes.

`analyze(fn, *args)` is the counterpart of the HLO half (`HloModule`,
`analyze`).  It runs `fn` once under the same counter, on whatever tensors
it is given: fake or meta tensors cost nothing, and DTensors are let
through to their own dispatch first, so that the counter sees each rank's
local ops (per-device FLOPs and bytes) and the functional collectives
DTensor emits.  Each collective (`all_reduce`, `all_gather_into_tensor`,
`reduce_scatter_tensor`, `all_to_all_single`, and DTensor's
`shard_dim_alltoall`) adds its per-device wire bytes by the reference's
ring formulas, over the size of the group it names; `wait_tensor` is free.
DTensor's all-to-all runs as on a card's mesh, not as the "cpu" mesh's
all-gather and chunk (`alltoall_as_on_a_card`).  Eager loops are unrolled in Python, so every trip
is counted as it runs: the HLO walk's trip-count rule has no counterpart.
The counter also keeps the peak of the bytes its ops' outputs hold alive
(`Cost.peak_bytes`): each output's storage counts once, at its size, from
the op that made it until the storage itself is freed, which is when its
last holder lets go: a view outlives its base, and autograd keeps what it
saves after the tensor the program held is gone.  An output on an input's
storage (in place, `out=`) adds nothing; and autograd's index backward,
which a dispatch mode turns out of place, counts in place, as the program
runs it.  A collective's result counts at its own bytes, once, as a card's
op returns it in a buffer of its own: a functional collective's meta kernel
hands it back as a new tensor, and DTensor's all-to-all's fake kernel as a
view of the n-fold `cat` of its input.  The all-to-all also holds, while it
runs over n > 1 ranks, a buffer of the result's size for each copy torch's
op makes (`_alltoall_scratch`), as the CPU allocator shows of that op on
torch 2.11 and 2.13; they count towards the peak and die before it
returns.  Eager execution reuses no buffers the way XLA's allocator does,
so this is the peak of what the program holds, not of a planned arena.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.task import arg_signature, stable_fn_key

_aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    """FLOPs, bytes and collective wire bytes of one call, per device."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_wire: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0

    def add_coll(self, kind: str, wire: float):
        self.coll_wire += wire
        e = self.coll_by_kind.setdefault(kind, {"bytes": 0.0, "count": 0.0})
        e["bytes"] += wire
        e["count"] += 1


def _contracted(func, args) -> int:
    """Elements summed into each output element of a matrix product."""
    if func is _aten.dot.default:
        return args[0].shape[0]
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        return args[1].shape[-1]
    return args[0].shape[-1]                      # mm, bmm, mv


_MATMUL = {_aten.mm.default, _aten.bmm.default, _aten.mv.default,
           _aten.dot.default, _aten.addmm.default, _aten.baddbmm.default}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "argmax", "argmin", "any", "all", "logsumexp", "var", "std",
               "norm", "linalg_vector_norm", "cumsum", "cumprod"}

# ops that only relabel a tensor's metadata: no FLOPs and no bytes
_VIEWS = {"_unsafe_view", "_reshape_alias", "squeeze_", "unsqueeze_",
          "transpose_", "t_", "as_strided_", "resize_", "set_",
          # a collective's result handed back, and the wait for it
          "_wrap_tensor_autograd", "wait_tensor"}

_FREE = {
    # copies, conversions and layout changes (flop-free in the HLO walk)
    "clone", "copy", "copy_", "_to_copy", "contiguous", "cat", "stack",
    "repeat", "repeat_interleave", "flip", "roll", "constant_pad_nd",
    "index", "index_select", "gather", "scatter", "masked_fill",
    "index_put", "lift_fresh", "lift_fresh_copy",
    # factories
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "arange", "scalar_tensor", "fill",
    "fill_", "new_empty", "new_zeros", "new_ones", "new_full",
    "new_empty_strided",
}


_c10d = torch.ops._c10d_functional

# functional collective -> the reference's HLO name
COLLECTIVES = {
    _c10d.all_reduce: "all-reduce",
    _c10d.all_reduce_: "all-reduce",
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
    torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
}


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device bytes on the wire of one collective over a group of `n`
    (ring formulas, the reference's `hlo_analysis.collective_bytes`)."""
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return result_bytes * 2 * (n - 1) / n
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    return result_bytes


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return dist.get_world_size(_resolve_process_group(name))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _alltoall_scratch(args) -> int:
    """Bytes DTensor's all-to-all (`_dtensor::shard_dim_alltoall`) holds
    beside its result while it runs: over n > 1 ranks, torch's op sends a
    copy of the input with the shard dim first, unless that is already the
    input's layout, and receives the n chunks stacked along a new first
    dim, which is the result unless the gather dim is another: then the
    result is a copy of them.  Each copy is the result's size.  Over one
    rank the op makes the result alone."""
    x, gather_dim, shard_dim = args[:3]
    n = _group_size(args)
    if n == 1:
        return 0
    chunk = list(x.shape)
    chunk[shard_dim] //= n
    copies = ((not x.movedim(shard_dim, 0).is_contiguous())
              + any(c != 1 for c in chunk[:gather_dim]))
    return copies * _nbytes(x)


class _OpCounter(TorchDispatchMode):
    """Adds each dispatched aten op's FLOPs and bytes, and each collective's
    wire bytes, to `cost`; keeps the peak of the bytes live in its ops'
    outputs.  An op on DTensors is handed to DTensor first (NotImplemented),
    which runs it as local ops and collectives that come back here."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self._held: dict = {}  # storage -> its bytes, while it lives
        self._local = None    # the device of the DTensors' local shards
        self.memo: dict = {}  # once_per_shape: key -> (Cost, storages, outputs on them)

    def _free(self, key):
        self.live -= self._held.pop(key, 0)

    def _hold(self, outs, ins, own=False, scratch=0):
        """Count each new storage among `outs` until it is freed: at its
        size, or with `own` (a collective's result) at the output's own
        bytes; `scratch` more bytes live only inside the op, at its peak."""
        shared = {a.untyped_storage()._cdata for a in ins}
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._held or key in shared:
                continue                      # in place or a view: no new buffer
            self._held[key] = _nbytes(t) if own else s.nbytes()
            self.live += self._held[key]
            weakref.finalize(s, self._free, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live + scratch)

    def _pass_on(self, src, dst):
        """Move `src`'s count to `dst`'s storage: one buffer of the counted
        program, handed back here as another tensor."""
        key, new = src.untyped_storage()._cdata, dst.untyped_storage()
        if key in self._held and new._cdata != key:
            self._held[new._cdata] = self._held.pop(key)
            weakref.finalize(new, self._free, new._cdata)

    def record(self, func, args, kwargs, out, cost: "Cost"):
        """Add one local op's FLOPs, bytes and wire bytes to `cost`."""
        name = func.overloadpacket.__name__
        outs = list(_tensors(out))
        cost.bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                       + sum(_nbytes(t) for t in outs))
        kind = COLLECTIVES.get(func.overloadpacket)
        if kind is not None:
            cost.add_coll(kind, wire_bytes(kind, sum(_nbytes(t) for t in outs),
                                           _group_size(args)))
        elif func in _MATMUL:
            cost.flops += 2.0 * outs[0].numel() * _contracted(func, args)
        elif name.rstrip("_") in _REDUCTIONS:
            cost.flops += sum(_nbytes(t) for t in _tensors(args)) / 4.0
        elif name not in _FREE:
            cost.flops += sum(t.numel() for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            if self._local is None:
                self._local = next(a._local_tensor.device for a in args
                                   if isinstance(a, DTensor))
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _VIEWS:
            if func.overloadpacket is _c10d._wrap_tensor_autograd and type(out) is torch.Tensor:
                # a collective's result: its meta kernel makes a new tensor,
                # where a device's run wraps the same buffer
                self._pass_on(args[0], out)
            return out
        if self._local is not None and not any(
                t.device == self._local and not isinstance(t, FakeTensor)
                for t in _tensors(out)):
            # DTensor's own bookkeeping: shard offsets on small host
            # tensors, and a new op's output metadata, found by running it
            # at the global shape on fake tensors
            return out
        self.record(func, args, kwargs, out, self.cost)
        if func is _aten.index_put.default and torch._C._current_graph_task_id() != -1:
            # autograd's index backward writes into its zeros out of place
            # under any dispatch mode (this counter), in place without one
            self._pass_on(args[0], out)
        collective = func.overloadpacket in COLLECTIVES
        scratch = (_alltoall_scratch(args)
                   if func.overloadpacket is torch.ops._dtensor.shard_dim_alltoall else 0)
        self._hold(list(_tensors(out)), list(_tensors((args, kwargs))), collective, scratch)
        return out

    def once_per_shape(self, fn, *args):
        """``fn(*args)`` for a function of its tensors' shapes alone, run on
        meta tensors: the first call for each (fn, shapes, dtypes) runs and
        is counted as usual; a later one adds that call's cost (its peak on
        top of what is live) and returns fresh meta outputs, without running
        fn: outputs on one storage in fn's run share one storage of its size
        again, with their views' offsets and strides.  On tensors with data,
        where autograd records (a replay would leave no graph), or for a body
        with collectives or an output on an input's storage, fn(*args): a
        replay holds each output's whole storage, where a collective's
        result counts at its own bytes (`_hold`); a collective that sends
        no bytes runs over one rank, where its fake kernel's result is a
        storage of its own size.  The dry run's counterpart of a scanned
        body traced once;
        `distributed.sharding.per_shard` calls it on the current dispatch
        mode when that mode has it."""
        from torch.utils._python_dispatch import _disable_current_modes

        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if (not all(t.is_meta for t in tensors)
                or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
            return fn(*args)
        key = (_fn_key(fn), tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                                  else a for a in args))
        c = self.cost
        if key not in self.memo:
            flops, nbytes, wire, live, peak = c.flops, c.bytes, c.coll_wire, self.live, c.peak_bytes
            c.peak_bytes = live                 # the peak inside fn, from here
            out = fn(*args)
            delta = Cost(c.flops - flops, c.bytes - nbytes, peak_bytes=c.peak_bytes - live)
            c.peak_bytes = max(peak, c.peak_bytes)
            outs = out if isinstance(out, tuple) else (out,)
            stores = {}                         # storage -> (index, bytes)
            layout = [(stores.setdefault(t.untyped_storage()._cdata,
                                         (len(stores), t.untyped_storage().nbytes()))[0],
                       tuple(t.shape), t.stride(), t.storage_offset(), t.dtype) for t in outs]
            if c.coll_wire == wire and not stores.keys() & {
                    a.untyped_storage()._cdata for a in tensors}:
                self.memo[key] = (delta, [n for _, n in stores.values()], layout,
                                  isinstance(out, tuple))
            return out
        delta, sizes, layout, is_tuple = self.memo[key]
        c.flops += delta.flops
        c.bytes += delta.bytes
        c.peak_bytes = max(c.peak_bytes, self.live + delta.peak_bytes)
        with _disable_current_modes():      # the outputs' writes are in delta
            stores = [torch.empty(n, dtype=torch.uint8, device="meta").untyped_storage()
                      for n in sizes]
            outs = [torch.empty(0, dtype=dtype, device="meta").set_(stores[i], offset, shape,
                                                                     stride)
                    for i, shape, stride, offset, dtype in layout]
        self._hold(outs, [])
        return tuple(outs) if is_tuple else outs[0]


def _fn_key(fn):
    if isinstance(fn, functools.partial):
        return (_fn_key(fn.func), fn.args, tuple(sorted(fn.keywords.items())))
    return (fn.__module__, fn.__qualname__)


@contextlib.contextmanager
def alltoall_as_on_a_card():
    """DTensor on a "cpu" mesh runs each Shard(i) -> Shard(j) step as an
    all-gather of the whole result and a chunk of it (gloo has no
    all-to-all); on a card's mesh it is one all-to-all of the shard.  Inside
    this context that step is DTensor's all-to-all op on every mesh, so the
    fake world's count is a card's: the shard's bytes at the all-to-all
    formula, not n times them at the all-gather's."""
    from torch.distributed.tensor import placement_types

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    fallback = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = fallback


def analyze(fn, *args) -> Cost:
    """Per-device `Cost` of ``fn(*args)``, run once under the counter (see
    the module's docstring); `args` are passed as they are."""
    counter = _OpCounter()
    with alltoall_as_on_a_card(), counter:
        fn(*args)
    return counter.cost


def _meta(a):
    """A data-free stand-in for one argument: arrays and tensors become meta
    tensors of their shape and dtype, numbers 0-d meta tensors (as jit
    traces a literal), containers are converted element by element."""
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    if isinstance(a, (np.ndarray, np.generic)):
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        return torch.empty(a.shape, dtype=dtype, device="meta")
    if isinstance(a, (bool, int, float)):
        return torch.tensor(a, device="meta")
    if isinstance(a, (tuple, list)):
        return type(a)(_meta(x) for x in a)
    return a


@dataclasses.dataclass
class DeviceModel:
    """Roofline parameters used to turn a `Cost` into seconds.

    Defaults are the reference's deliberately conservative CPU-backend
    numbers — for scheduling, only the *relative* pricing between tasks
    matters (the load balancer and the wait-vs-stage test compare
    predicted durations against each other and against
    `StagingCostModel` read times, never against wall time).  Calibrate
    for a real accelerator by passing the card's peak flops and memory
    bandwidth.
    """

    peak_flops: float = 5e10       # sustained flops/s
    mem_bw: float = 2e10           # bytes/s
    launch_overhead: float = 5e-5  # per-dispatch floor, s

    def seconds(self, cost: Cost) -> float:
        return self.launch_overhead + max(cost.flops / self.peak_flops,
                                          cost.bytes / self.mem_bw)


class DurationPredictor:
    """Predict a task body's duration from the aten ops it dispatches —
    without running it on any device (DESIGN.md §11).

    ``predict_duration(fn, args)`` runs `fn` once on meta tensors of the
    arguments' shapes and dtypes under an op counter, and converts the
    counted FLOPs and bytes to seconds through a roofline `DeviceModel`.
    No data is touched and no CUDA context is made, so the call is safe
    on the clock thread; the one-time count is amortized by a
    signature-keyed cache — every later task with the same (callable,
    shapes) signature is a dict probe.  Failures (bodies that read a value,
    as with ``.item()``, or leave torch, as numpy inside does) are cached
    as None, so such a task costs one failed count, not one per task.

    Wire it into an engine so every submitted task with a callable and no
    explicit ``duration=`` is priced before dispatch::

        pred = DurationPredictor()
        eng = Engine(clock, duration_predictor=pred)
        eng.submit("mm", matmul_task, [x, w])   # duration filled by pred
    """

    def __init__(self, device: DeviceModel | None = None):
        self.device = device or DeviceModel()
        self._cache: dict = {}
        self.compiles = 0      # signature misses that ran an op count
        self.hits = 0          # served from the signature cache

    # -- signature ------------------------------------------------------
    def signature(self, fn, args) -> tuple:
        return (stable_fn_key(fn), arg_signature(args))

    # -- prediction -----------------------------------------------------
    def predict_cost(self, fn, args) -> Cost | None:
        """Cached `Cost` for calling ``fn(*args)`` (None when the body
        cannot run on meta tensors)."""
        key = self.signature(fn, args)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.compiles += 1
        try:
            meta_args = [_meta(a) for a in args]
            counter = _OpCounter()
            with torch.no_grad(), counter:
                fn(*meta_args)
            cost = counter.cost
        except Exception:  # noqa: BLE001 — unpredictable body
            cost = None
        self._cache[key] = cost
        return cost

    def predict_duration(self, fn, args) -> float | None:
        """Predicted seconds for ``fn(*args)`` under the device model, or
        None when the body cannot be priced.  This is the `duration=`
        feed: `Engine.submit` calls it for tasks with a callable and no
        explicit duration when a predictor is attached."""
        cost = self.predict_cost(fn, args)
        if cost is None:
            return None
        return self.device.seconds(cost)

    def metrics(self) -> dict:
        return {
            "signatures": len(self._cache),
            "compiles": self.compiles,
            "hits": self.hits,
        }

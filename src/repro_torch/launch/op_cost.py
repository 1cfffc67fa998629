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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.task import arg_signature, stable_fn_key

_aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    """FLOPs and bytes of one call (a single-device eager body issues no
    collectives, so the reference's collective fields have no
    counterpart)."""

    flops: float = 0.0
    bytes: float = 0.0


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
          "transpose_", "t_", "as_strided_", "resize_", "set_"}

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


class _OpCounter(TorchDispatchMode):
    """Adds each dispatched aten op's FLOPs and bytes to `cost`."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in _VIEWS:
            return out
        outs = list(_tensors(out))
        in_bytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.cost.bytes += in_bytes + sum(_nbytes(t) for t in outs)
        if func in _MATMUL:
            self.cost.flops += (2.0 * outs[0].numel()
                                * _contracted(func, args))
        elif name.rstrip("_") in _REDUCTIONS:
            self.cost.flops += sum(_nbytes(t) for t in _tensors(args)) / 4.0
        elif name not in _FREE:
            self.cost.flops += sum(t.numel() for t in outs)
        return out


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

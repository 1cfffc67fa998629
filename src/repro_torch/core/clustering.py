"""Device-native task clustering: vmap-bundling of small torch tasks.

The counterpart of the JAX package's `repro/core/clustering.py`.  The
paper's clustering (§3.13) amortizes batch-scheduler submission overhead
by bundling small jobs.  On an accelerator the analogous per-task cost is
*dispatch + kernel launch* of many small computations; the adaptation
fuses ready tasks that share a callable and argument shapes into ONE
batched device call via `torch.func.vmap` — one launch per op for the
whole bundle, full-width compute.

Two consumers share the bundle-execution core in this module
(`execute_bundle` + `vmap_signature`):

  * `VmapClusteringProvider` — a provider for simulated/engine-driven runs:
    bundles form on the clock thread and execute inline (works under
    `SimClock`).
  * `DeviceExecutorPool` (`repro_torch.core.devicepool`, DESIGN.md §11) —
    the real pool behind `FalkonService(pool=...)`: bundles execute on a
    dispatcher thread and measured completions re-enter through
    `Clock.post_release`.

Every bundle runs on an explicit device: numpy arguments are copied to it
(one host-to-device copy per stacked argument per bundle, and one per
shared argument), and singletons and the per-task fallback run on the same
device.  Every path brings its tensor results back to the host before its
timer stops (a CUDA launch returns before the card is done), so a task's
output lies on the host however wide its bundle was, and a downstream
stage fed by a mix of bundled and singleton outputs still fuses.

Signature identity is GC-safe: callables are keyed through
`repro_torch.core.task.stable_fn_key`, never raw ``id(fn)`` — a collected
callable's address can be reused by a new function, and an id-keyed bundle
or vmap cache would then silently fuse (or run) the wrong callable.

benchmarks/vmap_clustering.py and benchmarks/device_batching.py (and the
port's `repro_torch.benchmarks.device_batching`) measure the amortization
exactly like the paper's Fig 6 measures PBS-overhead amortization.
"""
from __future__ import annotations

from time import perf_counter
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.metrics import StreamStat
from repro_torch.core.providers import Provider
from repro_torch.core.simclock import Clock
from repro_torch.core.task import (Task, arg_signature, execute_task,
                                   stable_fn_key)
from repro_torch.device import resolve_device


def vmap_signature(fn: Callable, args: list) -> tuple:
    """Tasks sharing this signature can be fused into one vmapped call.

    The callable component is a `stable_fn_key` serial (GC-safe), not
    ``id(fn)``; the argument component is the structural
    `arg_signature` (shapes + dtypes, and a tensor's device), so tasks
    with the same callable but unstackable argument shapes land in
    different bundles instead of failing the stack at execution time."""
    return (stable_fn_key(fn), arg_signature(args))


def resolve_args(task) -> list:
    """Argument values of a dispatched task (futures are resolved)."""
    return [a.get() if hasattr(a, "get") and hasattr(a, "on_done") else a
            for a in task.args]


def _to_device(a, device: torch.device):
    """A numpy array or tensor argument on `device`; other values as given.
    The array is copied first: `torch.from_numpy` takes neither a read-only
    nor a byte-swapped array."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.array(a)).to(device)
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return a


def _sync(device: torch.device) -> None:
    """Wait for the current stream's work on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _tree_map(f, tree):
    """`f` over the tensors of a result nested in tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(f, x) for x in tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(f, v)) for k, v in tree.items())
    return tree


def _has_tensor(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    if isinstance(tree, (tuple, list)):
        return any(_has_tensor(x) for x in tree)
    if isinstance(tree, dict):
        return any(_has_tensor(v) for v in tree.values())
    return False


def _split_result(results, n: int) -> list:
    """Un-batch a vmapped call's output tree into n per-task results."""
    if not _has_tensor(results):
        return [results] * n
    return [_tree_map(lambda leaf, i=i: leaf[i], results) for i in range(n)]


def _stack(items: list, device: torch.device) -> torch.Tensor:
    if all(isinstance(a, np.ndarray) for a in items):
        return torch.from_numpy(np.stack(items)).to(device)  # one h2d copy
    return torch.stack([torch.as_tensor(a).to(device) for a in items])


def execute_bundle(fn: Callable, tasks: list, vmapped_cache: dict,
                   device="cuda"):
    """Run same-signature tasks as one vmapped call on `device`.

    Returns ``(results, exec_s, n_fused)``: `results` is a per-task list
    of ``(ok, value, error)`` aligned with `tasks`, `exec_s` the measured
    wall seconds of the execution (the fused call up to its output's copy
    to the host, or the sum of per-task executions, each up to its
    output's copy to the host, on the fallback path), and `n_fused` how many tasks went through the batched
    call (0 when it was not used).  Fault checks run per task first — a
    failing check fails only that task and excludes it from the batch.
    Any error in the fused path (unstackable args, non-vmappable body, all
    arguments shared) degrades to per-task execution, never to a lost
    completion.

    `device` is resolved with `repro_torch.device.resolve_device`: the
    default ``"cuda"`` raises without a card.  `vmapped_cache` maps
    ``(stable_fn_key, in_dims)`` to ``torch.func.vmap(fn)``.
    """
    device = resolve_device(device)
    n = len(tasks)
    results: list = [None] * n
    live: list[int] = []
    for i, t in enumerate(tasks):
        chk = getattr(t, "fault_check", None)
        if chk is not None:
            try:
                chk(t)
            except BaseException as err:  # noqa: BLE001 — per-task failure
                results[i] = (False, None, err)
                continue
        live.append(i)
    if not live:
        return results, 0.0, 0
    if len(live) == 1:
        i = live[0]
        t0 = perf_counter()
        results[i] = _execute_unchecked(tasks[i], device)
        return results, perf_counter() - t0, 0
    t0 = perf_counter()
    try:
        arg_lists = [resolve_args(tasks[i]) for i in live]
        n_args = len(arg_lists[0])
        # args identical across the bundle broadcast (in_dims=None)
        # instead of being stacked — no 256x weight copies
        shared = [all(al[i] is arg_lists[0][i] for al in arg_lists)
                  for i in range(n_args)]
        in_dims = tuple(None if s else 0 for s in shared)
        stacked = [_to_device(arg_lists[0][i], device) if shared[i]
                   else _stack([al[i] for al in arg_lists], device)
                   for i in range(n_args)]
        vkey = (stable_fn_key(fn), in_dims)
        vfn = vmapped_cache.get(vkey)
        if vfn is None:
            vfn = torch.func.vmap(fn, in_dims=in_dims)
            vmapped_cache[vkey] = vfn
        out = _tree_map(lambda x: x.cpu(), vfn(*stacked))  # one d2h copy
        for i, r in zip(live, _split_result(out, len(live))):
            results[i] = (True, r, None)
        return results, perf_counter() - t0, len(live)
    except BaseException:  # noqa: BLE001 — degrade to per-task execution
        t0 = perf_counter()
        for i in live:
            results[i] = _execute_unchecked(tasks[i], device)
        return results, perf_counter() - t0, 0


def _execute_unchecked(task, device: torch.device):
    """`execute_task` minus the fault check (already run by the bundle),
    with numpy arguments placed on `device`, the result's tensors copied to
    the host, as a fused bundle's are, and the device synchronized before
    returning."""
    fn = getattr(task, "fn", None)
    if fn is None:
        return True, getattr(task, "sim_value", None), None
    try:
        value = fn(*[_to_device(a, device) for a in resolve_args(task)])
        value = _tree_map(lambda x: x.cpu(), value)
        _sync(device)
        return True, value, None
    except BaseException as err:  # noqa: BLE001 — engine handles retries
        return False, None, err


class VmapClusteringProvider(Provider):
    """Bundle ready tasks with identical (callable, shapes) signatures into a
    single vmapped execution on `device`.  Falls back to per-task execution
    for singletons or non-batchable tasks.

    Bundles key on the task's user `vmap_key` *and* the structural
    `vmap_signature` — the signature already embeds the callable's stable
    identity, so there is exactly one level of keying.  Measured execution
    seconds are recorded per task into bounded `StreamStat`s (`io_stat`,
    `run_stat`) with the same meaning as the real pools' metrics
    (DESIGN.md §10), so singleton fallbacks show up in throughput metrics
    instead of vanishing.
    """

    name = "vmap-cluster"

    def __init__(self, clock: Clock, window: float = 0.0,
                 max_bundle: int = 1024, device="cuda"):
        self.clock = clock
        self.window = window
        self.max_bundle = max_bundle
        self.device = resolve_device(device)
        self._pending: dict[Any, list] = {}
        self._flush_scheduled = False
        self.bundles_executed = 0
        self.tasks_executed = 0
        self.fused_tasks = 0
        self._vmapped_cache: dict = {}
        # measured execution seconds per task, same shape as the pool
        # metrics (io is zero here: no staging path on this provider)
        self.io_stat = StreamStat(cap=256)
        self.run_stat = StreamStat(cap=256)

    def submit(self, task: Task, when_done: Callable) -> None:
        if task.fn is None:
            t0 = perf_counter()
            ok, v, e = execute_task(task)
            self._observe(perf_counter() - t0)
            self.tasks_executed += 1
            when_done(ok, v, e)
            return
        if task.vmap_key is None:
            # a measured singleton on the device, as the pool runs one
            [(ok, v, e)], exec_s, _ = execute_bundle(
                task.fn, [task], self._vmapped_cache, self.device)
            self._observe(exec_s)
            self.tasks_executed += 1
            when_done(ok, v, e)
            return
        key = (task.vmap_key, vmap_signature(task.fn, resolve_args(task)))
        bucket = self._pending.get(key)
        if bucket is None:
            self._pending[key] = bucket = []
        bucket.append((task, when_done))
        if len(bucket) >= self.max_bundle:
            self._flush_key(key)
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            self.clock.schedule(self.window, self.flush)

    def _observe(self, run_s: float, io_s: float = 0.0) -> None:
        now = self.clock.now()
        self.io_stat.observe(now, io_s)
        self.run_stat.observe(now, run_s)

    def flush(self):
        self._flush_scheduled = False
        for key in list(self._pending):
            self._flush_key(key)

    def _flush_key(self, key):
        bundle = self._pending.pop(key, [])
        if not bundle:
            return
        self.bundles_executed += 1
        self.tasks_executed += len(bundle)
        tasks = [t for t, _ in bundle]
        results, exec_s, n_fused = execute_bundle(
            tasks[0].fn, tasks, self._vmapped_cache, self.device)
        self.fused_tasks += n_fused
        per_task = exec_s / max(1, len(bundle))
        for (t, cb), (ok, v, e) in zip(bundle, results):
            self._observe(per_task)
            cb(ok, v, e)

    def metrics(self) -> dict:
        """Bounded snapshot — safe at any task count."""
        return {
            "tasks": self.tasks_executed,
            "bundles": self.bundles_executed,
            "fused_tasks": self.fused_tasks,
            "io_s": self.io_stat.summary(),
            "run_s": self.run_stat.summary(),
        }

"""Named spans at the model's layer boundaries, in the `torch.profiler` trace.

`span(name)` opens `torch.profiler.record_function(name)` while the profiler
records.  The range lands in the Chrome trace as a `user_annotation` on the
host thread, on the profiler's clock, which is also the clock of the
device's kernels, copies and sets: every CUDA call made inside the range
nests in it, and CUPTI's correlation id ties each device op to its call.
So a device op, or the idle gap it ends, belongs to the spans that held
its launch.  A span's parent is the span that encloses it on the same
thread; a step's root span (`repro.prefill`, `repro.decode`) holds all of
its work.

While the profiler is off, `span` checks the profiler's flag and returns
one shared no-op context.  It never enters `record_function` then: an
enter and exit costs ~13 us even with no profiler running, and a decode
step opens several hundred spans.  The profiler being on is the only
switch.

The names are fixed, so that `key_averages()` and the benchmark group by
them: `repro.prefill`, `repro.decode`, `repro.embed`, `repro.blocks`,
`repro.mixer`, `repro.ffn`, `repro.moe`, `repro.moe.{route,experts,combine}`,
`repro.attn.{qkv,core,out}`,
`repro.mamba.{in_proj,conv,gates,scan,state,out}`, `repro.final_norm`,
`repro.logits`, `repro.logits.table`, `repro.argmax`.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

PREFIX = "repro."

_OFF = contextlib.nullcontext()
# whether the profiler records: the spans' switch, and the MoE counters'
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that is a `record_function(name)` range while the profiler
    records, and a no-op otherwise."""
    return record_function(name) if recording() else _OFF

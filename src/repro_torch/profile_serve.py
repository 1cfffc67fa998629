"""Where the time goes when the port serves: prefill and decode, profiled.

Times each phase without the profiler (host clock after a synchronize), then
runs it again under `torch.profiler` for the device side: the device
milliseconds of the work launched inside each of the port's `repro.*` spans
(`models/spans.py`; a span's time holds its children's, so `repro.decode`
holds the whole step and `repro.mixer` every layer's mixer), kernel
launches, and the kernels that take the most device time, all a step and
all from the one profile.
The cell is `chip_smoke.py`'s: a full-width model (`--arch`, qwen2-1.5b
by default; `--max-repeats N` caps each layer group's repeats, as
`serve.py`'s flag does), bf16, batch 4 x 2048 prompt tokens (384 and
the 1500 encoder frames for whisper-large-v3, whose prefill includes its
encoder); decode is profiled over 8 steps.  Prints one JSON line per
phase.  Needs a CUDA card.

Run:  PYTHONPATH=src python -m repro_torch.profile_serve [--arch <one of
          registry.ARCH_NAMES>] [--max-repeats N]
"""
from __future__ import annotations

import argparse
import bisect
import functools
import itertools
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import serve
from repro_torch.configs import registry
from repro_torch.device import device_memory, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype
from repro_torch.models.params import init_tree
from repro_torch.models.spans import PREFIX
from repro_torch.train.steps import make_prefill_step, make_serve_step

BATCH, STEPS = 4, 8


def _wall_ms(fn, n=1) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def span_device_ms(events, n: int) -> dict:
    """{span: device ms a step}: the device time of the ops launched inside
    each `repro.*` span, summed over `n` steps.  A CUDA call (`cu*` on the
    host) belongs to every span whose host range holds its start, and
    brings the device ops that share its correlation id.  By time, on the
    one host thread that serves: the profiler's own `device_time_total`
    counts only the work linked to an ATen op, which leaves out the
    hand-written kernels, launched through ctypes."""
    dev = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(PREFIX):
            dev[e.id] = dev.get(e.id, 0.0) + e.time_range.elapsed_us()
    calls = sorted((e.time_range.start, dev[e.id]) for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith("cu") and e.id in dev)
    starts = [t for t, _ in calls]
    upto = list(itertools.accumulate((us for _, us in calls), initial=0.0))
    out = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX):
            i = bisect.bisect_left(starts, e.time_range.start)
            j = bisect.bisect_left(starts, e.time_range.end)
            out[e.name] = out.get(e.name, 0.0) + (upto[j] - upto[i]) / 1e3 / n
    return dict(sorted(out.items()))


def _breakdown(fn, n, wall_ms) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    # the profiler also draws each span on the device's timeline, from its
    # first op to its last: not a kernel
    kernels = sorted((e for e in evs if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(PREFIX)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    launches = sum(e.count for e in evs if e.key.startswith(("cudaLaunch", "cuLaunch")))
    return {"wall_ms": wall_ms, "launches": launches / n,
            "span_device_ms": span_device_ms(prof.events(), n),
            "top_kernels_ms": [[e.key[:70], e.self_device_time_total / 1e3 / n]
                               for e in kernels[:8]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=registry.ARCH_NAMES)
    ap.add_argument("--max-repeats", type=int, default=None,
                    help="cap every layer group's repeats (widths stay)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = serve.served_config(args.arch, args.max_repeats, device_memory(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_tree(T.build_descriptors(cfg), gen, dev, dtype=compute_dtype(cfg))
    B, P = BATCH, serve.default_prompt_len(cfg)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    enc = (torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen, device=dev)
           if cfg.enc_dec else None)
    serve.serve(cfg, batch=B, prompt_len=P, new_tokens=2, device=dev,
                params=params, prompts=prompts, enc_feats=enc)    # warm-up

    with torch.no_grad():
        prefill = functools.partial(make_prefill_step(cfg), params,
                                    {"tokens": prompts, "enc_feats": enc})
        out = {"prefill": _breakdown(prefill, 1, _wall_ms(prefill, 3))}
        logits, caches = prefill()
        caches = serve.grow_caches(caches, P, P + 2 * STEPS)
        step = make_serve_step(cfg)
        state = {"tok": torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None], "pos": P}

        def decode():
            state["tok"], _ = step(params, caches, state["tok"], state["pos"])
            state["pos"] += 1

        out["decode_step"] = _breakdown(decode, STEPS, _wall_ms(decode, STEPS))
    for phase, nums in out.items():
        print(json.dumps({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
                          "batch": B, "prompt_len": P, **nums}))
    return out


if __name__ == "__main__":
    main()

"""Serve a model: prefill a batch of prompts, then decode greedily.

The port's counterpart of `examples/serve_lm.py`, at full width by default,
with bf16 compute and prefill through the CUDA kernels (`use_pallas=True`):
flash attention in every GQA attention layer (whisper-large-v3's encoder
and decoder self-attention included; cross-attention stays plain, as in
the reference), the selective scan for falcon-mamba-7b, the RG-LRU scan for
recurrentgemma-9b (deepseek-v2-236b's MLA reaches no kernel, as in the
reference).  The weights are random, drawn from a seeded `torch.Generator`
on the device; they are stored once in the compute dtype, which rounds
exactly as the JAX package's per-use cast of f32 weights does (the few
leaves that package reads in f32 stay f32).  An encoder-decoder
(whisper-large-v3) also draws its (batch, enc_frames, d_model) f32 frame
embeddings from that generator, as `examples/serve_lm.py` draws them; its
prompt defaults to 384 tokens, so that with 64 new ones the decoder sees
the published model's 448 positions.

`--max-repeats N` caps every layer group's repeats at N, widths unchanged.
A config whose weights alone do not fit in the card's memory raises before
they are drawn: deepseek-v2-236b needs 471 GB in bf16, and
`--max-repeats 4` (1 dense + 4 MoE layers, 34.6 GB) fits one H100.

Run:  PYTHONPATH=src python -m repro_torch.serve [--arch <one of
          registry.ARCH_NAMES>] [--max-repeats N] [--batch 4]
          [--prompt-len 2048, 384 for whisper-large-v3] [--new-tokens 64]
          [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch
import torch.nn.functional as F

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.device import device_memory, resolve_device, synchronize
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype
from repro_torch.models.params import init_tree, is_desc, tree_leaves
from repro_torch.train.steps import make_prefill_step, make_serve_step


ATTN_CACHE_KEYS = ("k", "v", "pos", "c_kv", "k_rope")
PROMPT_LEN, ENC_DEC_PROMPT_LEN = 2048, 384


def default_prompt_len(cfg: ModelConfig) -> int:
    return ENC_DEC_PROMPT_LEN if cfg.enc_dec else PROMPT_LEN


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of the weights as `init_tree` stores them for serving: the
    compute dtype, but f32 for the leaves read in f32."""
    size = torch.empty((), dtype=compute_dtype(cfg)).element_size()
    return sum(math.prod(d.shape) * (4 if d.f32 else size)
               for d in tree_leaves(T.build_descriptors(cfg), is_leaf=is_desc))


def served_config(arch: str, max_repeats: int | None = None,
                  capacity_bytes: int | None = None) -> ModelConfig:
    """The full-width config of `arch` with the kernels on, each layer
    group's repeats capped at `max_repeats`; raises if its weights alone
    exceed `capacity_bytes` (the card's memory)."""
    cfg = registry.get_config(arch)
    if max_repeats is not None:
        cfg = registry.cut_depth(cfg, max_repeats)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    need = weight_bytes(cfg)
    if capacity_bytes is not None and need > capacity_bytes:
        raise ValueError(
            f"{arch} with {cfg.n_layers} layers needs {need / 1e9:.1f} GB for its "
            f"{cfg.compute_dtype} weights alone, more than the device's "
            f"{capacity_bytes / 1e9:.1f} GB; cut the depth with --max-repeats N")
    return cfg


def grow_caches(caches, cur_len: int, total: int):
    """Pad the sequence dim (dim 2 of the stacked (reps, B, T, ...) caches)
    of the self-attention caches (each layer's `mixer`: `k`, `v`, ring
    positions `pos`, MLA's latent `c_kv` and `k_rope`) from the prompt
    length to the full generation length; ring position slots are padded
    with the invalid marker -1.  A ring shorter than the prompt, the
    fixed-size recurrent states and conv tails, and the cross-attention
    caches (the encoder's keys, enc_frames long) stay as they are, whatever
    their lengths."""

    def grow_layer(layer):          # {"mixer": {...}, and "cross": {...}}
        mixer = {k: pad(v) if k in ATTN_CACHE_KEYS else v
                 for k, v in layer["mixer"].items()}
        return {**layer, "mixer": mixer}

    def grow(group):                # {"l0": layer, "l1": layer, ...}
        return {name: grow_layer(layer) for name, layer in group.items()}

    def pad(x):
        if x.shape[2] != cur_len:
            return x
        widths = [0, 0] * (x.dim() - 3) + [0, total - cur_len]
        return F.pad(x, widths, value=-1 if x.dtype == torch.int32 else 0)

    return [grow(g) for g in caches]


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, new_tokens: int,
          device="cuda", params=None, prompts=None, enc_feats=None) -> dict:
    """Prefill `batch` prompts of `prompt_len` tokens, decode `new_tokens`.
    An encoder-decoder takes `enc_feats` (batch, enc_frames, d_model), drawn
    after the weights and prompts when not given.

    Returns the generated tokens (batch, new_tokens) and the timings:
    prefill ms, decode ms per step, and tokens/s (generated tokens over the
    prefill and decode time).  Times are taken after the device finished.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if params is None:
        params = init_tree(T.build_descriptors(cfg), gen, dev, dtype=compute_dtype(cfg))
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                generator=gen, device=dev)
    inputs = {"tokens": prompts}
    if cfg.enc_dec:
        if enc_feats is None:
            enc_feats = torch.randn((batch, cfg.enc_frames, cfg.d_model),
                                    generator=gen, device=dev)
        inputs["enc_feats"] = enc_feats
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    total = prompt_len + new_tokens

    synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = make_prefill_step(cfg)(params, inputs)
    caches = grow_caches(caches, prompt_len, total)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    step = make_serve_step(cfg)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        tok, caches = step(params, caches, tok, prompt_len + i)
        out.append(tok)
    synchronize(dev)
    t_decode = time.perf_counter() - t0
    steps = max(1, new_tokens - 1)
    return {
        "tokens": torch.cat(out, dim=1),
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_token": t_decode * 1e3 / steps,
        "tokens_per_s": batch * new_tokens / (t_prefill + t_decode),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=registry.ARCH_NAMES)
    ap.add_argument("--max-repeats", type=int, default=None,
                    help="cap every layer group's repeats (widths stay)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help=f"default {PROMPT_LEN}, {ENC_DEC_PROMPT_LEN} for an encoder-decoder")
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = served_config(args.arch, args.max_repeats, device_memory(dev))
    prompt_len = args.prompt_len or default_prompt_len(cfg)
    res = serve(cfg, batch=args.batch, prompt_len=prompt_len,
                new_tokens=args.new_tokens, device=dev)
    print(json.dumps({"arch": cfg.name, "n_layers": cfg.n_layers, "prompt_len": prompt_len,
                      **{k: v for k, v in res.items() if k != "tokens"}}))
    print("generated token ids (first sequence):", res["tokens"][0, :12].tolist())
    return res


if __name__ == "__main__":
    main()

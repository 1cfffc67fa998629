"""Plain reference of a dense GQA decoder (Qwen2: arXiv:2407.10671).

x = embed(tokens); per layer: x += Wo attn(RoPE(Wq h + bq), RoPE(Wk h + bk),
Wv h + bv) with h = RMSNorm(x), causal, grouped kv heads; x += W2 (silu(W1
h) * W3 h) with h = RMSNorm(x); logits = RMSNorm(x) E^T (E tied or not).
RoPE turns the two halves of each head (`rotate_half`) by position / theta
^ (2i / head_dim).  f32 throughout, TF32 off, attention by blocks of query
rows so that it fits.  Imports nothing of the port.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import exact_f32, layer, lin, rms_norm

Q_BLOCK = 1024


def shapes(conf: dict) -> dict:
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {"d": d, "h": h, "hkv": conf["num_key_value_heads"],
            "dh": conf.get("head_dim", d // h), "ff": conf["intermediate_size"],
            "vocab": conf["vocab_size"], "layers": conf["num_hidden_layers"]}


def matmul_params(conf: dict) -> int:
    """Parameters that enter a product per token, embedding and
    unembedding tables left out (norm scales and biases too)."""
    s = shapes(conf)
    attn = s["d"] * (s["h"] + 2 * s["hkv"]) * s["dh"] + s["h"] * s["dh"] * s["d"]
    return s["layers"] * (attn + 3 * s["d"] * s["ff"])


def attention_shape(conf: dict):
    """(attention layers, Hq, Hkv, head_dim)."""
    s = shapes(conf)
    return s["layers"], s["h"], s["hkv"], s["dh"]


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of prefilling B prompts of S tokens with logits at the
    last position: 2 N per token (N: `matmul_params`), the causal QK^T and
    PV products of each attention layer (4 Hq head_dim per attended pair,
    `repro_torch.train.model_flops`'s term), and 2 d vocab per prompt."""
    n_attn, hq, _, dh = attention_shape(conf)
    pairs = S * (S + 1) // 2
    return (2.0 * matmul_params(conf) * B * S + 4.0 * n_attn * hq * dh * pairs * B
            + 2.0 * conf["hidden_size"] * conf["vocab_size"] * B)


def _rope(x, theta: float):
    """x (B, S, H, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[None, :, None], ang.sin().float()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal attention, q (B, S, H, D), k and v (B, S, Hkv, D), f32, by
    blocks of query rows."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    k, v = k.repeat_interleave(g, 2).transpose(1, 2), v.repeat_interleave(g, 2).transpose(1, 2)
    q = q.transpose(1, 2) / math.sqrt(D)
    out = torch.empty_like(q)
    for r0 in range(0, S, Q_BLOCK):
        r1 = min(S, r0 + Q_BLOCK)
        s = q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(r1, device=q.device)[None] > rows, float("-inf"))
        out[:, :, r0:r1] = torch.softmax(s, -1) @ v[:, :, :r1]
    return out.transpose(1, 2)


def _block(conf: dict, p: dict, x, control):
    """One decoder layer on x (B, S, d), f32."""
    s = shapes(conf)
    eps = conf["rms_norm_eps"]
    B, S, _ = x.shape
    a = p["mixer"]
    h = rms_norm(x, a["norm"]["scale"], eps)
    proj = {}
    for n, heads in (("q", s["h"]), ("k", s["hkv"]), ("v", s["hkv"])):
        w = a["w" + n].reshape(s["d"], heads * s["dh"])
        y = lin(h, w, control).view(B, S, heads, s["dh"])
        proj[n] = y + a["b" + n] if "b" + n in a else y
    q = _rope(proj["q"], conf["rope_theta"])
    k = _rope(proj["k"], conf["rope_theta"])
    o = _attention(q, k, proj["v"]).reshape(B, S, s["h"] * s["dh"])
    x = x + lin(o, a["wo"].reshape(s["h"] * s["dh"], s["d"]), control)
    f = p["ffn"]
    h = rms_norm(x, f["norm"]["scale"], eps)
    u = torch.nn.functional.silu(lin(h, f["w1"], control)) * lin(h, f["w3"], control)
    return x + lin(u, f["w2"], control)


def _unembed_table(conf: dict, params: dict):
    return params["embed" if conf["tie_word_embeddings"] else "unembed"]["table"]


def hidden(conf: dict, params: dict, tokens, control: bool = False):
    """The final norm's output (B, S, d), f32, of `tokens` (B, S).
    `control` computes every product in float8 (`common.lin`)."""
    with exact_f32():
        x = params["embed"]["table"][tokens].float()
        group = params["blocks"][0]["l0"]
        for r in range(shapes(conf)["layers"]):
            x = _block(conf, layer(group, r), x, control)
        return rms_norm(x, params["final_norm"]["scale"], conf["rms_norm_eps"])


def logits(conf: dict, params: dict, x, control: bool = False):
    """f32 logits (..., vocab) of final-norm outputs x (..., d)."""
    with exact_f32():
        return lin(x, _unembed_table(conf, params)[:conf["vocab_size"]].t(), control)


def forward(conf: dict, params: dict, tokens, positions, control: bool = False):
    """f32 logits (B, len(positions), vocab) of `tokens` (B, S) at `positions`."""
    return logits(conf, params, hidden(conf, params, tokens, control)[:, positions], control)

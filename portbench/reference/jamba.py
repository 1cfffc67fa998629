"""Plain reference of AI21-Jamba2-Mini (Jamba: arXiv:2403.19887; the layer
equations of transformers' `modeling_jamba.py`), one card's share of its
experts, as the port runs it.

Layer i is attention where i % attn_layer_period == attn_layer_offset and
Mamba-1 otherwise; its FFN is a mixture of experts where
i % expert_layer_period == expert_layer_offset and a dense SwiGLU
otherwise.  x = embed(tokens); per layer x += mixer(RMSNorm(x)), then
x += FFN(RMSNorm(x)); logits = RMSNorm(x) W_head (untied).

* Mamba: (u, z) = h W_in; u = silu(causal depthwise conv_K(u) + b);
  (ts, B, C) = u W_x; ts, B and C each RMS-normed with a learned scale;
  dt = softplus(ts W_dt + b_dt); A = -exp(A_log); h_t = exp(dt_t A)
  h_{t-1} + dt_t B_t u_t; y_t = C_t . h_t + D u_t; out = (y * silu(z))
  W_out.  No bias on the projections.  The scan is `mamba1.selective_scan`
  (float64, closed form inside chunks).
* Attention: causal, grouped kv heads, no bias and no positional encoding
  at all, `dense_gqa._attention` (blocks of query rows).
* MoE: p = softmax(h W_router) over all `published.num_experts` experts;
  the top `num_experts_per_tok` probabilities used as they are, not
  renormalised; y = sum_e p_e W2_e (silu(W1_e h) * W3_e h) over the chosen
  experts.  No capacity: every assignment counts.

The one departure from `modeling_jamba.py` is the expert share: the file's
`num_experts` experts from `first_held_expert` are held here, and only
their terms are summed (what the other card of the deployment adds is
left out, as in the program).  Every step is f32 with TF32 off; the
control computes every product in float8 (`common.lin`).  Imports nothing
of the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import exact_f32, layer, lin, rms_norm
from portbench.reference.dense_gqa import _attention
from portbench.reference.mamba1 import selective_scan


def shapes(conf: dict) -> dict:
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {"d": d, "h": h, "hkv": conf["num_key_value_heads"], "dh": d // h,
            "ff": conf["intermediate_size"], "eff": conf["intermediate_size"],
            "experts": conf["published"]["num_experts"], "held": conf["num_experts"],
            "first": conf.get("first_held_expert", 0), "k": conf["num_experts_per_tok"],
            "din": conf["mamba_expand"] * d, "n": conf["mamba_d_state"],
            "conv": conf["mamba_d_conv"], "r": conf["mamba_dt_rank"],
            "vocab": conf["vocab_size"], "layers": conf["num_hidden_layers"]}


def period(conf: dict) -> int:
    """Layers in one block of the pattern: the port stacks layer i's
    parameters at `blocks[0]["l{i % period}"][i // period]`."""
    return math.lcm(conf["attn_layer_period"], conf["expert_layer_period"])


def kinds(conf: dict, i: int) -> tuple[str, str]:
    """(mixer, ffn) of layer i: ("attn" | "mamba", "moe" | "dense")."""
    attn = i % conf["attn_layer_period"] == conf["attn_layer_offset"]
    moe = i % conf["expert_layer_period"] == conf["expert_layer_offset"]
    return ("attn" if attn else "mamba"), ("moe" if moe else "dense")


def _counts(conf: dict) -> dict:
    out = {"attn": 0, "mamba": 0, "moe": 0, "dense": 0}
    for i in range(conf["num_hidden_layers"]):
        for kind in kinds(conf, i):
            out[kind] += 1
    return out


def matmul_params(conf: dict) -> int:
    """Parameters that enter a product per token, embedding and head left
    out: every Mamba, attention and dense FFN projection, the routers, and
    of each MoE layer the experts a token reaches here on average (top-k
    times the held share, held / published experts)."""
    s, n = shapes(conf), _counts(conf)
    mamba = (s["d"] * 2 * s["din"] + s["din"] * (s["r"] + 2 * s["n"]) + s["r"] * s["din"]
             + s["din"] * s["d"])
    attn = s["d"] * (s["h"] + 2 * s["hkv"]) * s["dh"] + s["h"] * s["dh"] * s["d"]
    moe = s["d"] * s["experts"] + s["k"] * s["held"] * 3 * s["d"] * s["eff"] // s["experts"]
    return (n["mamba"] * mamba + n["attn"] * attn + n["dense"] * 3 * s["d"] * s["ff"]
            + n["moe"] * moe)


def attention_shape(conf: dict):
    """(attention layers, Hq, Hkv, head_dim)."""
    s = shapes(conf)
    return _counts(conf)["attn"], s["h"], s["hkv"], s["dh"]


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of prefilling B prompts of S tokens with logits at the
    last position: 2 N per token (N: `matmul_params`), the causal QK^T and
    PV products of each attention layer (4 Hq head_dim per attended pair)
    and 2 d vocab per prompt."""
    n_attn, hq, _, dh = attention_shape(conf)
    pairs = S * (S + 1) // 2
    return (2.0 * matmul_params(conf) * B * S + 4.0 * n_attn * hq * dh * pairs * B
            + 2.0 * conf["hidden_size"] * conf["vocab_size"] * B)


def expert_cost(conf: dict, per_expert, elem_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one call of an MoE layer's expert products,
    `per_expert[e]` assignments to held expert e: 2 d eff for each of the
    three products of each assignment; each held expert that has one or
    more assignments reads its three (d, eff) matrices once, and each
    assignment's row is read in and written out (d each)."""
    s = shapes(conf)
    de = s["d"] * s["eff"]
    rows = sum(per_expert)
    used = sum(1 for c in per_expert if c > 0)
    return 6 * de * rows, elem_bytes * (3 * de * used + 2 * s["d"] * rows)


def _mamba(s: dict, p: dict, h, eps: float, control: bool):
    S = h.shape[1]
    xz = lin(h, p["in_proj"], control)
    u, z = xz[..., :s["din"]], xz[..., s["din"]:]
    up = F.pad(u, (0, 0, s["conv"] - 1, 0))
    u = F.silu(sum(up[:, i:i + S] * p["conv_w"][i] for i in range(s["conv"])) + p["conv_b"])
    proj = lin(u, p["x_proj"], control)
    ts = rms_norm(proj[..., :s["r"]], p["dt_norm"], eps)
    Bm = rms_norm(proj[..., s["r"]:s["r"] + s["n"]], p["b_norm"], eps)
    Cm = rms_norm(proj[..., s["r"] + s["n"]:], p["c_norm"], eps)
    dt = F.softplus(lin(ts, p["dt_proj"], control) + p["dt_bias"])
    y = selective_scan(u, dt, -torch.exp(p["A_log"]), Bm, Cm) + u * p["D"]
    return lin(y * F.silu(z), p["out_proj"], control)


def _attn(s: dict, p: dict, h, control: bool):
    B, S, _ = h.shape
    q, k, v = (lin(h, p["w" + n].reshape(s["d"], heads * s["dh"]), control)
               .view(B, S, heads, s["dh"])
               for n, heads in (("q", s["h"]), ("k", s["hkv"]), ("v", s["hkv"])))
    o = _attention(q, k, v).reshape(B, S, s["h"] * s["dh"])
    return lin(o, p["wo"].reshape(s["h"] * s["dh"], s["d"]), control)


def _swiglu(p: dict, h, control: bool):
    return lin(F.silu(lin(h, p["w1"], control)) * lin(h, p["w3"], control), p["w2"], control)


def moe(conf: dict, p: dict, h, control: bool = False):
    """The MoE FFN's output on h (..., d), f32: the held experts' terms."""
    s = shapes(conf)
    flat = h.reshape(-1, s["d"])
    probs = torch.softmax(lin(flat, p["router"], control), -1)
    top_w, top_i = torch.topk(probs, s["k"], -1)
    y = torch.zeros_like(flat)
    for j in range(s["held"]):
        chosen = top_i == s["first"] + j                        # (T, K)
        rows = chosen.any(-1).nonzero()[:, 0]
        if rows.numel():
            w = (top_w * chosen).sum(-1)[rows, None]
            e = {n: p[n][j] for n in ("w1", "w2", "w3")}
            y[rows] += w * _swiglu(e, flat[rows], control)
    return y.view(h.shape)


def hidden(conf: dict, params: dict, tokens, control: bool = False):
    """The final norm's output (B, S, d), f32, of `tokens` (B, S).
    `control` computes every product in float8 (`common.lin`)."""
    s = shapes(conf)
    eps, per = conf["rms_norm_eps"], period(conf)
    group = params["blocks"][0]
    with exact_f32():
        x = params["embed"]["table"][tokens].float()
        for i in range(s["layers"]):
            p = layer(group[f"l{i % per}"], i // per)
            mixer, ffn = kinds(conf, i)
            a = p["mixer"]
            h = rms_norm(x, a["norm"]["scale"], eps)
            x = x + (_attn(s, a, h, control) if mixer == "attn" else _mamba(s, a, h, eps, control))
            f = p[ffn if ffn == "moe" else "ffn"]
            h = rms_norm(x, f["norm"]["scale"], eps)
            x = x + (moe(conf, f, h, control) if ffn == "moe" else _swiglu(f, h, control))
        return rms_norm(x, params["final_norm"]["scale"], eps)


def logits(conf: dict, params: dict, x, control: bool = False):
    """f32 logits (..., vocab) of final-norm outputs x (..., d)."""
    table = params["embed" if conf["tie_word_embeddings"] else "unembed"]["table"]
    with exact_f32():
        return lin(x, table[:conf["vocab_size"]].t(), control)


def forward(conf: dict, params: dict, tokens, positions, control: bool = False):
    """f32 logits (B, len(positions), vocab) of `tokens` (B, S) at `positions`."""
    return logits(conf, params, hidden(conf, params, tokens, control)[:, positions], control)

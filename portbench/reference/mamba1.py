"""Plain reference of a Mamba-1 language model (Gu & Dao, arXiv:2312.00752;
falcon-mamba-7b's widths, arXiv:2410.05355), as the port runs it.

x = embed(tokens); per layer, h = RMSNorm(x), (u, z) = h W_in, u = silu(
causal depthwise conv_K(u) + b), (dt_r, B, C) = u W_x, dt = softplus(dt_r
W_dt + b_dt), A = -exp(A_log); h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t,
y_t = C_t . h_t + D u_t; x += (y * silu(z)) W_out.  logits = RMSNorm(x) E^T.
The scan runs in float64 over chunks of time, in closed form inside each
chunk (the decays as exponentials of cumulative sums), carrying the state
between chunks; every other step is f32 with TF32 off.  Falcon-Mamba's
RMS norms of B, C and dt inside the mixer are not in the port, and not
here (the configuration file lists them).  Imports nothing of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import exact_f32, layer, lin, rms_norm

CHUNK = 64
# exp() of float64 overflows past 709: a chunk whose decay exceeds this is halved
MAX_LOG_DECAY = 600.0


def shapes(conf: dict) -> dict:
    return {"d": conf["hidden_size"], "din": conf["intermediate_size"],
            "n": conf["state_size"], "k": conf["conv_kernel"], "r": conf["time_step_rank"],
            "vocab": conf["vocab_size"], "layers": conf["num_hidden_layers"]}


def matmul_params(conf: dict) -> int:
    """Parameters that enter a product per token (the four projections),
    embedding and unembedding tables left out."""
    s = shapes(conf)
    per = (s["d"] * 2 * s["din"] + s["din"] * (s["r"] + 2 * s["n"]) + s["r"] * s["din"]
           + s["din"] * s["d"])
    return s["layers"] * per


def attention_shape(conf: dict):
    return None


def scan_shape(conf: dict):
    """(scan layers, d_inner, d_state)."""
    s = shapes(conf)
    return s["layers"], s["din"], s["n"]


def prefill_flops(conf: dict, B: int, S: int) -> float:
    """Model FLOPs of prefilling B prompts of S tokens with logits at the
    last position: 2 N per token (N: `matmul_params`) and 2 d vocab per
    prompt; the scan's few operations per state element are not counted."""
    return 2.0 * matmul_params(conf) * B * S + 2.0 * conf["hidden_size"] * conf["vocab_size"] * B


def _scan_chunk(u, dt, A, Bm, Cm, h, bound: float):
    """One chunk in closed form, float64: u, dt (B, L, D); A (D, N); Bm, Cm
    (B, L, N); h (B, D, N) -> (y (B, L, D), h at the chunk's end).  `bound`
    is at least the chunk's largest log-decay; past MAX_LOG_DECAY the chunk
    is halved."""
    if bound > MAX_LOG_DECAY and u.shape[1] > 1:
        m, a = u.shape[1] // 2, -A.min().item()
        halves = [slice(0, m), slice(m, None)]
        ys = []
        for sl in halves:
            b = dt[:, sl].sum(1).max().item() * a
            y, h = _scan_chunk(u[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], h, b)
            ys.append(y)
        return torch.cat(ys, 1), h
    la = torch.cumsum(dt, 1)[..., None] * A                   # (B, L, D, N), <= 0
    w = (dt * u)[..., None] * Bm[:, :, None, :]                # dt_s u_s B_s
    hs = torch.exp(la) * (h[:, None] + torch.cumsum(torch.exp(-la) * w, 1))
    return torch.einsum("bldn,bln->bld", hs, Cm), hs[:, -1]


def selective_scan(u, dt, A, Bm, Cm):
    """y (B, S, D) f32 of the recurrence from h = 0."""
    B, S, D = u.shape
    h = torch.zeros((B, D, A.shape[1]), dtype=torch.float64, device=u.device)
    A = A.double()
    nc = -(-S // CHUNK)
    # each chunk's largest log-decay, read once a layer
    sums = F.pad(dt, (0, 0, 0, nc * CHUNK - S)).view(B, nc, CHUNK, D).sum(2).amax((0, 2))
    bounds = (sums.double() * -A.min()).tolist()
    ys = []
    for c, c0 in enumerate(range(0, S, CHUNK)):
        sl = slice(c0, c0 + CHUNK)
        y, h = _scan_chunk(u[:, sl].double(), dt[:, sl].double(), A, Bm[:, sl].double(),
                           Cm[:, sl].double(), h, bounds[c])
        ys.append(y.float())
    return torch.cat(ys, 1)


def hidden(conf: dict, params: dict, tokens, control: bool = False):
    """The final norm's output (B, S, d), f32, of `tokens` (B, S).
    `control` computes every product in float8 (`common.lin`)."""
    s = shapes(conf)
    eps = conf["rms_norm_eps"]
    with exact_f32():
        x = params["embed"]["table"][tokens].float()
        S = x.shape[1]
        group = params["blocks"][0]["l0"]
        for r in range(s["layers"]):
            p = layer(group, r)["mixer"]
            h = rms_norm(x, p["norm"]["scale"], eps)
            xz = lin(h, p["in_proj"], control)
            u, z = xz[..., :s["din"]], xz[..., s["din"]:]
            up = F.pad(u, (0, 0, s["k"] - 1, 0))
            u = sum(up[:, i:i + S] * p["conv_w"][i] for i in range(s["k"])) + p["conv_b"]
            u = F.silu(u)
            proj = lin(u, p["x_proj"], control)
            dt_r = proj[..., :s["r"]]
            Bm, Cm = proj[..., s["r"]:s["r"] + s["n"]], proj[..., s["r"] + s["n"]:]
            dt = F.softplus(lin(dt_r, p["dt_proj"], control) + p["dt_bias"])
            A = -torch.exp(p["A_log"])
            y = selective_scan(u, dt, A, Bm, Cm) + u * p["D"]
            x = x + lin(y * F.silu(z), p["out_proj"], control)
        return rms_norm(x, params["final_norm"]["scale"], eps)


def logits(conf: dict, params: dict, x, control: bool = False):
    """f32 logits (..., vocab) of final-norm outputs x (..., d)."""
    table = params["embed" if conf["tie_word_embeddings"] else "unembed"]["table"]
    with exact_f32():
        return lin(x, table[:conf["vocab_size"]].t(), control)


def forward(conf: dict, params: dict, tokens, positions, control: bool = False):
    """f32 logits (B, len(positions), vocab) of `tokens` (B, S) at `positions`."""
    return logits(conf, params, hidden(conf, params, tokens, control)[:, positions], control)

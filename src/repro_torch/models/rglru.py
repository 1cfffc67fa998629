"""Griffin / RecurrentGemma RG-LRU recurrent block (recurrentgemma-9b).

Plain PyTorch version of the JAX package's `repro/models/rglru.py`.

Block: x -> (gate branch: GeLU(x W_gate)) * RG-LRU(conv1d(x W_in)) -> W_out.
RG-LRU: r_t = sigmoid(u W_a), i_t = sigmoid(u W_x), a_t = a^(c r_t) with
        a = sigmoid(Lambda), h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t).

The plain path evaluates the recurrence in time chunks with the reference's
associative scan inside each (`ssm.linear_scan`), as the Mamba block does.
With `cfg.use_pallas`, prefill forms a_t and b_t outside the kernel exactly
as the reference does and runs the recurrence through the hand-written kernel
(`repro_torch.kernels.ops.rglru_scan`); decode is one plain step.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, per_shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDesc
from repro_torch.models.ssm import causal_conv, conv_step, linear_scan, n_chunks


def rglru_descs(cfg: ModelConfig):
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    K = r.d_conv
    return {
        "norm": L.norm_descs(cfg),
        "in_x": ParamDesc((d, w), ("embed", "rnn")),
        "in_gate": ParamDesc((d, w), ("embed", "rnn")),
        "conv_w": ParamDesc((K, w), (None, "rnn")),
        "conv_b": ParamDesc((w,), ("rnn",), init="zeros"),
        "gate_a": ParamDesc((w, w), ("rnn", None)),
        "gate_x": ParamDesc((w, w), ("rnn", None)),
        "a_param": ParamDesc((w,), ("rnn",), init="lru_a", f32=True),
        "out_proj": ParamDesc((w, d), ("rnn", "embed")),
    }


def rglru_cache_descs(cfg: ModelConfig, batch: int):
    r = cfg.rglru
    w = r.lru_width or cfg.d_model
    return {
        "state": ParamDesc((batch, w), ("batch", "rnn"), dtype=torch.float32),
        "conv": ParamDesc((batch, r.d_conv - 1, w), ("batch", None, "rnn"),
                          dtype=L.compute_dtype(cfg)),
    }


def recurrence_inputs(a_param, a_gate, x_gate, u, c: float):
    """(a_t, b_t) of h_t = a_t h_{t-1} + b_t, in f32, from the gates' logits
    and the conv output (any leading dims, width last)."""
    log_a = -c * F.softplus(-a_param.float())         # log sigmoid(Lambda), scaled
    log_at = log_a * torch.sigmoid(a_gate.float())
    at = torch.exp(log_at)
    bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12)) \
        * (torch.sigmoid(x_gate.float()) * u.float())
    return at, bt


def rglru_scan(u, a_gate, x_gate, a_param, *, c: float, chunk: int, h0=None):
    """u, a_gate, x_gate: (B, S, W) -> (y, h_final), f32 recurrence."""
    B, S, W = u.shape
    at, bt = recurrence_inputs(a_param, a_gate, x_gate, u, c)
    ch = S // n_chunks(S, chunk)
    h = torch.zeros((B, W), device=u.device) if h0 is None else h0
    ys = []
    for c0 in range(0, S, ch):
        accA, accB = linear_scan(at[:, c0:c0 + ch], bt[:, c0:c0 + ch])
        hs = accA * h[:, None] + accB
        ys.append(hs)
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def apply_rglru(cfg: ModelConfig, p, x, *, mode="prefill", cache=None, pos_t=None):
    """Returns (out, new_cache).

    Train mode is prefill without a cache (`new_cache` is None), through the
    plain chunked scan under autograd.  Decode writes the new state and conv
    tail into `cache` in place (the JAX package returns an updated copy) and
    returns the same dict.
    """
    r = cfg.rglru
    cdt = L.compute_dtype(cfg)
    h = L.apply_norm(cfg, p["norm"], x)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", h, p["in_gate"].to(cdt)), approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", h, p["in_x"].to(cdt))
    u = constrain(u, ("batch", None, "rnn"))

    if mode in ("train", "prefill"):
        if mode == "train" and cfg.use_pallas:
            raise NotImplementedError(L.FORWARD_ONLY.format(kernel="the RG-LRU scan"))
        uc, tail = causal_conv(u, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
        a_gate = torch.einsum("bsw,wv->bsv", uc, p["gate_a"].to(cdt))
        x_gate = torch.einsum("bsw,wv->bsv", uc, p["gate_x"].to(cdt))
        if cfg.use_pallas:
            from repro_torch.kernels import ops as kops
            at, bt = recurrence_inputs(p["a_param"], a_gate, x_gate, uc, r.c)
            h0 = torch.zeros((x.shape[0], at.shape[2]), device=x.device)
            y, h_fin = kops.rglru_scan(at, bt, h0)
        else:
            # local in batch and width: under the dry run's rules each rank
            # scans its own shards
            y, h_fin = per_shard(
                functools.partial(rglru_scan, c=r.c, chunk=r.chunk),
                [("batch", None, "rnn")] * 3 + [("rnn",)],
                [("batch", None, "rnn"), ("batch", "rnn")],
                uc, a_gate, x_gate, p["a_param"])
        out = torch.einsum("bsw,wd->bsd", y.to(cdt) * gate, p["out_proj"].to(cdt))
        return L.residual(x, out), (None if mode == "train" else {"state": h_fin, "conv": tail})

    if cache is None:
        raise ValueError("decode needs a cache")
    uc, window = conv_step(cache["conv"], u, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
    # the gate products sum over the sharded width: each reduced into the
    # state's layout (a no-op outside the dry run)
    a_gate = constrain(torch.einsum("bw,wv->bv", uc, p["gate_a"].to(cdt)), ("batch", "rnn"))
    x_gate = constrain(torch.einsum("bw,wv->bv", uc, p["gate_x"].to(cdt)), ("batch", "rnn"))
    at, bt = recurrence_inputs(p["a_param"], a_gate, x_gate, uc, r.c)
    h_new = at * cache["state"] + bt
    out = torch.einsum("bw,wd->bd", h_new.to(cdt) * gate[:, 0],
                       p["out_proj"].to(cdt))[:, None]
    cache["state"].copy_(h_new)
    cache["conv"].copy_(window[:, 1:])
    return L.residual(x, out), cache

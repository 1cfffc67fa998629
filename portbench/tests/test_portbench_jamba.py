"""The Jamba family against its plain reference, on the CPU at tiny sizes,
in f32: prefill logits, decode through grown caches against one pass over
prompt and served tokens, one card's share of the experts against the
uncut layer, and the adapter's draws."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny_kv  # noqa: E402
from portbench.harness import runner  # noqa: E402
from portbench.harness.spec import load_module  # noqa: E402
from portbench.reference import jamba  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import grow_caches  # noqa: E402

PKG = ROOT / "portbench"
ADAPTER = load_module(PKG / "adapters" / "jamba.py")
# f32 on both sides: the port's blocked and chunked sums against the
# reference's float64 scan and plain products differ by rounding only
# (~1e-6 of the logits' spread); 16 layers deep, 5e-5 leaves 10x room
ATOL, RTOL = 5e-5, 1e-4


def _setup(seed, conf=None, scales=True):
    """(conf, cfg, params) in f32; with `scales`, every norm scale drawn
    away from 1 and the conv bias away from 0, so that each is read."""
    conf = dict(conf or tiny_kv.TINY_JAMBA, torch_dtype="float32")
    cfg = dataclasses.replace(ADAPTER.port_config(conf), compute_dtype="float32")
    cell = type("C", (), {"config": conf})
    params = runner.make_params(cell, ADAPTER, cfg, seed, torch.device("cpu"))
    if scales:
        g = torch.Generator().manual_seed(seed)
        for group in params["blocks"]:
            for lay in group.values():
                for sub in lay.values():
                    for name in ("dt_norm", "b_norm", "c_norm", "conv_b"):
                        if name in sub:
                            sub[name].copy_(torch.rand(sub[name].shape, generator=g) + 0.5)
                    sub["norm"]["scale"].copy_(torch.rand(sub["norm"]["scale"].shape,
                                                          generator=g) + 0.5)
    return conf, cfg, params


@pytest.mark.parametrize("S", [5, 64])
def test_prefill_matches_the_reference_in_f32(S):
    conf, cfg, params = _setup(3)
    toks = torch.randint(0, conf["vocab_size"], (2, S), generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        port, _ = T.prefill(cfg, params, toks)
    want = jamba.forward(conf, params, toks, [S - 1])
    assert torch.allclose(port, want, atol=ATOL, rtol=RTOL), (port - want).abs().max()


def test_decode_through_grown_caches_follows_the_reference():
    """Prefill 16 tokens, grow the caches by 8, decode 6 greedy steps: the
    logits at every served position against the reference's one pass
    over the prompt and the served tokens."""
    conf, cfg, params = _setup(4)
    P, n = 16, 7
    toks = torch.randint(0, conf["vocab_size"], (2, P), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, caches = T.prefill(cfg, params, toks)
        caches = grow_caches(caches, P, P + 8)
        outs, seq = [logits[:, -1]], toks
        for i in range(n - 1):
            tok = outs[-1].argmax(-1)[:, None]
            seq = torch.cat([seq, tok], 1)
            lo, caches = T.decode_step(cfg, params, caches, tok.to(torch.int32), P + i)
            outs.append(lo[:, -1])
    want = jamba.forward(conf, params, seq, list(range(P - 1, P - 1 + n)))
    got = torch.stack(outs, 1)
    assert torch.allclose(got, want, atol=ATOL, rtol=RTOL), (got - want).abs().max()


def test_two_shares_of_the_experts_add_up_to_the_uncut_layer():
    """The port's MoE layer holding experts 0-3 and the one holding 4-7
    (the two cards of expert parallelism 2), each on its slice of the
    stacks: their outputs add up to the reference's layer over all 8."""
    conf = dict(tiny_kv.TINY_JAMBA, num_experts=8)
    conf, cfg, params = _setup(5, conf)
    p = {k: v[0] for k, v in params["blocks"][0]["l1"]["moe"].items() if k != "norm"}
    p["norm"] = {"scale": params["blocks"][0]["l1"]["moe"]["norm"]["scale"][0]}
    x = torch.randn(3, 10, conf["hidden_size"], generator=torch.Generator().manual_seed(2))
    outs = []
    for first in (0, 4):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_held=4,
                                                                 first_held=first))
        held = {**p, **{n: p[n][first:first + 4] for n in ("w1", "w2", "w3")}}
        with torch.no_grad():
            y, _ = M.apply_moe(share, held, x)
        outs.append(y - x)
    h = jamba.rms_norm(x, p["norm"]["scale"], conf["rms_norm_eps"])
    with jamba.exact_f32():
        want = jamba.moe(conf, p, h)
    assert torch.allclose(outs[0] + outs[1], want, atol=1e-5, rtol=1e-5)
    assert outs[0].abs().sum() > 0 and outs[1].abs().sum() > 0


def test_the_adapter_draws_each_expert_at_its_own_fan_in():
    conf = tiny_kv.TINY_JAMBA
    cfg = ADAPTER.port_config(conf)
    assert (cfg.moe.n_experts, cfg.moe.held, cfg.moe.top_k, cfg.n_layers) == (8, 4, 2, 16)
    assert cfg.ssm.inner_norms and not cfg.moe.renormalize and cfg.pos_embed == "none"
    d, eff = conf["hidden_size"], conf["intermediate_size"]
    descs = ADAPTER.descriptors(cfg)["blocks"][0]["l1"]["moe"]
    assert descs["w1"].scale == descs["w3"].scale == 1 / math.sqrt(d)
    assert descs["w2"].scale == 1 / math.sqrt(eff)
    assert descs["router"].shape == (2, d, 8) and descs["w1"].shape == (2, 4, d, eff)
    big = dict(conf, hidden_size=256, intermediate_size=1024)
    _, _, params = _setup(6, big, scales=False)
    moe = params["blocks"][0]["l1"]["moe"]
    for name, fan_in in (("w1", 256), ("w3", 256), ("w2", 1024)):
        assert moe[name].std().item() == pytest.approx(1 / math.sqrt(fan_in), rel=0.02)
    dense = params["blocks"][0]["l0"]["ffn"]
    assert dense["w2"].std().item() == pytest.approx(1 / math.sqrt(1024), rel=0.02)


def test_the_reference_counts_the_model_it_runs():
    """The published cut: 16 layers, 14 Mamba and 2 attention, 8 dense
    and 8 MoE; the port's parameters of the share equal the reference's
    count of them."""
    import json
    conf = json.loads((PKG / "configs" / "ai21-jamba2-mini.json").read_text())
    assert [jamba.kinds(conf, i) for i in range(8)] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
        ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe")]
    assert jamba.attention_shape(conf) == (2, 32, 8, 128)
    cfg = ADAPTER.port_config(conf)
    assert cfg.param_count() == pytest.approx(14.78e9, rel=2e-3)
    s = jamba.shapes(conf)
    experts = 8 * s["held"] * 3 * s["d"] * s["eff"]
    tables = 2 * s["vocab"] * s["d"]
    # every product's parameters: the count less the tables, norms, conv,
    # biases, A_log and D, and less the held experts a token does not reach
    small = cfg.param_count() - tables - experts
    per_token = jamba.matmul_params(conf)
    assert per_token == pytest.approx(small + experts * 2 / 16, rel=2e-3)

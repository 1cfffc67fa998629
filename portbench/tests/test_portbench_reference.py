"""The plain references against the port, on the CPU at tiny sizes."""
import ast
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny  # noqa: E402
from portbench.harness import runner  # noqa: E402
from portbench.harness.spec import load_module  # noqa: E402
from portbench.reference import mamba1  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PKG = ROOT / "portbench"


def _port_and_params(name, seed, dtype):
    conf = tiny.TINY_CONFIGS[name]
    adapter = load_module(PKG / "adapters" / f"{conf['family']}.py")
    cfg = adapter.port_config(conf)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    cell = type("C", (), {"config": dict(conf, torch_dtype=dtype)})
    params = runner.make_params(cell, adapter, cfg, seed, torch.device("cpu"))
    return conf, cfg, params, load_module(PKG / "reference" / f"{conf['family']}.py")


@pytest.mark.parametrize("name", sorted(tiny.TINY_CONFIGS))
@pytest.mark.parametrize("S", [5, 64])
def test_reference_matches_the_port_in_f32(name, S):
    conf, cfg, params, ref = _port_and_params(name, 3, "float32")
    toks = torch.randint(0, conf["vocab_size"], (2, S), generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        port, _ = T.prefill(cfg, params, toks)
    want = ref.forward(conf, params, toks, [S - 1])
    assert torch.allclose(port.float(), want, atol=2e-5, rtol=1e-4), \
        (port.float() - want).abs().max()


@pytest.mark.parametrize("name", sorted(tiny.TINY_CONFIGS))
def test_reference_follows_the_port_through_decode(name):
    """Prefill then greedy decode in the port against the reference's one
    pass over the prompt and the served tokens: logits at every served
    position."""
    conf, cfg, params, ref = _port_and_params(name, 4, "float32")
    P, n = 16, 6
    toks = torch.randint(0, conf["vocab_size"], (2, P), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, caches = T.prefill(cfg, params, toks)
        from repro_torch.serve import grow_caches
        caches = grow_caches(caches, P, P + n)
        outs, seq = [logits[:, -1]], toks
        for i in range(n - 1):
            tok = outs[-1].argmax(-1)[:, None]
            seq = torch.cat([seq, tok], 1)
            lo, caches = T.decode_step(cfg, params, caches, tok.to(torch.int32), P + i)
            outs.append(lo[:, -1])
    want = ref.forward(conf, params, seq, list(range(P - 1, P - 1 + n)))
    assert torch.allclose(torch.stack(outs, 1).float(), want, atol=5e-5, rtol=1e-4)


def test_closed_form_scan_matches_the_recurrence_and_halves_when_it_must(monkeypatch):
    g = torch.Generator().manual_seed(0)
    B, S, D, N = 2, 150, 8, 4
    u, dt = torch.randn(B, S, D, generator=g), torch.rand(B, S, D, generator=g) * 3
    A = -torch.rand(D, N, generator=g) * 8 - 0.5
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)
    h = torch.zeros(B, D, N, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None].double() * A.double()) * h \
            + (dt[:, t] * u[:, t]).double()[..., None] * Bm[:, t, None, :].double()
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t].double()))
    want = torch.stack(ys, 1).float()
    assert torch.allclose(mamba1.selective_scan(u, dt, A, Bm, Cm), want, atol=1e-5, rtol=1e-5)
    monkeypatch.setattr(mamba1, "MAX_LOG_DECAY", 5.0)   # every chunk halves, down to single steps
    assert torch.allclose(mamba1.selective_scan(u, dt, A, Bm, Cm), want, atol=1e-5, rtol=1e-5)


def test_the_references_import_nothing_of_the_port():
    allowed = {"torch", "math", "contextlib", "__future__", "portbench"}
    for path in (PKG / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, f"{path.name} imports {n}"
                if top == "portbench":
                    assert n.startswith("portbench.reference"), f"{path.name} imports {n}"

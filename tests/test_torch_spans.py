"""The port's spans (`repro_torch/models/spans.py`) in the serving steps:
none entered while the profiler is off, each one where its name says while
it records, and the outputs and caches bit-equal either way.  Reduced
falcon-mamba-7b and qwen2-1.5b, 2 layers, f32, on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import init_tree, tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

B, P, N_LAYERS = 2, 16, 2
ARCHS = ["falcon-mamba-7b", "qwen2-1.5b"]
# the spans of one decode step and the span each nests in (None: the root)
DECODE_PARENT = {"repro.decode": None, "repro.embed": "repro.decode",
                 "repro.blocks": "repro.decode", "repro.final_norm": "repro.decode",
                 "repro.logits": "repro.decode", "repro.logits.table": "repro.logits",
                 "repro.argmax": "repro.decode", "repro.mixer": "repro.blocks"}
MIXER_SPANS = {
    "falcon-mamba-7b": {"decode": ["repro.mamba.in_proj", "repro.mamba.conv", "repro.mamba.gates",
                                   "repro.mamba.state", "repro.mamba.out"],
                        "prefill": ["repro.mamba.in_proj", "repro.mamba.conv",
                                    "repro.mamba.gates", "repro.mamba.scan", "repro.mamba.out"]},
    "qwen2-1.5b": {"decode": ["repro.attn.qkv", "repro.attn.core", "repro.attn.out"],
                   "prefill": ["repro.attn.qkv", "repro.attn.core", "repro.attn.out"]},
}
# the span that each arch's decode step opens once a layer, beside the mixer
PER_LAYER = {"falcon-mamba-7b": "repro.mamba.state", "qwen2-1.5b": "repro.attn.core"}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    base = treg.smoke_config(arch)
    cfg = dataclasses.replace(base, blocks=tuple((p, N_LAYERS) for p, _ in base.blocks))
    gen = torch.Generator().manual_seed(0)
    params = init_tree(TT.build_descriptors(cfg), gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (B, P + 1), generator=gen)
    return arch, cfg, params, toks


def _serve(cfg, params, toks):
    """One prefill of P tokens and one decode step: (prefill logits, the
    decoded tokens, the caches after the step)."""
    logits, caches = tsteps.make_prefill_step(cfg)(params, {"tokens": toks[:, :P]})
    caches = tserve.grow_caches(caches, P, P + 1)
    nxt, caches = tsteps.make_serve_step(cfg)(params, caches, toks[:, P:P + 1], P)
    return logits, nxt, caches


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _repro_parent(e):
    """The nearest enclosing span of event `e`, by name, or None."""
    e = e.cpu_parent
    while e is not None and not e.name.startswith("repro."):
        e = e.cpu_parent
    return None if e is None else e.name


def _ancestors(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def test_no_span_is_entered_while_the_profiler_is_off(model, monkeypatch):
    _, cfg, params, toks = model
    made = []
    init = record_function.__init__

    def counting(self, *args, **kwargs):
        made.append(args)
        init(self, *args, **kwargs)

    monkeypatch.setattr(record_function, "__init__", counting)
    _serve(cfg, params, toks)
    assert made == []
    # the same patch sees the spans once the profiler records
    _profiled(lambda: _serve(cfg, params, toks))
    assert ("repro.decode",) in made and ("repro.prefill",) in made


def test_decode_step_spans_nest_as_named(model):
    arch, cfg, params, toks = model
    _, caches = tsteps.make_prefill_step(cfg)(params, {"tokens": toks[:, :P]})
    caches = tserve.grow_caches(caches, P, P + 1)
    step, tok = tsteps.make_serve_step(cfg), toks[:, P:P + 1]
    _, events = _profiled(lambda: step(params, caches, tok, P))
    spans = [e for e in events if e.name.startswith("repro.")]
    count = {}
    for e in spans:
        count[e.name] = count.get(e.name, 0) + 1
    assert count["repro.decode"] == 1
    assert count["repro.mixer"] == N_LAYERS and count[PER_LAYER[arch]] == N_LAYERS
    parents = dict(DECODE_PARENT, **{n: "repro.mixer" for n in MIXER_SPANS[arch]["decode"]})
    if arch == "qwen2-1.5b":
        parents["repro.ffn"] = "repro.blocks"
    assert set(count) == set(parents)
    for e in spans:
        assert _repro_parent(e) == parents[e.name], e.name
    for name in MIXER_SPANS[arch]["decode"]:
        assert count[name] == N_LAYERS
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops and all("repro.decode" in _ancestors(e) for e in ops)


def test_prefill_step_spans_nest_as_named(model):
    arch, cfg, params, toks = model
    step, batch = tsteps.make_prefill_step(cfg), {"tokens": toks[:, :P]}
    _, events = _profiled(lambda: step(params, batch))
    spans = [e for e in events if e.name.startswith("repro.")]
    assert [e.name for e in spans].count("repro.prefill") == 1
    for e in spans:
        if e.name in MIXER_SPANS[arch]["prefill"]:
            assert _repro_parent(e) == "repro.mixer"
        elif e.name in ("repro.embed", "repro.blocks", "repro.final_norm", "repro.logits"):
            assert _repro_parent(e) == "repro.prefill"
    for name in MIXER_SPANS[arch]["prefill"]:
        assert [e.name for e in spans].count(name) == N_LAYERS
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops and all("repro.prefill" in _ancestors(e) for e in ops)


def test_outputs_and_caches_are_bit_equal_with_the_profiler_on_and_off(model):
    _, cfg, params, toks = model
    off = _serve(cfg, params, toks)
    on, _ = _profiled(lambda: _serve(cfg, params, toks))
    for a, b in zip(tree_leaves(list(off)), tree_leaves(list(on))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_decode_writes_the_caches_prefill_of_one_more_token_leaves(model):
    """The decode step's in-place cache writes hold the new token: its
    caches match those of a prefill over the prompt and that token."""
    _, cfg, params, toks = model
    _, _, stepped = _serve(cfg, params, toks)
    _, whole = tsteps.make_prefill_step(cfg)(params, {"tokens": toks})
    for a, b in zip(tree_leaves(stepped), tree_leaves(whole)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_profile_serve_gives_each_span_the_device_time_it_launched():
    """`profile_serve.span_device_ms` on a stand-in profile: a call counts
    under every span that holds it; an ATen op sharing a call's id, the
    device-side copy of a span and a call outside every span count for
    none; the sum is over the steps."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    from repro_torch.profile_serve import span_device_ms

    def ev(name, dev, id_, start, end):
        return SimpleNamespace(name=name, device_type=dev, id=id_, time_range=Interval(start, end))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("repro.decode", cpu, 1, 0, 100), ev("repro.mamba.state", cpu, 2, 10, 40),
              ev("aten::mul", cpu, 5, 11, 14), ev("cudaLaunchKernel", cpu, 5, 12, 13),
              ev("mul_kernel", cuda, 5, 200, 230), ev("cuLaunchKernel", cpu, 6, 50, 51),
              ev("mamba_scan_kernel", cuda, 6, 240, 250), ev("cudaLaunchKernel", cpu, 7, 150, 151),
              ev("argmax_kernel", cuda, 7, 260, 265), ev("repro.decode", cuda, 0, 200, 250)]
    got = span_device_ms(events, 2)
    assert got == pytest.approx({"repro.decode": 0.02, "repro.mamba.state": 0.015})

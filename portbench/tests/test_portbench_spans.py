"""The program's spans in the traced slice (`harness/spans.py`): each device
op and each idle gap tied to the span that launched it, and the three
readers of them, on a synthetic Chrome trace; on the CPU they read nothing."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny  # noqa: E402
from portbench.harness import spans  # noqa: E402
from portbench.harness.spec import load_module  # noqa: E402
from portbench.harness.trace import SLICE, Trace  # noqa: E402

HOST, OTHER = {"pid": 1, "tid": 1}, {"pid": 1, "tid": 2}
NEW = ("mamba_state_ms_per_step.decode", "logits_ms_per_step.decode",
       "program_idle_share.prefill")


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


class Rec:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _range(name, ts, dur, where=HOST):
    return dict(where, name=name, cat="user_annotation", ts=ts, dur=dur)


def _call(corr, ts, name="cudaLaunchKernel", cat="cuda_runtime", where=HOST):
    return dict(where, name=name, cat=cat, ts=ts, dur=1, args={"correlation": corr})


def _op(corr, ts, dur, name="kernel", cat="kernel"):
    return {"name": name, "cat": cat, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def decode_trace():
    """One decode step between the markers (times in us).  Host:
    repro.decode [10, 60] holds repro.mamba.state [20, 40] and repro.logits
    [42, 58], which holds repro.logits.table [44, 48].  Device, slice
    [100, 200] (the markers' start and end):

        op    launched in           device       call
        D     another thread        [95, 105]    cudaLaunchKernel, ts 25
        A     repro.mamba.state     [110, 130]   cudaLaunchKernel, ts 22
        copy  repro.mamba.state     [140, 150]   cudaMemcpyAsync, ts 30
        B     repro.logits.table    [160, 170]   cudaLaunchKernel, ts 46
        C     no span               [180, 190]   cudaLaunchKernel, ts 70
        E     repro.mamba.state     [195, 210]   cuLaunchKernel, ts 35
    """
    return [
        _call(1, 5), _op(1, 100, 2, "spin_kernel(long)"),
        _range("repro.decode", 10, 50), _range("repro.mamba.state", 20, 20),
        _range("repro.logits", 42, 16), _range("repro.logits.table", 44, 4),
        _range("portbench.slice", 0, 300),
        _call(6, 25, where=OTHER), _op(6, 95, 10, "D"),
        _call(2, 22), _op(2, 110, 20, "A"),
        _call(3, 30, "cudaMemcpyAsync"), _op(3, 140, 10, "Memcpy DtoD", "gpu_memcpy"),
        _call(4, 46), _op(4, 160, 10, "B"),
        _call(5, 70), _op(5, 180, 10, "C"),
        _call(8, 35, "cuLaunchKernel", "cuda_driver"), _op(8, 195, 15, "E"),
        _call(7, 80), _op(7, 198, 2, "spin_kernel(long)"),
        {"name": "aten::mul", "cat": "cpu_op", "ts": 21, "dur": 3, **HOST},
    ]


def _rec(tmp_path, events, steps=2, name="cell"):
    path = spans.trace_path(Rec(root=tmp_path, name=name))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return Rec(cell=Rec(root=tmp_path, name=name), trace=Trace(events), slice={"steps": steps})


def test_each_op_belongs_to_the_spans_that_hold_its_launch():
    sp = spans.Spans(decode_trace())
    assert (sp.t0, sp.t1) == pytest.approx((100e-6, 200e-6))
    owners = {round(s * 1e6): names for s, _, names in sp.ops}
    assert owners == {95: (), 110: ("repro.decode", "repro.mamba.state"),
                      140: ("repro.decode", "repro.mamba.state"),
                      160: ("repro.decode", "repro.logits", "repro.logits.table"),
                      180: (), 195: ("repro.decode", "repro.mamba.state")}
    # E runs past the closing marker: clipped to [195, 200]
    assert sp.device_s("repro.mamba.state") == pytest.approx(35e-6)
    # a child's ops count under its parent
    assert sp.device_s("repro.logits") == pytest.approx(10e-6)
    assert sp.device_s("repro.logits.table") == pytest.approx(10e-6)
    assert sp.device_s("repro.decode") == pytest.approx(45e-6)


def test_each_gap_belongs_to_the_span_that_launched_the_op_ending_it():
    events = decode_trace()
    sp, tr = spans.Spans(events), Trace(events)
    got = [(round(g * 1e6, 6), name) for g, name in sp.gaps()]
    assert got == [(5, "repro.mamba.state"), (10, "repro.mamba.state"),
                   (10, "repro.logits.table"), (10, None), (5, "repro.mamba.state")]
    # the gaps are those the idle share sums
    assert sum(g for g, _ in sp.gaps()) == pytest.approx(tr.window_s - tr.busy_s)
    assert sp.program_idle_s == pytest.approx(30e-6)


def test_a_gap_the_slice_end_closes_is_the_harness_s():
    events = [_range(SLICE, 0, 100), _range("repro.prefill", 1, 5),
              _call(1, 2), _op(1, 10, 10, "A")]
    assert [(round(g * 1e6, 6), n) for g, n in spans.Spans(events).gaps()] == \
        [(10, "repro.prefill"), (80, None)]


def test_the_readers_arithmetic(tmp_path):
    rec = _rec(tmp_path, decode_trace(), steps=2)
    # (20 + 10 + 5) us of the state's ops over 2 steps; 10 us of the logits'
    assert reader("mamba_state_ms_per_step.decode").read(rec) == pytest.approx(0.0175)
    assert reader("logits_ms_per_step.decode").read(rec) == pytest.approx(0.005)
    # 30 of the slice's 40 idle us ended by the program's ops, over 100 us
    assert reader("program_idle_share.prefill").read(rec) == pytest.approx(30.0)
    assert reader("idle_share.prefill").read(rec) == pytest.approx(40.0)


def test_a_program_without_spans_reads_nothing(tmp_path):
    events = [e for e in decode_trace() if not e["name"].startswith("repro.")]
    rec = _rec(tmp_path, events)
    assert all(reader(n).read(rec) is None for n in NEW)
    # a trace with the step's span but no state or logits span: the
    # step's own ops still end the program's gaps
    events = [e for e in decode_trace() if not e["name"].startswith(("repro.mamba", "repro.logits"))]
    rec = _rec(tmp_path, events, name="other")
    assert reader("mamba_state_ms_per_step.decode").read(rec) is None
    assert reader("logits_ms_per_step.decode").read(rec) is None
    assert reader("program_idle_share.prefill").read(rec) == pytest.approx(30.0)
    assert all(reader(n).read(Rec(trace=None, slice=None)) is None for n in NEW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-mamba.tiny_decode", "tiny-dense.tiny_prefill"])
def test_on_the_cpu_the_readers_read_nothing(tree, cell):
    from portbench.harness.runner import load_cell, run_cell
    res = run_cell(tree, cell, 2**33 + 7, 0.2, True, device="cpu")["result"]
    assert res["correct"] and not set(NEW) & set(res["metrics"])
    # the program's spans are in the slice's trace all the same
    with open(spans.trace_path(load_cell(tree, cell))) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    root = "repro.decode" if cell.endswith("decode") else "repro.prefill"
    assert {root, "repro.mixer"} <= names

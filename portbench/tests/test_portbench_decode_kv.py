"""The `decode_kv` driver and the MoE readers, on the CPU at tiny sizes:
sessions decoded past their prompts over grown caches and judged correct,
the window ended by the room, broken timed paths and the control judged
not correct, and the readers' arithmetic on a synthetic trace."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny_kv  # noqa: E402
from portbench.harness import spans  # noqa: E402
from portbench.harness.roofline import bound_s  # noqa: E402
from portbench.harness.runner import run_cell  # noqa: E402
from portbench.harness.spec import load_module  # noqa: E402
from portbench.reference import jamba  # noqa: E402

SEEDS = (2**31 + 11, 3, 77)
CELLS = sorted(tiny_kv.KV_CELLS)
CONF = json.loads((ROOT / "portbench" / "configs" / "ai21-jamba2-mini.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: at these sizes it runs the cells ~3x faster than
    many (the readings are the same), and leaves the other test workers
    their cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_kv.make_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, cell, seed, trace=False, **kw):
    return run_cell(tree, cell, seed, tiny_kv.SECONDS, trace, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sessions_decode_past_their_prompts_and_run_correct(tree, cell, trace):
    out = _run(tree, cell, SEEDS[0], trace)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0, out["numbers"]
    want = {"itl_ms_p95"} if trace else {"output_tokens_per_s", "setup_s"}
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("cell", CELLS)
def test_the_window_ends_when_the_room_is_used(tree, cell):
    """12 positions of room past the 16-token prompts: the warm-up takes
    2, the window stops with 3 left for the traced slice, which fills
    them; every position written is inside the grown caches."""
    from portbench.drivers import decode_kv
    from portbench.harness.runner import Ctx, make_params
    from portbench.harness.program import Program
    from portbench.harness.spec import load_cell
    import torch
    c = load_cell(tree, cell)
    adapter = c.adapter()
    cfg = adapter.port_config(c.config)
    ctx = Ctx(c, SEEDS[1], torch.device("cpu"), cfg, Program(cfg),
              make_params(c, adapter, cfg, SEEDS[1], torch.device("cpu")), c.reference())
    state = decode_kv.setup(ctx)
    t = c.traffic
    assert state["pos"] == t["prompt_length"] + t["warm_steps"]
    w = decode_kv.window(ctx, state, tiny_kv.SECONDS)
    assert w["t1"] - w["t0"] < tiny_kv.SECONDS
    assert w["steps"] == t["grow"] - t["warm_steps"] - t["slice_steps"]
    assert w["tokens_out"] == w["steps"] * t["sessions"] and len(w["itl_ms"]) == w["steps"]
    assert decode_kv.traced_slice(ctx, state) == {"steps": t["slice_steps"]}
    assert state["pos"] == state["end"] == t["prompt_length"] + t["grow"]
    served = torch.stack(state["tokens"], 1)
    assert served.shape == (t["sessions"], 1 + t["grow"])
    assert ((served >= 0) & (served < c.config["vocab_size"])).all()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(tree, cell, fault):
    out = _run(tree, cell, SEEDS[0], fault=fault)
    assert out["result"]["failed"] == 0 and out["result"]["correct"] is False, out["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(tree, cell):
    limit = tiny_kv.KV_LIMITS[cell]
    for seed in SEEDS:
        out = _run(tree, cell, seed, control=True)
        n = out["numbers"]
        assert out["result"]["correct"] is False, n
        assert n["control_max_logit_gap"] > limit >= n["max_logit_gap"]


def test_grow_leaves_room_for_the_warm_up_and_the_slice(tree):
    from portbench.drivers import decode_kv
    ctx = type("Ctx", (), {"traffic": dict(tiny_kv.TINY_KV, grow=5)})
    with pytest.raises(ValueError, match="no room"):
        decode_kv.setup(ctx)


# ---------------------------------------------------------------------------
# the readers, on a synthetic trace and counters
# ---------------------------------------------------------------------------

HOST = {"pid": 1, "tid": 1}


def _range(name, ts, dur):
    return dict(HOST, name=name, cat="user_annotation", ts=ts, dur=dur)


def _call(corr, ts):
    return dict(HOST, name="cudaLaunchKernel", cat="cuda_runtime", ts=ts, dur=1,
                args={"correlation": corr})


def _op(corr, ts, dur, name="kernel"):
    return {"name": name, "cat": "kernel", "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def moe_trace():
    """Two decode steps' MoE layers between the markers, slice [100, 300]
    us.  Host: repro.moe [10, 40] holds route [10, 15], experts [16, 30]
    and combine [31, 40]; a second repro.moe [50, 80] holds experts
    [55, 70].  Device:

        op   launched in         device
        R    route               [110, 115]
        X1   experts             [120, 150]
        X2   experts             [145, 160]   (overlaps X1: 40 us of union)
        C    combine             [170, 175]
        Y    second experts      [200, 230]
        Z    no span             [240, 250]
    """
    return [
        _call(1, 5), _op(1, 100, 2, "spin_kernel(long)"),
        _range("portbench.slice", 0, 400),
        _range("repro.moe", 10, 30), _range("repro.moe.route", 10, 5),
        _range("repro.moe.experts", 16, 14), _range("repro.moe.combine", 31, 9),
        _range("repro.moe", 50, 30), _range("repro.moe.experts", 55, 15),
        _call(2, 11), _op(2, 110, 5, "R"),
        _call(3, 17), _op(3, 120, 30, "X1"),
        _call(4, 18), _op(4, 145, 15, "X2"),
        _call(5, 32), _op(5, 170, 5, "C"),
        _call(6, 56), _op(6, 200, 30, "Y"),
        _call(7, 90), _op(7, 240, 10, "Z"),
        _call(8, 95), _op(8, 298, 2, "spin_kernel(long)"),
    ]


class _Rec:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Cell:
    def __init__(self, root, calls):
        self.root, self.name, self.config = root, "jamba-cell", CONF
        self._calls = calls

    def adapter(self):
        calls = self._calls
        return type("A", (), {"counters": staticmethod(
            lambda: [{"calls": calls[:1]}, {"calls": calls[1:]}])})


def _rec(tmp_path, calls, steps=2):
    from portbench.harness.trace import Trace
    path = spans.trace_path(_Rec(root=tmp_path, name="jamba-cell"))
    path.parent.mkdir(parents=True, exist_ok=True)
    events = moe_trace()
    path.write_text(json.dumps({"traceEvents": events}))
    return _Rec(cell=_Cell(tmp_path, calls), conf=CONF, trace=Trace(events),
                slice={"steps": steps}, reference=jamba,
                peaks={"bf16_flops": 989e12, "hbm_bytes": 3.35e12})


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_expert_cost_counts_each_used_expert_once_and_each_row():
    d, eff = CONF["hidden_size"], CONF["intermediate_size"]
    assert (d, eff) == (4096, 14336)
    per_expert = [3, 0, 1, 0, 0, 4, 0, 0]          # 8 rows, 3 experts used
    flops, nbytes = jamba.expert_cost(CONF, per_expert)
    assert flops == 8 * 3 * 2 * 4096 * 14336
    # three (4096, 14336) bf16 matrices of each used expert, and each row's
    # 4096 inputs in and 4096 outputs out, bf16
    assert nbytes == 3 * (3 * 4096 * 14336 * 2) + 8 * 2 * 4096 * 2
    assert jamba.expert_cost(CONF, [0] * 8) == (0, 0)


def test_the_moe_readers_arithmetic(tmp_path):
    calls = [[8, 8, 8, 8, 8, 8, 8, 8], [16, 0, 0, 16, 0, 0, 0, 32]]
    rec = _rec(tmp_path, calls)
    # repro.moe: R, X1 u X2, C, Y = 5 + 40 + 5 + 30 = 80 us over 2 steps
    assert reader("moe_ms_per_step.decode").read(rec) == pytest.approx(0.040)
    least = sum(bound_s(*jamba.expert_cost(CONF, c), 989e12, 3.35e12) for c in calls)
    # both calls are bound by their bytes: 8 experts' and 3 experts' matrices
    assert least == pytest.approx((jamba.expert_cost(CONF, calls[0])[1]
                                   + jamba.expert_cost(CONF, calls[1])[1]) / 3.35e12)
    # repro.moe.experts: X1 u X2 and Y, 40 + 30 = 70 us
    got = reader("moe_experts_roofline.decode").read(rec)
    assert got == pytest.approx(100.0 * least / 70e-6)


def test_the_moe_readers_read_nothing_without_spans_or_counters(tmp_path):
    rec = _rec(tmp_path, [])
    assert reader("moe_experts_roofline.decode").read(rec) is None
    rec.cell.adapter = lambda: type("A", (), {})
    assert reader("moe_experts_roofline.decode").read(rec) is None
    none = _Rec(cell=rec.cell, conf=CONF, trace=None, slice=None, reference=jamba, peaks={})
    for name in ("moe_ms_per_step.decode", "moe_experts_roofline.decode"):
        assert reader(name).read(none) is None


@pytest.mark.parametrize("cell", CELLS)
def test_the_check_reads_decodes_widest_gap_and_the_mean_beside_it(tree, cell):
    """`decode_kv.check` reads the sample and positions `decode.check` reads:
    the same widest gap, and the mean of the same gaps below it; the
    control's mean lies far above the program's."""
    from portbench.drivers import decode, decode_kv
    from portbench.harness.program import Program
    from portbench.harness.runner import Ctx, make_params
    from portbench.harness.spec import load_cell
    import torch
    c = load_cell(tree, cell)
    adapter = c.adapter()
    cfg = adapter.port_config(c.config)
    ctx = Ctx(c, SEEDS[2], torch.device("cpu"), cfg, Program(cfg),
              make_params(c, adapter, cfg, SEEDS[2], torch.device("cpu")), c.reference(),
              control=True)
    state = decode_kv.setup(ctx)
    w = decode_kv.window(ctx, state, tiny_kv.SECONDS)
    mine, theirs = decode_kv.check(ctx, state, w), decode.check(ctx, state, w)
    assert mine["max_logit_gap"] == theirs["max_logit_gap"]
    assert mine["control_max_logit_gap"] == theirs["control_max_logit_gap"]
    assert 0 <= mine["mean_logit_gap"] <= mine["max_logit_gap"]
    assert mine["control_mean_logit_gap"] > 3 * mine["mean_logit_gap"]

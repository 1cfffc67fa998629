"""The check fails what it must: the float8 control and the timed path
broken underneath the harness, on the CPU at tiny sizes (the readings at
the cells' own sizes are `portbench/control.py`'s, on the card)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny  # noqa: E402
from portbench.harness.runner import run_cell  # noqa: E402

SEEDS = (2**31 + 11, 3, 77)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_the_control_in_the_programs_place_is_not_correct(tree, cell):
    """The control serves its own picks at exactly the positions the check
    reads the program, and the run's own comparison judges them: `correct`
    comes out false, while the program's reading of the same run holds."""
    for seed in SEEDS:
        out = run_cell(tree, cell, seed, 0.2, False, device="cpu", control=True)
        n = out["numbers"]
        assert out["result"]["correct"] is False, n
        assert out["result"]["checks"]["max_logit_gap"]["value"] == n["control_max_logit_gap"]
        assert n["control_max_logit_gap"] > tiny.TINY_LIMIT >= n["max_logit_gap"]
        assert n["control_max_logit_gap"] > 3 * n["max_logit_gap"]


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_sound_runs_are_correct(tree, cell):
    for seed in SEEDS:
        out = run_cell(tree, cell, seed, 0.2, False, device="cpu")
        assert out["result"]["correct"] is True, out["numbers"]


FAULTS = [(c, f) for c in sorted(tiny.TINY_CELLS)
          for f in (("half_batch", "token_altered") if c.endswith("prefill")
                    else ("state_unchanged", "token_altered"))]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tree, cell, fault):
    # a tiny decode mix serves its 6 warm-up steps whatever the window's length;
    # every answer of a broken path is an id in the vocabulary, so the
    # comparison, not the count of failed requests, has to catch it
    out = run_cell(tree, cell, SEEDS[0], 0.2, False, device="cpu", fault=fault)
    assert out["result"]["failed"] == 0 and out["result"]["correct"] is False, out["numbers"]


def test_the_check_reads_every_request_of_one_batch_of_each_length(tree):
    """The sample holds both halves of every batch it reads, so a batch
    half of which is answered with the other half's tokens cannot pass."""
    from portbench.drivers import prefill
    from portbench.harness.spec import load_cell
    cell = load_cell(tree, "tiny-dense.tiny_prefill")
    batches = [{"tag": (c, S), "B": 512 // S, "S": S, "served": list(range(512 // S))}
               for c in range(3) for S in (16, 32, 64)]
    ctx = type("Ctx", (), {"seed": 2**31 + 11, "limits": cell.limits})
    picks = prefill.sample(ctx, {"batches": batches})
    assert [(b["S"], b["B"]) for b in picks] == [(64, 8), (16, 32)]
    assert picks == prefill.sample(ctx, {"batches": batches})

"""Crash-recovery tests (DESIGN.md §15) of the port: SIGKILL a real
workflow process at randomized progress points, resume from the surviving
`JobStore`, and grade the resume against ground truth.  The cases and bounds
of `tests/test_recovery.py`, run on `repro_torch.core`.

Reuses the `repro_torch.benchmarks.kill_resume` child — a RealClock engine +
thread pool journaling into sqlite, whose task bodies append their index
to a sidecar file (O_APPEND page-cache writes survive SIGKILL).  The
sidecars record *which tasks actually executed* independently of the
store under test, so the assertions don't trust the thing being tested:

  * resumed results are byte-identical to an uninterrupted run's;
  * every task executed at least once across the two runs;
  * re-run count is bounded by the in-flight window (executor slots +
    journal batch + flush lag) — a store that lost its rows would re-run
    ~everything done before the kill, hundreds of tasks over this bound.
"""
import hashlib
import json
import os
import signal
import subprocess
import time

import pytest

pytest.importorskip("torch")

import repro_torch.benchmarks.kill_resume as kr  # noqa: E402
from repro_torch.core import JobStore  # noqa: E402

N = 600
# executors(4) + journal batch(32) + flush-lag at the smoke rate; a
# broken store re-runs ~kill_fraction * N >= 150, far over this
REDUNDANT_BOUND = 128


def _env():
    env = kr.child_env()
    # slow the bodies so mid-flight kills land reliably at N=600
    env.setdefault("KILL_RESUME_BODY_SLEEP", "0.002")
    return env


def _spawn(db, n, sidecar, results_path):
    return subprocess.Popen(kr.child_command(db, n, sidecar, results_path),
                            env=_env())


def _sidecar(path):
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return {int(line) for line in f if line.strip()}


def _reference(tmp_path):
    """Uninterrupted subprocess run: results bytes + executed set."""
    results = str(tmp_path / "ref.json")
    proc = _spawn(str(tmp_path / "ref.db"), N,
                  str(tmp_path / "ref.side"), results)
    assert proc.wait(timeout=300) == 0
    with open(results, "rb") as f:
        return f.read()


def _kill_at(tmp_path, fraction, tag):
    """Run the child, SIGKILL once `fraction` of N is durably done;
    return (db, sidecar, done_at_kill)."""
    db = str(tmp_path / f"{tag}.db")
    side = str(tmp_path / f"{tag}.side")
    proc = _spawn(db, N, side, str(tmp_path / f"{tag}.unused.json"))
    target = int(N * fraction)
    done = 0
    try:
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline:
            assert proc.poll() is None, \
                f"child finished before the {fraction:.0%} kill point"
            try:
                done = JobStore.peek(db, "killres")["done"]
            except Exception:
                done = 0
            if done >= target:
                break
            time.sleep(0.002)
        else:
            pytest.fail("kill threshold never reached")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    return db, side, done


def test_no_kill_subprocess_sanity(tmp_path):
    """The harness itself: an uninterrupted child produces the expected
    values and a complete sidecar."""
    ref_bytes = _reference(tmp_path)
    values = json.loads(ref_bytes)
    assert values == [(i * 2654435761) & 0xFFFFFFFF for i in range(N)]
    assert _sidecar(str(tmp_path / "ref.side")) == set(range(N))


@pytest.mark.parametrize("fraction", [0.25, 0.4, 0.6])
def test_sigkill_then_resume_is_exact_and_cheap(tmp_path, fraction):
    """SIGKILL at a randomized-ish progress point, resume from the store:
    byte-identical output, nothing durably done re-ran, and the re-run
    count stays inside the in-flight window at the moment of the kill."""
    ref_bytes = _reference(tmp_path)
    db, side1, done_at_kill = _kill_at(tmp_path, fraction, "kill")

    side2 = str(tmp_path / "resume.side")
    results, restored = kr.run_workflow(db, N, side2)

    assert hashlib.sha256(json.dumps(results).encode()).hexdigest() == \
        hashlib.sha256(ref_bytes).hexdigest()
    assert restored >= done_at_kill
    executed1, executed2 = _sidecar(side1), _sidecar(side2)
    assert executed1 | executed2 >= set(range(N))
    redundant = executed1 & executed2
    assert len(redundant) <= REDUNDANT_BOUND, \
        f"{len(redundant)} tasks re-ran (window bound {REDUNDANT_BOUND})"
    # the resume never re-runs more than what was in flight: everything
    # it executed is outside the durable set it restored
    assert len(executed2) <= N - restored + len(redundant)

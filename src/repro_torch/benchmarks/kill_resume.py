"""Kill-and-resume: fraction of a workflow re-run after SIGKILL (§15).

The port of the JAX package's `benchmarks/kill_resume.py`, on
`repro_torch.core`.  The child runs as
``python -m repro_torch.benchmarks.kill_resume --child ...``; the payload
goes to ``build/results/kill_resume.json`` under the repo root.

The paper's reliability claim (§3.5) is that a restart log bounds the
cost of a crash to the in-flight window, not the work already done.
This benchmark measures that bound on the *durable* path — the sqlite
`JobStore` + `WorkflowService` — with a real crash, not a simulated one:

  1. a child process runs an ``n``-task workflow (real threads, RealClock)
     journaling into a `JobStore`;
  2. the parent polls the store read-only until the durable done-count
     crosses ``KILL_RESUME_FRACTION`` (default t=50%), then SIGKILLs the
     child mid-commit;
  3. the parent re-opens the same store and resumes the same program:
     durably-done tasks restore from the store, only the frontier re-runs.

Every task body appends its index to a per-run **sidecar file** (O_APPEND
page-cache writes survive SIGKILL), so "which tasks actually executed" is
measured independently of the store under test.  Redundant work is the
intersection of the two runs' sidecar sets.  Correctness is byte-identity:
the resumed run's results JSON must hash equal to an uninterrupted
reference run's.

Assertions encoded in the output:
  * results byte-identical to the uninterrupted reference;
  * ``restored >= done-at-kill`` (nothing durably recorded was re-run);
  * redundant work bounded by the in-flight window (executor slots +
    journal batch + store flush lag), and at full scale
    (``n >= 50000``) by ``<= 5%`` of ``n``.

Knobs: ``KILL_RESUME_TASKS`` (default 100000; CI smoke uses 3000),
``KILL_RESUME_EXECUTORS`` (4), ``KILL_RESUME_FRACTION`` (0.5),
``KILL_RESUME_BODY_SLEEP`` (0.0005 s — keeps the kill genuinely
mid-flight at smoke sizes).

Run:  KILL_RESUME_TASKS=3000 PYTHONPATH=src python -m repro_torch.benchmarks.kill_resume
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from repro_torch.core import (Engine, JobStore, LocalProvider, RealClock,
                              ThreadExecutorPool, WorkflowService)

# the directory that holds the `repro_torch` package, and the repo root
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(os.path.dirname(_SRC), "build", "results")

N_TASKS = int(os.environ.get("KILL_RESUME_TASKS", "100000"))
EXECUTORS = int(os.environ.get("KILL_RESUME_EXECUTORS", "4"))
KILL_FRACTION = float(os.environ.get("KILL_RESUME_FRACTION", "0.5"))
BODY_SLEEP = float(os.environ.get("KILL_RESUME_BODY_SLEEP", "0.0005"))
WF_ID = "killres"
FLUSH_INTERVAL = 0.02
JOURNAL_BATCH = 32

_SIDE_FD = -1


def _body(i: int) -> int:
    """Pure except for the sidecar append: the ground-truth 'I executed'
    record this benchmark grades the store against."""
    if BODY_SLEEP:
        time.sleep(BODY_SLEEP)
    os.write(_SIDE_FD, b"%d\n" % i)
    return (i * 2654435761) & 0xFFFFFFFF


def run_workflow(db: str, n: int, sidecar: str,
                 executors: int = EXECUTORS) -> tuple[list, int]:
    """Build + run (or resume) the n-task workflow against `db`.

    Returns ``(results, restored)``.  Identical program every call, so a
    second call against a store holding a partial run is a resume.
    """
    global _SIDE_FD
    _SIDE_FD = os.open(sidecar, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                       0o644)
    clock = RealClock()
    pool = ThreadExecutorPool(clock, workers=executors)
    eng = Engine(clock)
    eng.add_site("local",
                 LocalProvider(clock, concurrency=executors, pool=pool),
                 capacity=executors)
    try:
        with JobStore(db, flush_interval=FLUSH_INTERVAL) as store:
            with WorkflowService(eng, store,
                                 journal_batch=JOURNAL_BATCH) as svc:
                h = svc.open(WF_ID)
                hash_task = h.wf.atomic(fn=_body, name="hash")
                out = h.seal(h.wf.gather([hash_task(i) for i in range(n)]))
                svc.run()
                return out.get(), h.restored
    finally:
        pool.shutdown()
        os.close(_SIDE_FD)
        _SIDE_FD = -1


def _child_main(argv: list[str]) -> int:
    """``--child <db> <n> <sidecar> <results_path>`` — run to completion
    and write the results JSON (the parent usually kills us first)."""
    db, n, sidecar, results_path = argv[0], int(argv[1]), argv[2], argv[3]
    results, _ = run_workflow(db, n, sidecar)
    tmp = results_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f)
    os.replace(tmp, results_path)
    return 0


def _read_sidecar(path: str) -> set:
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return {int(line) for line in f if line.strip()}


def child_env() -> dict:
    """The environment of a child: this one, with the port importable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_SRC, env.get("PYTHONPATH")) if p)
    return env


def child_command(db: str, n: int, sidecar: str, results_path: str) -> list:
    return [sys.executable, "-m", "repro_torch.benchmarks.kill_resume",
            "--child", db, str(n), sidecar, results_path]


def _spawn_child(db: str, n: int, sidecar: str,
                 results_path: str) -> subprocess.Popen:
    return subprocess.Popen(child_command(db, n, sidecar, results_path),
                            env=child_env())


def measure(n: int = N_TASKS, workdir: str | None = None) -> dict:
    """The full experiment; returns the metrics payload (see module
    docstring for the assertions it encodes)."""
    workdir = workdir or tempfile.mkdtemp(prefix="kill_resume_")
    db_ref = os.path.join(workdir, "ref.db")
    db_kill = os.path.join(workdir, "kill.db")
    side_ref = os.path.join(workdir, "ref.side")
    side1 = os.path.join(workdir, "run1.side")
    side2 = os.path.join(workdir, "run2.side")
    ref_results = os.path.join(workdir, "ref.results.json")

    # -- uninterrupted reference (subprocess: same environment as run 1)
    ref = _spawn_child(db_ref, n, side_ref, ref_results)
    if ref.wait(timeout=1800) != 0:
        raise RuntimeError("reference run failed")
    with open(ref_results, "rb") as f:
        ref_bytes = f.read()
    ref_sha = hashlib.sha256(ref_bytes).hexdigest()

    # -- run 1: kill at the durable t=KILL_FRACTION mark
    target = int(n * KILL_FRACTION)
    child = _spawn_child(db_kill, n, side1,
                         os.path.join(workdir, "unused.results.json"))
    t0 = time.monotonic()
    done_at_kill = 0
    try:
        deadline = t0 + 1800.0
        while time.monotonic() < deadline:
            if child.poll() is not None:
                raise RuntimeError(
                    f"child finished (rc={child.returncode}) before the "
                    f"kill threshold {target} — raise KILL_RESUME_BODY_SLEEP")
            try:
                done_at_kill = JobStore.peek(db_kill, WF_ID)["done"]
            except Exception:
                done_at_kill = 0        # store not created/visible yet
            if done_at_kill >= target:
                break
            # peek parses the store's un-folded log tail (it grows until a
            # barrier folds it), so poll gently — a hot poll loop would
            # also steal CPU from the child on small hosts
            time.sleep(0.02)
        else:
            raise RuntimeError("kill threshold never reached")
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait()
    elapsed = time.monotonic() - t0
    rate = done_at_kill / max(elapsed, 1e-9)

    # -- run 2: resume in-process from the surviving store
    t1 = time.monotonic()
    results, restored = run_workflow(db_kill, n, side2)
    resume_wall = time.monotonic() - t1
    resumed_bytes = json.dumps(results).encode()
    resumed_sha = hashlib.sha256(resumed_bytes).hexdigest()

    executed1 = _read_sidecar(side1)
    executed2 = _read_sidecar(side2)
    redundant = len(executed1 & executed2)
    # the only work a crash may legitimately repeat: tasks executed but
    # not yet durably committed — executor slots + the journal's row
    # buffer + the store's flush-interval lag at the observed rate
    window = EXECUTORS + JOURNAL_BATCH + int(FLUSH_INTERVAL * rate) + 1
    payload = {
        "n_tasks": n,
        "executors": EXECUTORS,
        "kill_fraction": KILL_FRACTION,
        "done_at_kill": done_at_kill,
        "rate_at_kill_tasks_per_s": rate,
        "restored": restored,
        "executed_run1": len(executed1),
        "executed_run2": len(executed2),
        "redundant_tasks": redundant,
        "redundant_fraction": redundant / n,
        "inflight_window": window,
        "resume_wall_s": resume_wall,
        "byte_identical": resumed_sha == ref_sha,
        "sha256": resumed_sha,
    }
    assert payload["byte_identical"], \
        f"resumed results diverged from reference ({resumed_sha} != {ref_sha})"
    assert restored >= done_at_kill, \
        f"durably-done work re-ran: restored {restored} < {done_at_kill}"
    assert executed1 | executed2 >= set(range(n)), "tasks never executed"
    assert redundant <= 4 * window, \
        f"redundant {redundant} exceeds 4x in-flight window {window}"
    if n >= 50000:
        assert redundant <= 0.05 * n, \
            f"redundant fraction {redundant / n:.3f} exceeds 5%"
    return payload


def save_json(name: str, payload) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, name + ".json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path


def run() -> list[dict]:
    payload = measure()
    save_json("kill_resume", payload)
    wall = payload["resume_wall_s"]
    return [{
        "name": "kill_resume.redundant_fraction",
        "us_per_call": 1e6 * wall / max(payload["n_tasks"], 1),
        "derived": (
            f"{payload['redundant_tasks']} of {payload['n_tasks']} tasks "
            f"re-ran ({100 * payload['redundant_fraction']:.2f}%) after "
            f"SIGKILL at {payload['done_at_kill']} durable; "
            f"restored {payload['restored']}; byte-identical"),
    }]


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.exit(_child_main(sys.argv[2:]))
    for row in run():
        print(f"{row['name']},{row['us_per_call']:.3f},{row['derived']}")

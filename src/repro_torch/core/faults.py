"""Fault model + retry policy (paper §3.12).

* transient faults: retried in place (paper: GridFTP-busy style)
* host faults: Falkon suspends the executor for `suspend_time` after
  `host_fail_threshold` consecutive failures ("stale NFS handle" pattern)
* site faults: after `site_fail_threshold` failures at a site, the task is
  handed back for rescheduling at a *different* site
* revocations: ``kind="revoked"`` marks an administrative requeue (a
  drained service handing queued tasks back, DESIGN.md §13) — the engine
  re-places the task elsewhere without charging a retry or denting the
  site score

Site-correlated, time-windowed scenarios (`fail_site_window`) model the
paper's operational reality — a whole site going bad mid-campaign — and
drive the health-monitor benchmark.  A rule with ``latency=`` models
fail-slow faults (hangs/timeouts): the failed attempt occupies its
executor for `latency` seconds instead of the task's nominal duration
(the Falkon sim path evaluates such rules at dispatch time).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable


class TaskFailure(Exception):
    """A task-body failure carrying its fault class (paper §3.12):
    ``kind`` is ``"transient"`` (retried in place), ``"host"`` (counts
    toward executor suspension), ``"site"`` (rescheduled at a different
    site), or ``"revoked"`` (administrative drain requeue — no retry
    charge).  Raise it from a task body — or let any other exception map
    to transient — e.g. ``raise TaskFailure("stale NFS", kind="host")``.
    ``latency`` (optional) is the seconds the failing attempt holds its
    executor before the failure surfaces — fail-slow/timeout faults; the
    simulated Falkon path honors it when the rule is evaluated at
    dispatch time."""

    def __init__(self, msg: str, kind: str = "transient",
                 latency: float | None = None):
        super().__init__(msg)
        self.kind = kind  # transient | host | site | revoked
        self.latency = latency

    def __reduce__(self):
        # Exception's default reduce keeps only `args` (the message), so a
        # TaskFailure crossing a process boundary — a shard process
        # reporting a failed task (DESIGN.md §14) — would silently revert
        # to kind="transient" and lose its fail-slow latency
        return (TaskFailure,
                (self.args[0] if self.args else "", self.kind, self.latency))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 3
    host_fail_threshold: int = 2     # consecutive failures -> suspend host
    host_suspend_time: float = 60.0  # seconds (paper: configurable)
    site_fail_threshold: int = 3     # same-site failures -> reschedule away
    backoff: float = 0.0             # optional retry delay


class FaultInjector:
    """Deterministic failure injection for tests/benchmarks.

    Rules are callables ``rule(task_name, host, attempt) -> TaskFailure |
    None``; a rule carrying ``wants_site = True`` is additionally passed
    the site name (``rule(task_name, host, attempt, site)``), which is how
    site-correlated scenarios match tasks dispatched through providers
    that never set a host.  Time-windowed rules need the run's clock —
    pass ``clock=`` (or set ``inj.clock``) before registering one."""

    def __init__(self, seed: int = 0, clock=None):
        self.rng = random.Random(seed)
        self.rules: list[Callable] = []
        self.clock = clock
        # True once any registered rule wants dispatch-time (fail-slow)
        # evaluation; the engine copies this onto the per-task fault check
        self.timed = False

    def fail_probability(self, p: float, kind: str = "transient",
                         only_task: str | None = None):
        def rule(task_name: str, host: str, attempt: int):
            if only_task and only_task not in task_name:
                return None
            if self.rng.random() < p:
                return TaskFailure(f"injected {kind} fault", kind)
            return None
        self.rules.append(rule)
        return self

    def fail_host(self, host: str, n_times: int, kind: str = "host"):
        state = {"left": n_times}

        def rule(task_name: str, task_host: str, attempt: int):
            if task_host == host and state["left"] > 0:
                state["left"] -= 1
                return TaskFailure(f"injected fault on {host}", kind)
            return None
        self.rules.append(rule)
        return self

    def fail_first_n(self, task_substr: str, n: int, kind: str = "transient"):
        state = {"left": n}

        def rule(task_name: str, host: str, attempt: int):
            if task_substr in task_name and state["left"] > 0:
                state["left"] -= 1
                return TaskFailure(f"injected fault in {task_name}", kind)
            return None
        self.rules.append(rule)
        return self

    def fail_site_window(self, site: str, p: float,
                         start: float = 0.0, end: float = float("inf"),
                         kind: str = "transient",
                         latency: float | None = None,
                         only_task: str | None = None):
        """Site-correlated, time-windowed fault scenario: tasks attempted
        at `site` between clock times ``[start, end)`` fail with
        probability `p`.  ``latency=`` makes them fail-slow (the attempt
        occupies its executor that long before failing — the simulated
        Falkon path evaluates such rules at dispatch time, so the window
        applies to attempt *start*).  Matches the site name passed by the
        engine, or a ``{site}-host*`` host prefix for direct callers.
        Requires a bound clock."""
        if self.clock is None:
            raise ValueError("fail_site_window needs a clock: "
                             "FaultInjector(seed, clock=clock)")
        clock = self.clock
        prefix = site + "-host"

        def rule(task_name: str, host: str, attempt: int,
                 task_site: str = ""):
            if task_site != site and not host.startswith(prefix):
                return None
            if only_task and only_task not in task_name:
                return None
            now = clock.now()
            if not (start <= now < end):
                return None
            if self.rng.random() < p:
                return TaskFailure(f"injected {kind} fault at {site}",
                                   kind, latency=latency)
            return None

        rule.wants_site = True
        if latency is not None:
            self.timed = True
        self.rules.append(rule)
        return self

    def check(self, task_name: str, host: str, attempt: int,
              site: str = ""):
        for rule in self.rules:
            if getattr(rule, "wants_site", False):
                err = rule(task_name, host, attempt, site)
            else:
                err = rule(task_name, host, attempt)
            if err is not None:
                raise err

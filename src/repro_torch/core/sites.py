"""Execution sites + score-based load balancing (paper §3.13).

Each site carries a responsiveness score: increased on successful, fast
turnarounds; decreased on exceptions.  Dispatch is proportional to score and
available capacity — the same heuristic that produced the paper's Fig 11
218/262 split across ANL_TG / UC_TP.

Two extensions over the paper's balancer:

  * **data affinity** — a site backed by a cache-aware data layer
    (DESIGN.md §7) can register it via `set_affinity`; `pick` then boosts
    sites whose executors already hold a task's declared inputs, with the
    boost priced against the `StagingCostModel` (the bonus is exactly the
    shared-vs-local read-time advantage, scaled by covered bytes).  The
    no-inputs path — and any balancer with no registered affinity — is
    behaviorally identical to the score-only heuristic.
  * **steal interface** — `idle_slots` reports free, non-suspended
    capacity so a federation-level `WorkStealer` (DESIGN.md §8) can decide
    thief eligibility without reaching into per-site state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class SiteStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    busy_time: float = 0.0


class Site:
    """One execution site: a provider plus capacity, app validity, and the
    responsiveness score the balancer steers by.  Created for you by
    `Engine.add_site`::

        site = eng.add_site("anl_tg", FalkonProvider(svc), capacity=64,
                            apps={"moldyn"})
    """

    def __init__(self, name: str, provider, capacity: int,
                 apps: set[str] | None = None, score: float = 1.0):
        self.name = name
        self.provider = provider
        self.capacity = capacity
        self.apps = apps  # None = everything installed
        self.score = score
        self.outstanding = 0
        # predicted seconds of work currently outstanding on this site
        # (DESIGN.md §11): maintained by the engine when the balancer is
        # `duration_aware`, from `duration=` specs — explicit, callable,
        # or filled by a `DurationPredictor` — so `pick` can price
        # compute *before* running it; stays 0.0 otherwise
        self.outstanding_work = 0.0
        self.stats = SiteStats()
        # drain/blacklist seam (DESIGN.md §13): `pick` and `idle_slots`
        # skip a site while now < suspended_until.  The engine's retry
        # path sets it for fixed backoffs; a `HealthMonitor` drives it
        # from observed windowed error rates.
        self.suspended_until = 0.0
        # degraded-state weight multiplier, set by the health monitor
        # (1.0 = no effect; `pick` multiplies it into the site weight)
        self.derate = 1.0
        # monitor-maintained label ("healthy" | "degraded" | "drained" |
        # "blacklisted") — informational; scheduling reads only
        # `suspended_until` and `derate`
        self.health_state = "healthy"

    # -- paper: score up on success, down on exceptions ---------------------
    def on_success(self, turnaround: float):
        self.stats.completed += 1
        self.stats.busy_time += turnaround
        self.score = min(100.0, self.score * 1.05 + 0.1)

    def on_failure(self):
        self.stats.failed += 1
        self.score = max(0.05, self.score * 0.5)

    def valid_for(self, app: str | None) -> bool:
        return self.apps is None or app is None or app in self.apps

    def free_slots(self) -> int:
        return max(0, self.capacity - self.outstanding)


class LoadBalancer:
    """Pick the valid site with the largest score-weighted free capacity.

    Site candidates are served from a per-app index so per-task dispatch
    does not rescan every registered site (the seed's `pick` and the
    engine's multi-site check were both O(sites) per task).  A site's
    `apps` set is treated as fixed once the site is registered.

    Cache-staleness contract: `add_site` invalidates the *entire* per-app
    index, so a site added mid-run is visible to the very next
    `sites_for`/`pick` call — callers must not hold candidate lists across
    an `add_site` (the engine refetches per placement, so it never does).

    Determinism contract: `sites_for` preserves registration order (list
    append, no dict iteration), and `pick` breaks weight ties toward the
    earliest-registered site — replays under `SimClock` are stable and do
    not depend on hash seeds or insertion luck.
    """

    def __init__(self, sites: list[Site], duration_aware: bool = False):
        self.sites = list(sites)
        self._by_app: dict = {}
        # site name -> data layer (DESIGN.md §7) for the affinity term;
        # empty dict == affinity disabled, pick is the score-only heuristic
        self._affinity: dict = {}
        # duration-aware pricing (DESIGN.md §11): when on, the engine
        # maintains `Site.outstanding_work` (predicted seconds queued, from
        # `duration=` specs or the `DurationPredictor`) and `pick` folds it
        # into the load term, so 100 one-second tasks and 100 millisecond
        # tasks stop looking like equal backlog.  Off (the default) the
        # weight formula is byte-identical to the score-only heuristic.
        self.duration_aware = duration_aware

    def add_site(self, site: Site):
        self.sites.append(site)
        # full invalidation, not per-app patching: every cached candidate
        # list may be missing the new site (its apps set may be None ==
        # "everything"), so all of them are stale the moment it registers
        self._by_app.clear()

    def set_affinity(self, site_name: str, data_layer) -> None:
        """Register the data layer backing a site so `pick` can weigh data
        affinity (route to the site whose executors hold a task's inputs,
        priced against the layer's `StagingCostModel`)."""
        self._affinity[site_name] = data_layer

    def sites_for(self, app: str | None) -> list[Site]:
        """Valid sites for an app (cached; app cardinality is workflow-level
        and small, so the cache is bounded).  The cache is invalidated
        wholesale by `add_site`, covering sites added mid-run."""
        cands = self._by_app.get(app)
        if cands is None:
            cands = [s for s in self.sites if s.valid_for(app)]
            self._by_app[app] = cands
        return cands

    def pick(self, app: str | None, now: float,
             require_room: bool = False, slack: float = 2.0,
             inputs=None) -> Optional[Site]:
        # affinity engages only when the task declares inputs AND a data
        # layer is registered; otherwise the loop below is byte-identical
        # in behavior to the score-only balancer
        aff = self._affinity if inputs else None
        dur = self.duration_aware
        best, best_w = None, -1.0
        for s in self.sites_for(app):
            if now < s.suspended_until:
                continue
            if require_room and s.outstanding >= s.capacity * slack:
                continue
            # queue-depth-aware proportional weight: equilibrium backlog is
            # proportional to score x capacity, so fast/large sites get more
            # jobs (paper Fig 11) even when every site is saturated; the
            # duration-aware term adds *predicted seconds* of queued work,
            # so a site holding few-but-long tasks yields to one holding
            # many-but-tiny tasks when the predictions say it should
            load = s.outstanding + (s.outstanding_work if dur else 0.0)
            # `derate` folds the health monitor's degraded state into the
            # weight (1.0 when healthy — multiplication is exact identity,
            # so a monitor-less run is byte-identical)
            w = s.score * s.derate * s.capacity / (1.0 + load)
            if aff:
                dl = aff.get(s.name)
                if dl is not None:
                    w *= _affinity_boost(dl, inputs)
            # strict >: ties break toward the earliest-registered site
            # (sites_for preserves registration order), so replays are
            # deterministic under SimClock
            if w > best_w:
                best, best_w = s, w
        return best

    def idle_slots(self, now: float, app: str | None = None) -> int:
        """Free, non-suspended capacity across (valid) sites — the steal
        interface (DESIGN.md §8): a federation's `WorkStealer` treats a
        shard as a thief candidate only when this is positive.  O(valid
        sites), which is per-shard and small."""
        free = 0
        for s in self.sites_for(app):
            if now >= s.suspended_until:
                free += s.free_slots()
        return free

    def any_valid(self, app: str | None) -> bool:
        return bool(self.sites_for(app))


def _affinity_boost(dl, inputs) -> float:
    """Multiplicative weight bonus for a site whose data layer already
    holds (part of) the task's inputs, priced against the staging cost
    model: with full coverage the weight scales by exactly the
    shared-read vs local-read time ratio for the input set, with partial
    coverage by the covered fraction of that advantage.  Cost is
    O(inputs) dict probes; no executor scans."""
    total = 0.0
    covered = 0.0
    for obj in inputs:
        total += obj.size
        if dl.holds(obj.name):
            covered += obj.size
    if total <= 0.0 or covered <= 0.0:
        return 1.0
    cost = dl.cost
    local = cost.local_read_time(total)
    advantage = cost.shared_read_time(total) / max(local, 1e-12)
    if advantage <= 1.0:
        return 1.0
    return 1.0 + (covered / total) * (advantage - 1.0)

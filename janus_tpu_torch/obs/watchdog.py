"""Consensus health watchdog: liveness signals from the flight recorder
and the metrics registry (counterpart: janus_tpu/obs/watchdog.py).

Aggregate histograms say how fast the pipeline runs; the watchdog says
whether it is running at all, and captures evidence when it stops. Each
detector is fed by an ``observe_*`` call from the owner's loop:

- **commit stall**: ops are pending but the own-commit counter has not
  advanced for ``stall_ticks`` consecutive observations.
- **recompile storm**: a trace counter rose on ``recompile_limit`` or
  more of the last ``recompile_window`` observations. The port runs
  eagerly and has no retrace of its own; ``observe_trace_count`` takes
  whatever count its caller keeps.
- **overflow streak**: the delta-converge slab budget overflowed on
  ``overflow_streak`` consecutive ticks.
- **equivocation**: integrity verification pruned more than
  ``equivocation_limit`` blocks from one source node
  (``consensus/integrity.py``).
- **shed storm**: the admission controller shed at least
  ``shed_storm_frac`` of offered ops on ``shed_storm_ticks``
  consecutive loaded observations.
- **key exchange**: a split-cluster peer has not completed key exchange
  within its retry budget.

Each detector is edge-triggered: on the observation where an anomaly
first becomes active, the watchdog dumps the flight recorder to
``dump_dir/flight_<anomaly>_<n>.jsonl`` (once per activation) and bumps
``watchdog_anomalies_total``. ``health()`` folds the active set to
OK / DEGRADED / STALLED with reasons and mirrors the status into the
``watchdog_health`` gauge (0/1/2).
"""
from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from janus_tpu_torch.obs import flight
from janus_tpu_torch.obs.metrics import get_registry

OK, DEGRADED, STALLED = "OK", "DEGRADED", "STALLED"
_LEVEL = {OK: 0, DEGRADED: 1, STALLED: 2}


@dataclass(frozen=True)
class WatchdogConfig:
    stall_ticks: int = 200        # no-progress observations before STALLED
    recompile_window: int = 8     # trace-count observations kept
    recompile_limit: int = 3      # rises within the window -> storm
    overflow_streak: int = 16     # consecutive overflow ticks -> DEGRADED
    equivocation_limit: int = 0   # pruned blocks tolerated per node
    shed_storm_ticks: int = 16    # consecutive heavy-shed ticks -> DEGRADED
    shed_storm_frac: float = 0.5  # shed/offered ratio that counts as heavy
    dump_dir: Optional[str] = None  # None -> never write dump files
    # dump-file qualifier for instances SHARING a dump_dir (shard
    # workers, split-cluster processes): each watchdog counts its own
    # dumps, so without a tag shard 0's flight_commit_stall_1.jsonl
    # silently overwrites shard 1's
    tag: str = ""


class HealthWatchdog:
    """Edge-triggered anomaly detectors over tick-loop observations."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 registry=None, recorder=None):
        self.cfg = cfg
        reg = registry if registry is not None else get_registry()
        self._g_health = reg.gauge("watchdog_health")
        self._c_anomalies = reg.counter("watchdog_anomalies_total")
        self._recorder = recorder
        # commit-stall state, per scope
        self._last_commits: Dict[str, int] = {}
        self._stalled_for: Dict[str, int] = {}
        # recompile-storm state, per scope
        self._traces: Dict[str, deque] = {}
        # overflow-streak state, per scope
        self._last_overflows: Dict[str, int] = {}
        self._overflow_run: Dict[str, int] = {}
        # shed-storm state, per scope (cumulative-counter deltas)
        self._last_shed: Dict[str, int] = {}
        self._last_offered: Dict[str, int] = {}
        self._shed_run: Dict[str, int] = {}
        # equivocation state
        self._equiv: Dict[int, int] = {}
        self._active: Dict[str, str] = {}  # anomaly key -> reason
        self._dumps = 0

    # -- observations ----------------------------------------------------

    def observe_commits(self, scope: str, own_commits: int,
                        pending_ops: int) -> None:
        """One tick's progress evidence for a pipeline scope."""
        key = f"commit_stall:{scope}"
        last = self._last_commits.get(scope)
        self._last_commits[scope] = own_commits
        if last is None or own_commits > last or pending_ops <= 0:
            self._stalled_for[scope] = 0
            self._clear(key)
            return
        n = self._stalled_for.get(scope, 0) + 1
        self._stalled_for[scope] = n
        if n >= self.cfg.stall_ticks:
            self._raise(key, STALLED,
                        f"{scope}: no commit for {n} ticks with "
                        f"{pending_ops} ops pending")

    def observe_trace_count(self, scope: str, trace_count: int) -> None:
        """Feed a trace counter once per observation (the reason names
        them megaticks, as the JAX package's does)."""
        key = f"recompile_storm:{scope}"
        dq = self._traces.setdefault(
            scope, deque(maxlen=max(2, self.cfg.recompile_window)))
        dq.append(int(trace_count))
        rises = sum(1 for a, b in zip(dq, list(dq)[1:]) if b > a)
        if rises >= self.cfg.recompile_limit:
            self._raise(key, DEGRADED,
                        f"{scope}: {rises} retraces in last "
                        f"{len(dq)} megaticks")
        else:
            self._clear(key)

    def observe_overflow(self, scope: str, overflows_total: int) -> None:
        """Feed the cumulative delta-budget overflow counter per tick."""
        key = f"overflow_streak:{scope}"
        last = self._last_overflows.get(scope)
        self._last_overflows[scope] = overflows_total
        if last is None or overflows_total <= last:
            self._overflow_run[scope] = 0
            self._clear(key)
            return
        n = self._overflow_run.get(scope, 0) + 1
        self._overflow_run[scope] = n
        if n >= self.cfg.overflow_streak:
            self._raise(key, DEGRADED,
                        f"{scope}: delta budget overflowed "
                        f"{n} consecutive ticks")

    def observe_shed(self, scope: str, shed_total: int,
                     offered_total: int) -> None:
        """Feed the cumulative SLO shed/offered counters once per tick.
        A tick counts toward the storm when the tick's shed delta is at
        least ``shed_storm_frac`` of its offered delta; idle ticks
        (nothing offered) neither extend nor reset the streak — a storm
        is about the ticks that carried load."""
        key = f"shed_storm:{scope}"
        last_s = self._last_shed.get(scope)
        last_o = self._last_offered.get(scope, 0)
        self._last_shed[scope] = int(shed_total)
        self._last_offered[scope] = int(offered_total)
        if last_s is None:
            return
        ds = int(shed_total) - last_s
        do = int(offered_total) - last_o
        if do <= 0:
            return
        if ds > 0 and ds >= self.cfg.shed_storm_frac * do:
            n = self._shed_run.get(scope, 0) + 1
            self._shed_run[scope] = n
            if n >= self.cfg.shed_storm_ticks:
                self._raise(key, DEGRADED,
                            f"{scope}: shed {ds}/{do} offered ops, "
                            f"{n} consecutive loaded ticks")
        else:
            self._shed_run[scope] = 0
            self._clear(key)

    def observe_key_exchange(self, scope: str,
                             reason: Optional[str]) -> None:
        """Split-plane key-exchange verdict: a non-None ``reason`` means
        the peer handshake blew its retry budget (DEGRADED until the
        exchange completes and the owner reports None again)."""
        key = f"key_exchange:{scope}"
        if reason:
            self._raise(key, DEGRADED, f"{scope}: {reason}")
        else:
            self._clear(key)

    def observe_equivocation(self, counts: Dict[int, int]) -> None:
        """Per-source pruned-block counts from the integrity plane."""
        self._equiv = dict(counts)
        bad = {src: n for src, n in counts.items()
               if n > self.cfg.equivocation_limit}
        key = "equivocation"
        if bad:
            worst = max(bad, key=bad.get)
            self._raise(key, DEGRADED,
                        f"node {worst}: {bad[worst]} pruned blocks "
                        f"(limit {self.cfg.equivocation_limit})")
        else:
            self._clear(key)

    # -- anomaly lifecycle -----------------------------------------------

    def _raise(self, key: str, level: str, reason: str) -> None:
        if key in self._active:
            self._active[key] = f"{level}: {reason}"
            return
        self._active[key] = f"{level}: {reason}"
        self._c_anomalies.add()
        self._dump(key.split(":", 1)[0])

    def _clear(self, key: str) -> None:
        self._active.pop(key, None)

    def _dump(self, anomaly: str) -> None:
        """First-activation evidence capture: flight recorder -> disk."""
        rec = (self._recorder if self._recorder is not None
               else flight.get_recorder())
        if not self.cfg.dump_dir or not rec.enabled:
            return
        self._dumps += 1
        os.makedirs(self.cfg.dump_dir, exist_ok=True)
        tag = f"_{self.cfg.tag}" if self.cfg.tag else ""
        path = os.path.join(self.cfg.dump_dir,
                            f"flight_{anomaly}{tag}_{self._dumps}.jsonl")
        try:
            rec.dump(path)
        except OSError:
            pass  # evidence capture must never take down the pipeline

    # -- snapshot --------------------------------------------------------

    def health(self) -> dict:
        """Fold active anomalies into {status, reasons, ...}."""
        level = OK
        reasons: List[str] = []
        for key, reason in sorted(self._active.items()):
            reasons.append(f"{key} -> {reason}")
            lv = reason.split(":", 1)[0]
            if _LEVEL.get(lv, 1) > _LEVEL[level]:
                level = lv
        self._g_health.set(_LEVEL[level])
        return {"status": level, "reasons": reasons,
                "anomalies": len(self._active), "dumps": self._dumps,
                "equivocation": dict(self._equiv)}


def merge_health(parts: List) -> dict:
    """Worst-of fold of labeled ``health()`` snapshots — the cluster
    verdict for a sharded service or a federated scrape. ``parts`` is
    ``[(label, health_dict)]``; reasons and equivocation sources gain a
    ``label:`` prefix so the culprit instance stays identifiable. An
    empty list folds to a clean OK verdict; a status string outside the
    known set (version-skewed peer) is itself surfaced as DEGRADED
    rather than silently dropped or trusted."""
    merged = {"status": OK, "reasons": [], "anomalies": 0, "dumps": 0,
              "equivocation": {}}
    for label, h in parts:
        st = str(h.get("status", OK))
        if st not in _LEVEL:
            merged["reasons"].append(f"{label}: unknown status {st!r}")
            st = DEGRADED
        if _LEVEL[st] > _LEVEL[merged["status"]]:
            merged["status"] = st
        merged["reasons"].extend(
            f"{label}: {r}" for r in h.get("reasons", ()))
        merged["anomalies"] += int(h.get("anomalies", 0))
        merged["dumps"] += int(h.get("dumps", 0))
        for src, n in (h.get("equivocation") or {}).items():
            merged["equivocation"][f"{label}:{src}"] = n
    return merged

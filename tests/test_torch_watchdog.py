"""The port's health watchdog (janus_tpu_torch.obs.watchdog) against the
JAX package's, on the cases of tests/test_watchdog.py that need no
service (the service cases wait for the port's wire service).

Each case feeds both watchdogs the same observations; their ``health()``
verdicts (status, reasons, anomaly and dump counts, equivocation) must be
equal after every observation, and each dumps the same evidence files.
The recompile storm is fed the trace counts a churning shape would give:
the port runs eagerly and keeps no trace counter of its own.
"""
import json

import pytest
import torch

from janus_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from janus_tpu.obs.metrics import Registry as JaxRegistry
from janus_tpu.obs.watchdog import HealthWatchdog as JaxHealthWatchdog
from janus_tpu.obs.watchdog import WatchdogConfig as JaxWatchdogConfig
from janus_tpu.obs.watchdog import merge_health as jax_merge_health

from janus_tpu_torch.obs import HealthWatchdog, WatchdogConfig, merge_health
from janus_tpu_torch.obs.flight import FlightRecorder
from janus_tpu_torch.obs.metrics import Registry
from janus_tpu_torch.obs.watchdog import DEGRADED, OK, STALLED

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def _pair(tmp_path=None, enabled=True, **kw):
    out = []
    for rec_cls, wd_cls, cfg_cls, reg_cls, sub in (
            (FlightRecorder, HealthWatchdog, WatchdogConfig, Registry, "port"),
            (JaxFlightRecorder, JaxHealthWatchdog, JaxWatchdogConfig,
             JaxRegistry, "jax")):
        rec = rec_cls(capacity=64, enabled=enabled)
        rec.event("c1", "seal", "S", detail=10)  # something to dump
        dump = str(tmp_path / sub) if tmp_path is not None else None
        out.append(wd_cls(cfg_cls(dump_dir=dump, **kw), registry=reg_cls(),
                          recorder=rec))
    return out


def _feed(pair, method, *args):
    """Feed one observation to both; their verdicts must agree."""
    mine, ref = pair
    getattr(mine, method)(*args)
    getattr(ref, method)(*args)
    h = mine.health()
    assert h == ref.health(), (method, args)
    return h


def _dumps(tmp_path, pattern):
    got = sorted(p.name for p in (tmp_path / "port").glob(pattern))
    want = sorted(p.name for p in (tmp_path / "jax").glob(pattern))
    assert got == want
    return got


def test_health_ok_when_quiet():
    mine, ref = _pair()
    h = mine.health()
    assert h == ref.health()
    assert h["status"] == OK and h["reasons"] == [] and h["dumps"] == 0


def test_commit_stall_detects_clears_and_dumps_once_per_activation(tmp_path):
    pair = _pair(tmp_path, stall_ticks=3)
    for _ in range(10):
        h = _feed(pair, "observe_commits", "pnc", 7, 12)
    assert h["status"] == STALLED
    assert any("no commit" in r for r in h["reasons"])
    assert len(_dumps(tmp_path, "flight_commit_stall_*.jsonl")) == 1
    assert _feed(pair, "observe_commits", "pnc", 8, 12)["status"] == OK
    for _ in range(10):
        h = _feed(pair, "observe_commits", "pnc", 8, 12)
    assert h["status"] == STALLED
    assert len(_dumps(tmp_path, "flight_commit_stall_*.jsonl")) == 2
    row = json.loads((tmp_path / "port" / _dumps(
        tmp_path, "flight_commit_stall_*.jsonl")[0]).read_text())
    assert row["trace_id"] == "c1"


def test_drained_queue_is_not_a_stall():
    pair = _pair(stall_ticks=2)
    for _ in range(10):
        h = _feed(pair, "observe_commits", "pnc", 5, 0)
    assert h["status"] == OK


def test_no_dump_when_recorder_disabled(tmp_path):
    pair = _pair(tmp_path, enabled=False, stall_ticks=1)
    for _ in range(5):
        h = _feed(pair, "observe_commits", "x", 1, 1)
    assert h["status"] == STALLED
    assert not (tmp_path / "port").exists()


def test_recompile_storm_fires_on_shape_churn():
    pair = _pair(recompile_window=8, recompile_limit=3)
    for count in range(1, 6):  # a new shape, so a new trace, every tick
        h = _feed(pair, "observe_trace_count", "store", count)
    assert h["status"] == DEGRADED
    assert any("retraces" in r for r in h["reasons"])


def test_stable_shapes_no_storm():
    pair = _pair(recompile_window=8, recompile_limit=3)
    for _ in range(20):
        h = _feed(pair, "observe_trace_count", "store", 1)
    assert h["status"] == OK


def test_overflow_streak_degrades_then_clears():
    pair = _pair(overflow_streak=4)
    for total in range(1, 7):
        h = _feed(pair, "observe_overflow", "orset", total)
    assert h["status"] == DEGRADED
    assert any("overflowed" in r for r in h["reasons"])
    assert _feed(pair, "observe_overflow", "orset", 6)["status"] == OK


def test_equivocation_flags_worst_node():
    pair = _pair(equivocation_limit=0)
    h = _feed(pair, "observe_equivocation", {3: 0, 7: 5})
    assert h["status"] == DEGRADED
    assert any("node 7" in r for r in h["reasons"])
    assert h["equivocation"] == {3: 0, 7: 5}
    assert _feed(pair, "observe_equivocation", {3: 0, 7: 0})["status"] == OK


def test_shed_storm_counts_loaded_ticks_only(tmp_path):
    pair = _pair(tmp_path, shed_storm_ticks=3, shed_storm_frac=0.5)
    shed = offered = 0
    assert _feed(pair, "observe_shed", "s0", shed, offered)["status"] == OK
    for _ in range(2):
        shed, offered = shed + 60, offered + 100
        assert _feed(pair, "observe_shed", "s0", shed, offered)["status"] == OK
    # an idle tick between must not reset the streak
    assert _feed(pair, "observe_shed", "s0", shed, offered)["status"] == OK
    shed, offered = shed + 60, offered + 100
    h = _feed(pair, "observe_shed", "s0", shed, offered)
    assert h["status"] == DEGRADED
    assert any("shed_storm:s0" in r for r in h["reasons"])
    assert len(_dumps(tmp_path, "flight_shed_storm_*.jsonl")) == 1
    shed, offered = shed + 60, offered + 100
    _feed(pair, "observe_shed", "s0", shed, offered)
    assert len(_dumps(tmp_path, "flight_shed_storm_*.jsonl")) == 1
    offered += 100  # a loaded tick below the fraction clears and re-arms
    assert _feed(pair, "observe_shed", "s0", shed, offered)["status"] == OK
    for _ in range(3):
        shed, offered = shed + 60, offered + 100
        h = _feed(pair, "observe_shed", "s0", shed, offered)
    assert h["status"] == DEGRADED
    assert len(_dumps(tmp_path, "flight_shed_storm_*.jsonl")) == 2


def test_shed_below_fraction_never_storms():
    pair = _pair(shed_storm_ticks=2, shed_storm_frac=0.5)
    shed = offered = 0
    _feed(pair, "observe_shed", "s0", shed, offered)
    for _ in range(10):
        shed, offered = shed + 10, offered + 100
        h = _feed(pair, "observe_shed", "s0", shed, offered)
    assert h["status"] == OK


def test_key_exchange_verdict_sets_and_clears():
    pair = _pair()
    h = _feed(pair, "observe_key_exchange", "pnc",
              "key exchange incomplete after 512 steps (missing nodes [3])")
    assert h["status"] == DEGRADED
    assert any("key_exchange:pnc" in r and "missing nodes" in r
               for r in h["reasons"])
    assert _feed(pair, "observe_key_exchange", "pnc", None)["status"] == OK


@pytest.mark.parametrize("parts", [
    [],
    [("s0", {"status": OK, "reasons": [], "anomalies": 0, "dumps": 0,
             "equivocation": {}})],
    [("s0", {"status": STALLED, "reasons": ["commit_stall:pnc -> x"],
             "anomalies": 1, "dumps": 1, "equivocation": {3: 2}}),
     ("s1", {"status": DEGRADED, "reasons": ["r"], "anomalies": 2,
             "dumps": 0, "equivocation": {1: 1}})],
    [("s0", {"status": "WEIRD"}), ("s1", {"status": OK})],
], ids=["empty", "one_ok", "worst_of", "unknown_status"])
def test_merge_health_matches_jax(parts):
    assert merge_health(parts) == jax_merge_health(parts)

"""The port's tensor-mode harness (janus_tpu_torch.bench.harness,
``run_tensor`` and ``run_tensor_adaptive`` on the CPU) against the JAX
package's.

Both run the same config from the same seed, so they draw the same op
batches; the statistics that do not depend on the clock must be equal:
the ops counted, the commit lag in rounds (p50, p99), the number of safe
updates timed, and for a Byzantine run the pruned blocks and the
watchdog's verdict; for the adaptive drive at fixed B the block trace.
Wall-clock figures are not compared. With the controller on, B follows
the measured seal milliseconds, which differ between the two packages
and between runs: that run is held to invariants instead (B within floor
and ceiling, on the quantum, every target the controller's law applied to
the recorded observations, every resize counted).
"""
import dataclasses

import numpy as np
import pytest
import torch

from janus_tpu.bench import harness as jax_harness

from janus_tpu_torch.bench import harness

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CONFIGS = {
    # tests/test_harness.py::test_tensor_mode_pnc_small's config
    "pnc_small": dict(name="t", type_code="pnc", num_nodes=4, window=8,
                      num_objects=16, ops_per_block=8, ticks=20,
                      ops_ratio=(0.2, 0.4, 0.4)),
    # preset mixed shrunk to 4 nodes
    "mixed_small": dict(name="m", type_code="mixed", num_nodes=4, window=8,
                        num_objects=16, ops_per_block=8, ticks=12,
                        key_pattern="zipf", orset_capacity=8,
                        orset_rm_capacity=2, ops_ratio=(0.3, 0.5, 0.2)),
    # preset byzantine shrunk to 4 nodes, one of them injecting
    "byzantine_small": dict(name="b", type_code="orset", num_nodes=4,
                            window=8, num_objects=16, ops_per_block=8,
                            ticks=8, orset_capacity=8, orset_rm_capacity=2,
                            byzantine=1, invalid_rate=0.5,
                            ops_ratio=(0.0, 0.8, 0.2)),
}
# preset orset_fixed_light shrunk to 4 nodes
ADAPTIVE = dict(name="a", type_code="orset", mode="adaptive", adaptive=False,
                num_nodes=4, window=8, num_objects=16, ops_per_block=64,
                ticks=12, offered_per_tick=16, orset_capacity=8,
                orset_rm_capacity=2, block_floor=16, ops_ratio=(0.0, 1.0, 0.0))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_tensor_matches_jax(name):
    want = jax_harness.run_tensor(jax_harness.BenchConfig(**CONFIGS[name]))
    observe = {}
    got = harness.run_tensor(harness.BenchConfig(**CONFIGS[name]),
                             device="cpu", observe=observe)
    assert got.total_ops == want.total_ops > 0
    for key in ("commit_lag_ticks_p50", "commit_lag_ticks_p99"):
        assert got.extra[key] == want.extra[key], key
    gd, wd = got.to_dict(), want.to_dict()
    assert (gd["latency"]["safeUpdate"]["count"]
            == wd["latency"]["safeUpdate"]["count"] > 0)
    assert gd["latency"]["get"]["count"] == wd["latency"]["get"]["count"]
    assert set(gd) == set(wd)  # the same report, key for key
    # every absorbed round is recorded, each type in its own order
    codes = [code for code, _, _ in observe["rounds"]]
    assert sorted(set(codes)) == sorted(observe["kvs"])
    assert all(kv.stats["ticks"] == codes.count(c)
               for c, kv in observe["kvs"].items())
    if "pruned_blocks" in want.extra:
        assert got.extra["pruned_blocks"] == want.extra["pruned_blocks"] > 0
        assert got.extra["health"] == want.extra["health"]
        assert got.extra["health"]["status"] == "DEGRADED"
        assert set(got.extra["health"]["equivocation"]) == {3}
        plane = observe["planes"]["orset"]
        assert plane.pruned_blocks() == sorted(plane.pruned_blocks())


def test_run_tensor_adaptive_fixed_b_matches_jax():
    want = jax_harness.run_tensor_adaptive(jax_harness.BenchConfig(**ADAPTIVE))
    got = harness.run_tensor_adaptive(harness.BenchConfig(**ADAPTIVE),
                                      device="cpu")
    assert got.total_ops == want.total_ops > 0
    gd, wd = got.to_dict(), want.to_dict()
    assert set(gd) == set(wd)
    assert (gd["latency"]["safeUpdate"]["count"]
            == wd["latency"]["safeUpdate"]["count"] > 0)
    for key in ("block_trace", "block_final", "block_resizes",
                "resize_refusals", "window", "adaptive", "offered_per_tick",
                "block_ceiling", "block_floor"):
        assert got.extra[key] == want.extra[key], key
    assert set(got.extra["stages"]) == set(want.extra["stages"])
    assert got.extra["block_trace"] == [64] * len(want.extra["block_trace"])


def test_run_tensor_adaptive_controller_invariants():
    """The controller on, with a latency target every CPU seal misses: B
    walks down from the ceiling; the targets depend on measured times, so
    the run is held to the controller's own law, not to JAX's numbers."""
    from janus_tpu_torch.obs.metrics import Registry

    cfg = harness.BenchConfig(**{**ADAPTIVE, "adaptive": True,
                                 "latency_target_ms": 0.001, "ticks": 16})
    observe = {}
    res = harness.run_tensor_adaptive(cfg, device="cpu", observe=observe)
    ticks, kv = observe["ticks"], observe["kv"]
    b_max, floor = cfg.ops_per_block, cfg.block_floor
    quantum = min(64, b_max)
    sched = harness.adaptive_scheduler(cfg, registry=Registry())
    resized = refused = 0
    for b, backlog, seal_ms, target, done in ticks:
        assert floor <= b <= b_max and (b == floor or b % quantum == 0
                                        or b < quantum)
        sched.observe(backlog, seal_ms)
        assert sched.maybe_adjust() == target
        resized += done is True
        refused += done is False
    assert resized > 0, "the controller never resized the blocks"
    assert res.extra["block_resizes"] == kv.stats["block_resizes"] == resized
    assert res.extra["resize_refusals"] == refused
    assert res.extra["block_final"] == kv.B < b_max
    assert min(res.extra["block_trace"]) >= floor
    assert kv.ops_buffer["op"].shape[2] == kv.B


def test_run_dispatches_by_mode(monkeypatch):
    calls = []
    monkeypatch.setattr(harness, "run_tensor", lambda cfg, device=None,
                        observe=None: calls.append(("t", device)))
    monkeypatch.setattr(harness, "run_tensor_adaptive", lambda cfg,
                        device=None, observe=None: calls.append(("a", device)))
    harness.run(harness.BenchConfig(**CONFIGS["pnc_small"]), device="cpu")
    harness.run(harness.BenchConfig(**ADAPTIVE), device="cpu")
    assert calls == [("t", "cpu"), ("a", "cpu")]
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        harness.run(harness.PRESETS["rga"], device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 items 3-4"):
        harness.run(harness.PRESETS["wire_native"], device="cpu")


def test_main_runs_a_config_through_run(tmp_path, capsys):
    import json

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({**ADAPTIVE, "ticks": 2,
                                "ops_ratio": list(ADAPTIVE["ops_ratio"])}))
    harness.main(["--config", str(path), "--device", "cpu", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "adaptive" and out["block_final"] == 64


def test_presets_load_and_match_jax():
    assert harness.PRESETS.keys() == jax_harness.PRESETS.keys()
    for name, cfg in harness.PRESETS.items():
        assert cfg.num_nodes >= 4, name
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jax_harness.PRESETS[name])), name
        assert harness.BenchConfig.from_json(
            __import__("json").dumps({"name": name})).name == name
    assert harness.DRIVE_DEPTH == jax_harness.DRIVE_DEPTH


@pytest.mark.parametrize("change,error,match", [
    (dict(mode="wire"), NotImplementedError, "queue 1 items 3-4"),
    (dict(mode="overload"), NotImplementedError, "queue 1 items 3-4"),
    (dict(mode="store_delta"), NotImplementedError, "queue 1 item 2"),
    (dict(byzantine=1, crashed=1), ValueError, "byzantine \\+ crashed"),
])
def test_unported_modes_raise(change, error, match):
    cfg = dataclasses.replace(harness.BenchConfig(**CONFIGS["pnc_small"]),
                              **change)
    with pytest.raises(error, match=match):
        harness.run_tensor(cfg, device="cpu")


def test_run_tensor_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_tensor(harness.BenchConfig(**CONFIGS["pnc_small"]))
    for cfg in (CONFIGS["byzantine_small"], ADAPTIVE):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            harness.run(harness.BenchConfig(**cfg))


def test_results_report_matches_jax_shape():
    cfg = harness.BenchConfig(**CONFIGS["pnc_small"])
    res = harness.Results(cfg)
    res.stats["get"].latencies_ms.extend(np.linspace(0.1, 1.0, 10).tolist())
    res.total_ops, res.elapsed_s = 100, 0.5
    jres = jax_harness.Results(jax_harness.BenchConfig(**CONFIGS["pnc_small"]))
    jres.stats["get"].latencies_ms.extend(np.linspace(0.1, 1.0, 10).tolist())
    jres.total_ops, jres.elapsed_s = 100, 0.5
    assert res.to_dict() == jres.to_dict()

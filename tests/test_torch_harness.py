"""The port's tensor-mode harness (janus_tpu_torch.bench.harness,
``run_tensor`` on the CPU) against the JAX package's.

Both run the same config from the same seed, so they draw the same op
batches; the statistics that do not depend on the clock must be equal:
the ops counted, the commit lag in rounds (p50, p99) and the number of
safe updates timed. Wall-clock figures are not compared.
"""
import dataclasses

import numpy as np
import pytest

from janus_tpu.bench import harness as jax_harness

from janus_tpu_torch.bench import harness

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
}


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


def test_presets_load_and_match_jax():
    assert harness.PRESETS.keys() == jax_harness.PRESETS.keys()
    for name, cfg in harness.PRESETS.items():
        assert cfg.num_nodes >= 4, name
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jax_harness.PRESETS[name])), name
        assert harness.BenchConfig.from_json(
            __import__("json").dumps({"name": name})).name == name
    assert harness.DRIVE_DEPTH == jax_harness.DRIVE_DEPTH


@pytest.mark.parametrize("change,match", [
    (dict(mode="wire"), "queue 1 items 3-4"),
    (dict(mode="adaptive"), "queue 1 item 2"),
    (dict(byzantine=1), "queue 1 item 1"),
    (dict(byzantine=1, crashed=1), "queue 1 item 1"),
])
def test_unported_modes_raise(change, match):
    cfg = dataclasses.replace(harness.BenchConfig(**CONFIGS["pnc_small"]),
                              **change)
    with pytest.raises(NotImplementedError, match=match):
        harness.run_tensor(cfg, device="cpu")


def test_run_tensor_needs_a_gpu_unless_told_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_tensor(harness.BenchConfig(**CONFIGS["pnc_small"]))


def test_results_report_matches_jax_shape():
    cfg = harness.BenchConfig(**CONFIGS["pnc_small"])
    res = harness.Results(cfg)
    res.stats["get"].latencies_ms.extend(np.linspace(0.1, 1.0, 10).tolist())
    res.total_ops, res.elapsed_s = 100, 0.5
    jres = jax_harness.Results(jax_harness.BenchConfig(**CONFIGS["pnc_small"]))
    jres.stats["get"].latencies_ms.extend(np.linspace(0.1, 1.0, 10).tolist())
    jres.total_ops, jres.elapsed_s = 100, 0.5
    assert res.to_dict() == jres.to_dict()

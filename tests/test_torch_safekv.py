"""Parity of the port's SafeKV (janus_tpu_torch, on the CPU) with the JAX
package's SafeKV for the PN-Counter.

One seeded numpy workload drives both: N=4 nodes, window W=8, B=16 ops
per block, K=8 keys, 40 rounds, half the ops safe, node 3 crashed for
rounds 10-17. Every comparison is bit-equal (tolerance exactly 0): all
device state and the packed round output after every round, then the
drained safe acks, the total-order logs, the latency log, the stats and
both queries. A second port instance takes over the JAX run's state at
round 20 (GC frontier above 0) through ``load_state`` and must continue
identically.
"""
import copy

import numpy as np
import pytest

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.runtime import safecrdt

N, W, B, K = 4, 8, 16, 8
ROUNDS = 40
CRASHED = range(10, 18)  # rounds during which node 3 is down
HANDOVER = 20


def _workload():
    rng = np.random.default_rng(11)
    rounds = []
    for t in range(ROUNDS):
        ops = workloads.pnc_uniform(rng, N, K, B)
        safe = rng.random((N, B)) < 0.5
        active = np.ones((N,), bool)
        if t in CRASHED:
            active[3] = False
        rounds.append((ops, safe, active))
    return rounds


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


def _assert_tree_equal(a, b, where):
    """Bit-equal: same keys, dtypes, shapes and values (tolerance 0)."""
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{where}.{k}")


@pytest.fixture(scope="module")
def jax_run():
    """One JAX run shared by the module's tests."""
    rounds = _workload()
    kv = JaxSafeKV(JaxDagConfig(N, W), jax_pnc.SPEC, ops_per_block=B,
                   num_keys=K, num_writers=N)
    out = {"packed": [], "state": [], "acks": []}
    for t, (ops, safe, active) in enumerate(rounds):
        if t == HANDOVER:
            out["handover"] = {
                **_device_state(kv),
                **{f: copy.deepcopy(getattr(kv, f))
                   for f in safecrdt.HOST_FIELDS}}
        packed, meta = kv.step_dispatch(ops, safe, active=active)
        kv.step_absorb(packed, meta)
        out["packed"].append(np.asarray(packed))
        out["state"].append(_device_state(kv))
        out["acks"].append(kv.drain_safe_acks())
    out["final"] = {
        "ordered": [kv.ordered_commits(v) for v in range(N)],
        "latency": list(kv.latency_log),
        "stats": dict(kv.stats),
        "prospective": np.asarray(kv.query_prospective("get")),
        "stable": np.asarray(kv.query_stable("get")),
        "base_round": kv.base_round(),
    }
    return rounds, out


def _port_kv():
    return safecrdt.SafeKV(DagConfig(N, W), pncounter.SPEC, ops_per_block=B,
                           device="cpu", num_keys=K, num_writers=N)


def _drive_and_compare(kv, rounds, ref, start):
    for t in range(start, ROUNDS):
        ops, safe, active = rounds[t]
        packed, meta = kv.step_dispatch(ops, safe, active=active)
        np.testing.assert_array_equal(packed.numpy(), ref["packed"][t],
                                      err_msg=f"packed round {t}")
        kv.step_absorb(packed, meta)
        _assert_tree_equal(_device_state(kv), ref["state"][t], f"round {t}")
        np.testing.assert_array_equal(kv.drain_safe_acks(), ref["acks"][t],
                                      err_msg=f"safe acks round {t}")
    fin = ref["final"]
    assert [kv.ordered_commits(v) for v in range(N)] == fin["ordered"]
    assert kv.latency_log == fin["latency"]
    assert kv.stats == fin["stats"]
    assert kv.base_round() == fin["base_round"]
    np.testing.assert_array_equal(kv.query_prospective("get").numpy(),
                                  fin["prospective"])
    np.testing.assert_array_equal(kv.query_stable("get").numpy(), fin["stable"])


def test_safekv_matches_jax_every_round_with_crash(jax_run):
    rounds, ref = jax_run
    # the run exercises what it claims to: GC advanced, a crashed node was
    # state-transferred back, safe acks fired
    assert ref["final"]["stats"]["gc_advances"] > 0
    assert ref["final"]["stats"]["state_transfers"] > 0
    assert sum(int(a.sum()) for a in ref["acks"]) > 0
    _drive_and_compare(_port_kv(), rounds, ref, 0)


def test_safekv_state_carried_across_mid_run(jax_run):
    rounds, ref = jax_run
    handover = ref["handover"]
    assert int(handover["dag"]["base_round"]) > 0  # GC frontier above 0
    kv = _port_kv()
    kv.load_state(handover)
    _assert_tree_equal(_device_state(kv), ref["state"][HANDOVER - 1],
                       "after load_state")
    _drive_and_compare(kv, rounds, ref, HANDOVER)


@pytest.mark.parametrize("lw,force", [
    ([9, 9, 9, 6], [False] * 4),   # lags by 3 > repair window of 2
    ([9, 9, 9, 7], [False] * 4),   # lags by 2: no transfer
    ([5, 9, 2, 9], [False, False, False, True]),
], ids=["lag3", "lag2", "forced"])
def test_state_transfer_matches_jax(jax_run, lw, force):
    """The recovery rule alone, at the lag boundary the crash run does not
    reach (its crashed node re-enters below the GC frontier instead)."""
    _, ref = jax_run
    st = copy.deepcopy(ref["state"][25])
    st["commit"]["last_wave"] = np.asarray(lw, np.int32)
    st["force_transfer"] = np.asarray(force)
    args = [st[f] for f in ("prospective", "stable", "dag", "commit",
                            "prosp_applied", "stable_applied",
                            "force_transfer")]
    jkv = JaxSafeKV(JaxDagConfig(N, W), jax_pnc.SPEC, ops_per_block=B,
                    num_keys=K, num_writers=N)
    want = jkv._state_transfer(*args)
    got = _port_kv()._state_transfer(*convert.tree_from_numpy(
        dict(enumerate(args)), "cpu").values())
    for i, (x, y) in enumerate(zip(got, want)):
        if isinstance(x, dict):
            _assert_tree_equal(convert.tree_to_numpy(x), y, f"output {i}")
        else:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f"output {i}")


def test_step_k_matches_jax():
    """K=4 rounds per dispatch (a Python loop in the port, one lax.scan
    in JAX): the stacked packed outputs, the state and the logs after
    five dispatches are bit-equal."""
    rounds = _workload()
    jkv = JaxSafeKV(JaxDagConfig(N, W), jax_pnc.SPEC, ops_per_block=B,
                    num_keys=K, num_writers=N)
    kv = _port_kv()
    k = 4
    for d in range(5):
        chunk = rounds[d * k:(d + 1) * k]
        ops_k = {f: np.stack([c[0][f] for c in chunk]) for f in chunk[0][0]}
        safe_k = np.stack([c[1] for c in chunk])
        jp, jm = jkv.step_k_dispatch(ops_k, safe_k=safe_k)
        tp, tm = kv.step_k_dispatch(ops_k, safe_k=safe_k)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp),
                                      err_msg=f"packed_k dispatch {d}")
        ji, ti = jkv.step_k_absorb(jp, jm), kv.step_k_absorb(tp, tm)
        for a, b in zip(ji, ti):
            np.testing.assert_array_equal(a["own"], b["own"])
        _assert_tree_equal(_device_state(kv), _device_state(jkv),
                           f"dispatch {d}")
    assert kv.commit_log == jkv.commit_log
    assert kv.latency_log == jkv.latency_log and kv.stats == jkv.stats
    np.testing.assert_array_equal(kv.drain_safe_acks(), jkv.drain_safe_acks())


def test_state_arrays_round_trip():
    rounds = _workload()
    a, b = _port_kv(), _port_kv()
    for ops, safe, active in rounds[:12]:
        a.step(ops, safe, active=active)
    b.load_state(a.state_arrays())
    for ops, safe, active in rounds[12:16]:
        ia = a.step(ops, safe, active=active)
        ib = b.step(ops, safe, active=active)
        np.testing.assert_array_equal(ia["own"], ib["own"])
    _assert_tree_equal(_device_state(a), _device_state(b), "round trip")
    assert a.commit_log == b.commit_log and a.stats == b.stats

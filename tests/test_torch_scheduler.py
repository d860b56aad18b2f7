"""The port's AIMD block-size controller (janus_tpu_torch.obs.scheduler)
and its actuator, ``SafeKV.resize_block`` with the ``ring_resize`` kernel's
plain version (on the CPU), against the JAX package's.

The controller cases are those of tests/test_scheduler.py: both
controllers get the same observation sequence and must return the same
target, block size, shed probability and hold-off after every adjust (an
exact comparison: both compute in Python floats). The resize cases run a
JAX SafeKV and the port's in lockstep (N=4, PN-Counter and OR-Set with its
capture extras) through a grow, a refused shrink, a shrink retried until
the ring has recycled its tail, and a same-size no-op; every round's
packed output and every device array after it are bit-equal (tolerance
0). ``ring_resize_plain`` is held bit-equal to the JAX method on random
rings with the OR-Set's and the MVRegister's extras.
"""
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import mvregister as jax_mvr
from janus_tpu.models import orset as jax_orset
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.obs.metrics import Registry as JaxRegistry
from janus_tpu.obs.scheduler import AdaptiveTick as JaxAdaptiveTick
from janus_tpu.obs.scheduler import SchedulerConfig as JaxSchedulerConfig
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import orset, pncounter
from janus_tpu_torch.obs.metrics import Registry
from janus_tpu_torch.obs.scheduler import AdaptiveTick, SchedulerConfig
from janus_tpu_torch.runtime import safecrdt
from janus_tpu_torch.utils.ids import TagMinter

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)


def _obs(backlog, seal, delta=None, slo=None):
    return ("observe", backlog, seal, delta, slo)


def _slo(goodput, p99, depth):
    return _obs(0, 1.0, slo=(goodput, p99, depth))


SLO_CFG = dict(b_min=64, b_max=1024, window=8, adjust_every=1,
               slo_p99_target_ms=100.0, wait0_ms=10.0, wait_min_ms=1.0,
               wait_max_ms=50.0)

# name -> (SchedulerConfig kwargs, b0, observations, check of the port's
# controller after the run); each observation is followed by an adjust
CASES = {
    "trickle_slow_seal_shrinks_to_floor": (
        dict(b_min=64, b_max=5120, window=8, latency_target_ms=50.0,
             adjust_every=2), 5120, [_obs(10, 400.0)] * 40,
        lambda s: s.b == 64),
    "fast_seal_never_shrinks": (
        dict(b_min=64, b_max=5120, window=8, latency_target_ms=50.0,
             adjust_every=2), 1024, [_obs(10, 5.0)] * 20,
        lambda s: s.b == 1024),
    "saturation_grows_to_ceiling": (
        dict(b_min=64, b_max=5120, window=8, grow_step=512, adjust_every=2),
        64, [_obs(10_000, 5.0)] * 60, lambda s: s.b == 5120),
    "delta_overflow_is_shrink_pressure": (
        dict(b_min=64, b_max=5120, window=8, latency_target_ms=50.0,
             adjust_every=2), 5120,
        [_obs(10_000, 5.0, delta=(0.5, True))] * 4, lambda s: s.b < 5120),
    "minority_overflow_still_grows": (
        dict(b_min=64, b_max=5120, window=8, latency_target_ms=50.0,
             adjust_every=2), 1024,
        [_obs(10_000, 5.0, delta=(0.1, i == 0)) for i in range(4)],
        lambda s: s.b > 1024),
    "never_exceeds_ring_window_bound": (
        dict(b_min=32, b_max=5120, window=8, max_inflight_ops=1024,
             quantum=32, grow_step=512, adjust_every=2), 5120,
        [_obs(10_000, 1.0)] * 40, lambda s: s.b <= 128),
    "targets_quantize": (
        dict(b_min=64, b_max=5000, window=8, quantum=64, grow_step=500,
             adjust_every=2), 64, [_obs(10_000, 1.0)] * 60,
        lambda s: s.b % 64 == 0 and s.b > 64),
    "oscillation_recovers_after_load_returns": (
        dict(b_min=64, b_max=2048, window=8, latency_target_ms=50.0,
             grow_step=512, adjust_every=2), 2048,
        [_obs(5, 300.0)] * 30 + [_obs(50_000, 5.0)] * 30,
        lambda s: s.b == 2048),
    "slo_overload_grows_shed_and_pins_wait": (
        SLO_CFG, 256, [_slo(1000.0, 500.0, 1.2)] * 21,
        lambda s: s.shed_prob == pytest.approx(0.95) and s.wait_ms == 50.0),
    "slo_deep_queue_alone_sheds": (
        SLO_CFG, 256, [_slo(1000.0, 5.0, 1.5)], lambda s: s.shed_prob > 0),
    "slo_goodput_guard_backs_off": (
        SLO_CFG, 256, [_slo(1000.0, 5.0, 0.0)] * 3
        + [_slo(500.0, 500.0, 1.2), _slo(990.0, 500.0, 1.2)]
        + [_slo(990.0, 500.0, 1.2)] * 6 + [_slo(400.0, 500.0, 1.2)] * 21,
        lambda s: s.shed_prob == 0.0),
    "slo_shallow_slow_shrinks_wait": (
        SLO_CFG, 256, [_slo(1000.0, 500.0, 1.2)]
        + [_slo(1000.0, 500.0, 0.1)] * 8,
        lambda s: s.wait_ms == 1.0 and s.shed_prob == 0.0),
    "slo_healthy_decays_shed_and_relaxes_wait": (
        SLO_CFG, 256, [_slo(1000.0, 500.0, 1.2)] * 4
        + [_slo(1000.0, 5.0, 0.0)] * 12,
        lambda s: s.shed_prob == 0.0 and abs(s.wait_ms - 10.0) < 0.5),
    "slo_laws_inert_without_target": (
        dict(b_min=64, b_max=1024, window=8, adjust_every=1, wait0_ms=10.0),
        256, [_slo(1000.0, 500.0, 2.0)] * 5,
        lambda s: s.shed_prob == 0.0 and s.wait_ms == 10.0),
}


def _drive(sched, observations):
    out = []
    for _, backlog, seal, delta, slo in observations:
        sched.observe(backlog, seal)
        if delta is not None:
            sched.observe_delta(*delta)
        if slo is not None:
            sched.observe_slo(*slo)
        out.append((sched.maybe_adjust(), sched.b, sched.shed_prob,
                    sched.wait_ms))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_controller_matches_jax(name):
    kw, b0, observations, check = CASES[name]
    mine = AdaptiveTick(SchedulerConfig(**kw), b0=b0, registry=Registry())
    ref = JaxAdaptiveTick(JaxSchedulerConfig(**kw), b0=b0,
                          registry=JaxRegistry())
    assert mine.b == ref.b
    got, want = _drive(mine, observations), _drive(ref, observations)
    assert got == want
    assert check(mine), (name, mine.b, mine.shed_prob, mine.wait_ms)


def test_targets_descend_and_ascend_monotonically():
    """The trickle walks B down strictly, saturation strictly up."""
    kw, b0, obs, _ = CASES["trickle_slow_seal_shrinks_to_floor"]
    down = [t for t, *_ in _drive(AdaptiveTick(
        SchedulerConfig(**kw), b0=b0, registry=Registry()), obs) if t]
    assert down == sorted(down, reverse=True) and down[-1] == 64
    kw, b0, obs, _ = CASES["saturation_grows_to_ceiling"]
    up = [t for t, *_ in _drive(AdaptiveTick(
        SchedulerConfig(**kw), b0=b0, registry=Registry()), obs) if t]
    assert up == sorted(up) and up[-1] == 5120


# -- actuation: SafeKV.resize_block in lockstep with the JAX package -------

N, W, K = 4, 8, 8
GEOMETRY = {"pnc": dict(B=8, grow=16, shrink=4),
            "orset": dict(B=8, grow=16, shrink=4)}


def _kvs(kind, b):
    if kind == "pnc":
        return (JaxSafeKV(JaxDagConfig(N, W), jax_pnc.SPEC, ops_per_block=b,
                          num_keys=K, num_writers=N),
                safecrdt.SafeKV(DagConfig(N, W), pncounter.SPEC,
                                ops_per_block=b, device="cpu", num_keys=K,
                                num_writers=N))
    dims = dict(num_keys=K, capacity=8, rm_capacity=3)
    return (JaxSafeKV(JaxDagConfig(N, W), jax_orset.SPEC, ops_per_block=b,
                      apply_budget=8, **dims),
            safecrdt.SafeKV(DagConfig(N, W), orset.SPEC, ops_per_block=b,
                            apply_budget=8, device="cpu", **dims))


class _Ops:
    """Seeded batches at the SafeKV's current B, ``live`` lanes filled."""

    def __init__(self, kind):
        self.kind = kind
        self.rng = np.random.default_rng(5)
        self.minters = [TagMinter(v) for v in range(N)]

    def __call__(self, b, live):
        if self.kind == "pnc":
            ops = workloads.pnc_uniform(self.rng, N, K, b)
        else:
            ops = workloads.orset_add_remove(self.rng, self.minters, K, b,
                                             num_elems=6)
        for f in ops:
            ops[f][:, live:] = 0
        safe = np.zeros((N, b), bool)
        safe[:, :live] = self.rng.random((N, live)) < 0.5
        return ops, safe


def _state(kv):
    return convert.tree_to_numpy(
        {**{f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS},
         "safe_host": kv.safe_host, "pending": kv.pending_safe_acks})


def _assert_equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape, where
    np.testing.assert_array_equal(x, y, err_msg=where)


def _step_both(ref, mine, gen, live, where):
    ops, safe = gen(mine.B, live)
    jp, jm = ref.step_dispatch(ops, safe)
    tp, tm = mine.step_dispatch(ops, safe)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp),
                                  err_msg=f"packed {where}")
    ref.step_absorb(jp, jm)
    mine.step_absorb(tp, tm)
    _assert_equal(_state(mine), _state(ref), where)
    # a host drains its acks: an undrained ack pins its lane, as in JAX
    np.testing.assert_array_equal(mine.drain_safe_acks(),
                                  ref.drain_safe_acks(), err_msg=where)


@pytest.fixture(scope="module", params=sorted(GEOMETRY))
def lockstep(request):
    """The resize cases of tests/test_scheduler.py, run on both SafeKVs
    in lockstep; returns what each resize returned, both ways."""
    kind = request.param
    g = GEOMETRY[kind]
    ref, mine = _kvs(kind, g["B"])
    gen = _Ops(kind)
    log = {"kind": kind}
    for t in range(4):
        _step_both(ref, mine, gen, 2, f"warm {t}")
    log["grow"] = (mine.resize_block(g["grow"]), ref.resize_block(g["grow"]))
    _assert_equal(_state(mine), _state(ref), "after grow")
    for t in range(3):
        _step_both(ref, mine, gen, 3 + t, f"after grow {t}")
    # a full-width round parks live ops in the tail lanes
    _step_both(ref, mine, gen, mine.B, "full width")
    log["refused"] = (mine.resize_block(g["shrink"]),
                      ref.resize_block(g["shrink"]))
    log["B_after_refusal"] = (mine.B, ref.B)
    tries = []
    for t in range(4 * W):
        _step_both(ref, mine, gen, 2, f"retry {t}")
        done = (mine.resize_block(g["shrink"]), ref.resize_block(g["shrink"]))
        tries.append(done)
        if done[1]:
            break
    log["retries"] = tries
    _assert_equal(_state(mine), _state(ref), "after shrink")
    for t in range(3):
        _step_both(ref, mine, gen, min(2, mine.B), f"after shrink {t}")
    log["noop"] = (mine.resize_block(mine.B), ref.resize_block(ref.B))
    log["resizes"] = (mine.stats["block_resizes"], ref.stats["block_resizes"])
    log["B"] = (mine.B, ref.B)
    log["stats"] = (dict(mine.stats), dict(ref.stats))
    return log


def test_resize_block_grow_matches_jax(lockstep):
    assert lockstep["grow"] == (True, True)


def test_resize_block_shrink_refused_then_taken_like_jax(lockstep):
    assert lockstep["refused"] == (False, False)
    b = GEOMETRY[lockstep["kind"]]["grow"]
    assert lockstep["B_after_refusal"] == (b, b)
    tries = lockstep["retries"]
    assert all(m == r for m, r in tries)
    assert tries[-1] == (True, True)
    shrink = GEOMETRY[lockstep["kind"]]["shrink"]
    assert lockstep["B"] == (shrink, shrink)


def test_resize_block_noop_and_counts_match_jax(lockstep):
    assert lockstep["noop"] == (True, True)
    assert lockstep["resizes"] == (2, 2)
    mine, ref = lockstep["stats"]
    assert mine == ref and mine["gc_advances"] > 0


def test_resize_block_refuses_a_round_in_flight():
    _, kv = _kvs("pnc", 8)
    ops, safe = _Ops("pnc")(8, 2)
    packed, meta = kv.step_dispatch(ops, safe)
    with pytest.raises(RuntimeError, match="not absorbed"):
        kv.resize_block(16)
    kv.step_absorb(packed, meta)
    assert kv.resize_block(16) and kv.B == 16
    assert not kv.resize_block(0)


# -- ring_resize's plain version against the JAX method -------------------

def _jax_ring_kv(kind, b):
    if kind == "orset":
        return JaxSafeKV(JaxDagConfig(N, W), jax_orset.SPEC, ops_per_block=b,
                         num_keys=K, capacity=8, rm_capacity=3)
    return JaxSafeKV(JaxDagConfig(N, W), jax_mvr.SPEC, ops_per_block=b,
                     num_keys=K, num_writers=5, capacity=3)


@pytest.mark.parametrize("kind,b,new_b,live_tail", [
    ("orset", 8, 12, False),      # grow
    ("orset", 8, 3, False),       # shrink, tail clean
    ("orset", 8, 3, True),        # shrink refused: a live tail lane
    ("orset", 8, 7, True),        # the last lane alone is live
    ("mvregister", 6, 9, False),  # wclock extra of width num_writers
    ("mvregister", 6, 2, True),
    # B' not a multiple of 4 (rows off the kernel's 16-byte path), the
    # OR-Set's capture extras of width 3, grows and shrinks, tails live
    # and clean
    ("orset", 8, 5, False),
    ("orset", 8, 5, True),
    ("orset", 7, 13, False),
    ("orset", 12, 9, True),
    ("mvregister", 9, 6, False),
    ("mvregister", 5, 11, False),
    ("mvregister", 13, 3, True),
])
def test_ring_resize_plain_matches_jax(kind, b, new_b, live_tail):
    import jax.numpy as jnp

    ref = _jax_ring_kv(kind, b)
    rng = np.random.default_rng(b * 100 + new_b)
    ring = {}
    for f, x in ref.ops_buffer.items():
        v = rng.integers(-2**31, 2**31 - 1, x.shape, dtype=np.int64)
        ring[f] = v.astype(np.int32)
    op = rng.integers(1, 4, (W, N, b)).astype(np.int32)
    if new_b < b:
        op[:, :, new_b:] = 0  # OP_NOOP past the cut
        if live_tail:
            op[3, 1, b - 1 if new_b == b - 1 else new_b] = 2
    ring["op"] = op
    ref.ops_buffer = {f: jnp.asarray(v) for f, v in ring.items()}
    ok = ref.resize_block(new_b)
    got, flag = kernels.ring_resize(convert.tree_from_numpy(ring, "cpu"),
                                    new_b)
    plain, plain_flag = kernels.ring_resize_plain(
        convert.tree_from_numpy(ring, "cpu"), new_b)
    assert ok == (not live_tail)
    assert int(flag.item()) == int(live_tail) == int(plain_flag.item())
    assert flag.dtype == torch.int32 and tuple(flag.shape) == (1,)
    _assert_equal(convert.tree_to_numpy(got), convert.tree_to_numpy(plain),
                  "wrapper vs plain")
    if ok:
        _assert_equal(convert.tree_to_numpy(got),
                      convert.tree_to_numpy(ref.ops_buffer), "vs JAX")
    else:
        # JAX kept its ring; the port's new ring is the kept prefix anyway
        for f, x in got.items():
            np.testing.assert_array_equal(x.numpy(), ring[f][:, :, :new_b])


def _storages(ring):
    return {x.untyped_storage().data_ptr() for x in ring.values()}


def test_resize_block_shares_one_buffer_and_carries_on_like_jax():
    """The resized ring's fields are views of one buffer (ring_layout) with
    the flag after them: a round after each resize, a second resize of a
    shared ring (to a B not a multiple of 4 and back), and state_arrays
    loaded into a fresh SafeKV that carries on, all bit-equal to JAX."""
    ref, mine = _kvs("orset", 8)
    gen = _Ops("orset")
    _step_both(ref, mine, gen, 2, "warm")
    assert len(_storages(mine.ops_buffer)) == len(mine.ops_buffer)
    for b in (11, 16, 13):
        assert mine.resize_block(b) and ref.resize_block(b), b
        ring = mine.ops_buffer
        assert len(_storages(ring)) == 1
        assert all(x.is_contiguous() and x.data_ptr() % 16 == 0
                   for x in ring.values())
        _assert_equal(_state(mine), _state(ref), f"after resize to {b}")
        _step_both(ref, mine, gen, 3, f"round at B {b}")
    arrays = mine.state_arrays()
    _, fresh = _kvs("orset", mine.B)
    fresh.load_state(arrays)
    _assert_equal(_state(fresh), _state(ref), "loaded")
    for t in range(3):
        _step_both(ref, fresh, gen, 3, f"loaded round {t}")
    assert fresh.resize_block(9) == ref.resize_block(9)
    _step_both(ref, fresh, gen, 2, "after the loaded run's resize")

"""Parity of the port's MVRegister (janus_tpu_torch, on the CPU) with the
JAX package's: the vector-clock helpers (``clock_leq``,
``clock_dominates``, ``clock_compare``), the apply captured and
uncaptured (``mvr_apply``), the single-op capture (``capture_and_apply``
through ``mvr_capture``, and the plain lane loop ``base.capture_scan``),
the join with its overflow (``merge_with_stats`` through ``mvr_merge``),
the Store's full and delta converge (``join_replicas`` and
``join_replica_rows`` through ``mvr_merge_rows``), SafeKV rounds, and
tests/test_models.py's MVRegister scenarios. On the CPU each wrapper
runs its kernel's plain version.

Inputs are seeded numpy draws handed to both packages. Hazards: keys in
[-2K, 2K) (a write reads the clamped row and writes nothing), writers in
[-2W, 2W) (the uncaptured apply's writer counts from the end, the
capture's bumps nothing), clocks at INT32_MAX (the bump wraps), exact
twins, and more concurrent writers per key than V (the frontier
overflows, so the trees must pair rows as JAX's ``join_all`` does).
Every comparison is bit-equal (int32 and bool state, int counts;
tolerance exactly 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import base as jax_base
from janus_tpu.models import mvregister as jax_mvr
from janus_tpu.ops import lattice as jax_lattice
from janus_tpu.runtime import store as jax_store
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import base, mvregister
from janus_tpu_torch.ops import lattice
from janus_tpu_torch.runtime import safecrdt, store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_mvr._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_mvr.SPEC, st, o)))
J_MERGE = jax.jit(jax.vmap(jax_mvr.merge_with_stats))

V, K, VC, WL, B = 3, 5, 3, 6, 40
INT32_MAX = 2**31 - 1


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return convert.tree_from_numpy(convert.tree_to_numpy(tree), "cpu")


def _assert_equal(got, want, where=""):
    got, want = convert.tree_to_numpy(got), convert.tree_to_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    x, y = np.asarray(got), np.asarray(want)
    assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype,
                                                       x.shape, y.shape)
    np.testing.assert_array_equal(x, y, err_msg=where)


# -- vector clocks (tests/test_lattice.py) -------------------------------------

def test_clock_compare_codes():
    a = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    assert lattice.clock_compare(a, a)[0] == lattice.CLOCK_EQUAL
    assert lattice.clock_compare(a, a + 1)[0] == lattice.CLOCK_BEFORE
    assert lattice.clock_compare(a + 1, a)[0] == lattice.CLOCK_AFTER
    b = torch.tensor([[2, 1, 3]], dtype=torch.int32)
    assert lattice.clock_compare(a, b)[0] == lattice.CLOCK_CONCURRENT
    assert not lattice.clock_dominates(a, a)[0]
    assert lattice.clock_dominates(a + 1, a)[0]
    assert lattice.clock_leq(a, a)[0]
    for name in ("CLOCK_EQUAL", "CLOCK_BEFORE", "CLOCK_AFTER",
                 "CLOCK_CONCURRENT"):
        assert getattr(lattice, name) == getattr(jax_lattice, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_clock_helpers_batched_match_jax(seed):
    """Random clocks [64, 8] in a narrow range (equal, ordered and
    concurrent pairs all common) against the JAX helpers."""
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 4, (64, 8)).astype(np.int32) for _ in range(2))
    b[:8] = a[:8]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("clock_leq", "clock_dominates", "clock_compare"):
        np.testing.assert_array_equal(
            getattr(lattice, name)(ta, tb).numpy(),
            np.asarray(getattr(jax_lattice, name)(ja, jb)), err_msg=name)


# -- apply, capture, merge ------------------------------------------------------

def _apply_case(name, rng):
    """(state [V, K, VC], ops [V, B]) of one named hazard."""
    if name == "hazards":  # keys and writers out of range, non-canonical
        st = workloads.mvr_slots(rng, (V, K), VC, WL, canonical=False)
        return st, workloads.mvr_mixed_ops(rng, (V, B), K, WL)
    if name == "captured":  # wclocks at the extremes, twins, dominated
        st = workloads.mvr_slots(rng, (V, K), VC, WL)
        return st, workloads.mvr_mixed_ops(rng, (V, B), K, WL, captured=True)
    if name == "wrap":  # observed lanes at INT32_MAX: the bump wraps
        st = workloads.mvr_slots(rng, (V, K), VC, WL)
        st["clock"][..., 1] = np.where(st["valid"], INT32_MAX, 0)
        ops = workloads.mvr_mixed_ops(rng, (V, B), K, WL, hazards=False)
        ops["writer"][:] = 1
        return st, ops
    assert name == "concurrent"  # more concurrent writers than V, one key
    st = workloads.mvr_slots(rng, (V, K), VC, WL)
    ops = workloads.mvr_mixed_ops(rng, (V, B), K, WL, hazards=False,
                                  captured=True, num_values=40)
    ops["op"][:] = mvregister.OP_WRITE
    ops["key"][:] = 2
    eye = np.eye(WL, dtype=np.int32)[np.arange(B) % WL]  # pairwise concurrent
    ops["wclock"][:] = 50 + eye
    return st, ops


@pytest.mark.parametrize("name,seed", [("hazards", 1), ("captured", 2),
                                       ("wrap", 3), ("concurrent", 4)])
def test_apply_matches_jax_scan(name, seed):
    """``apply_ops_dropped`` (the ``mvr_apply`` wrapper) against JAX's
    vmapped ``_apply_ops_impl``: the state after the batch and the drops
    per view (the frontier's overflow)."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    want_st, want_drop = J_APPLY(_jax(st), _jax(ops))
    got_st, got_drop = mvregister.apply_ops_dropped(_torch(st), _torch(ops))
    _assert_equal(got_st, want_st, name)
    _assert_equal(got_drop, want_drop, f"{name} dropped")
    if name == "concurrent":
        assert int(got_drop.sum()) > 0


@pytest.mark.parametrize("name,seed", [("hazards", 5), ("wrap", 6)])
def test_capture_matches_jax_scan(name, seed):
    """``capture_and_apply(mvregister.SPEC)`` (the ``mvr_capture`` wrapper)
    and ``base.capture_scan`` against JAX's vmapped scan: the state after
    the batch and the prepared ops with ``wclock``, a later write on a key
    dominating an earlier one of the same batch."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    want_st, want_ops = J_CAPTURE(_jax(st), _jax(ops))
    for capture in (base.capture_and_apply, base.capture_scan):
        got_st, got_ops = capture(mvregister.SPEC, _torch(st), _torch(ops))
        _assert_equal(got_ops, want_ops, f"{capture.__name__} ops")
        _assert_equal(got_st, want_st, f"{capture.__name__} state")


@pytest.mark.parametrize("canonical,span,seed", [(True, 3, 7), (False, 3, 8),
                                                 (True, 6, 9)])
def test_merge_with_stats_matches_jax(canonical, span, seed):
    """``merge_with_stats`` (``mvr_merge``) against JAX's: dominated,
    equal and concurrent clocks, exact twins, and (wide spans) more
    concurrent values than V, so the cut and the overflow count decide."""
    rng = np.random.default_rng(seed)
    a = workloads.mvr_slots(rng, (V, K), VC, WL, canonical=canonical,
                            span=span)
    b = workloads.mvr_slots(rng, (V, K), VC, WL, canonical=canonical,
                            span=span)
    want, want_ovf = J_MERGE(_jax(a), _jax(b))
    got, ovf = mvregister.merge_with_stats(_torch(a), _torch(b))
    _assert_equal(got, want, "merge")
    _assert_equal(ovf, want_ovf, "overflow")
    if span == 6:
        assert int(ovf.sum()) > 0


# -- the Store: full and delta converge ----------------------------------------

R, KS, VS, WS, BS = 5, 12, 2, 5, 10


def _store_stream(seed, ticks):
    """Writes with clocks per replica lane (writer = replica), so replicas
    write concurrently and a converged key holds more values than V; every
    other tick with hazard keys, writers and no-ops."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        ops = workloads.mvr_writes(rng, R, KS, BS, num_values=8)
        if t % 2:
            ops["key"] = rng.integers(-2 * KS, 2 * KS, (R, BS)).astype(np.int32)
            ops["writer"] = rng.integers(-2 * WS, 2 * WS, (R, BS)).astype(np.int32)
            ops["op"] = np.where(rng.random((R, BS)) < 0.2, 0, ops["op"]).astype(np.int32)
        out.append(ops)
    return out


@pytest.mark.parametrize("budget", [None, 2, KS])
def test_store_fused_tick_matches_jax(budget):
    """``Store.fused_tick`` with the MVRegister (uncaptured writes) against
    the JAX ``Store``: the full arm (``join_replicas``) and the delta arm
    (``join_replica_rows``) at a budget every tick overflows (2) and one
    none does (K); R = 5 (the halving tree's overlapping middle row).
    States, dirty masks and flushed metrics bit-equal after every tick,
    and some key's frontier overflowed V in the converge."""
    dims = {"mvr": dict(num_keys=KS, num_writers=WS, capacity=VS)}
    ref = jax_store.Store(R, dims, dirty_budget=budget)
    mine = store.Store(R, dims, dirty_budget=budget, device="cpu")
    full = 0
    for t, ops in enumerate(_store_stream(13, 6)):
        ref.fused_tick({"mvr": _jax(ops)})
        mine.fused_tick({"mvr": _torch(ops)})
        _assert_equal(mine.states["mvr"], ref.states["mvr"], f"tick {t}")
        _assert_equal(mine.dirty["mvr"], ref.dirty["mvr"], f"dirty {t}")
        for f, x in mine.states["mvr"].items():
            assert torch.equal(x, x[:1].expand_as(x)), (t, f)
        full += int((mine.states["mvr"]["valid"].sum(-1) == VS).sum())
    assert mine.flush_metrics() == pytest.approx(ref.flush_metrics())
    assert full > 0


def test_load_store_continues_a_jax_store():
    """``convert.load_store`` carries a JAX ``Store``'s MVRegister state
    (the 3-D ``clock`` leaf with its dtype and shape) and dirty masks into
    the port's, which continues bit-equal through delta ticks."""
    dims = {"mvr": dict(num_keys=KS, num_writers=WS, capacity=VS)}
    stream = _store_stream(15, 4)
    ref = jax_store.Store(R, dims, dirty_budget=KS // 2)
    for ops in stream[:2]:
        ref.fused_tick({"mvr": _jax(ops)})
    mine = store.Store(R, dims, dirty_budget=KS // 2, device="cpu")
    convert.load_store(mine, ref.states, ref.dirty)
    assert mine.states["mvr"]["clock"].shape == (R, KS, VS, WS)
    assert mine.states["mvr"]["clock"].dtype == torch.int32
    _assert_equal(mine.states["mvr"], ref.states["mvr"], "loaded")
    for t, ops in enumerate(stream[2:]):
        ref.fused_tick({"mvr": _jax(ops)})
        mine.fused_tick({"mvr": _torch(ops)})
        _assert_equal(mine.states["mvr"], ref.states["mvr"], f"tick {t}")


# -- SafeKV ---------------------------------------------------------------------

N, W, KC, VCC, BC = 4, 8, 6, 2, 12


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


def test_safekv_rounds_match_jax():
    """The MVRegister through the port's ``SafeKV.step`` and JAX's at N=4,
    W=8, V=2: Zipf writes, writer = node (the smoke script's mvr_consensus
    stream), node 3 crashed for a few rounds, then idle rounds; every
    device leaf (the ring's ``[W, N, B, W]`` ``wclock`` extra among them)
    and the packed output bit-equal after every round. The drained stable
    views are bit-equal and hold only pairwise-concurrent values."""
    mine = safecrdt.SafeKV(DagConfig(N, W), mvregister.SPEC, ops_per_block=BC,
                           device="cpu", num_keys=KC, num_writers=N,
                           capacity=VCC)
    ref = JaxSafeKV(JaxDagConfig(N, W), jax_mvr.SPEC, ops_per_block=BC,
                    num_keys=KC, num_writers=N, capacity=VCC)
    rng = np.random.default_rng(14)
    idle = {f: np.zeros((N, BC), np.int32) for f in base.OP_FIELDS}
    for t in range(14):
        ops = workloads.mvr_writes(rng, N, KC, BC, num_values=5) if t < 6 else idle
        active = np.ones(N, bool)
        active[N - 1] = not 2 <= t < 4
        packed, meta = mine.step_dispatch(ops, active=active)
        jpacked, jmeta = ref.step_dispatch(ops, active=active)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked),
                                      err_msg=f"packed round {t}")
        mine.step_absorb(packed, meta)
        ref.step_absorb(jpacked, jmeta)
        _assert_equal(_device_state(mine), _device_state(ref), f"round {t}")
    assert mine.stats == ref.stats
    assert mine.ops_buffer["wclock"].shape == (W, N, BC, N)
    st = mine.stable
    for f, x in st.items():
        assert torch.equal(x, x[:1].expand_as(x)), f
    clock, valid = st["clock"][0], st["valid"][0]
    for k in range(KC):
        live = clock[k][valid[k]]
        for i in range(len(live)):
            for j in range(len(live)):
                if i != j:
                    assert int(lattice.clock_compare(live[i], live[j])) == \
                        lattice.CLOCK_CONCURRENT


# -- tests/test_models.py's scenarios ----------------------------------------

def _wr(st, key, val, writer):
    return mvregister.apply_ops(st, base.make_op_batch(
        op=[mvregister.OP_WRITE], key=[key], a0=[val], writer=[writer],
        device="cpu"))


def _live(st, key):
    vals, valid = mvregister.read(st, key)
    return set(vals[valid].tolist())


def _init():
    return mvregister.init(1, num_writers=2, capacity=4, device="cpu")


def test_mvr_sequential_overwrite():
    a = _wr(_init(), 0, 100, 0)
    b = _wr(mvregister.merge(_init(), a), 0, 200, 1)  # causally after a's
    assert _live(mvregister.merge(a, b), 0) == {200}


def test_mvr_concurrent_writes_merge():
    a = _wr(_init(), 0, 100, 0)
    b = _wr(_init(), 0, 200, 1)  # concurrent
    m1, m2 = mvregister.merge(a, b), mvregister.merge(b, a)
    for m in (m1, m2):
        assert _live(m, 0) == {100, 200}
    assert int(mvregister.num_values(m1)[0]) == 2
    _assert_equal(m1, jax_mvr.merge(_jax(a), _jax(b)), "jax")
    assert bool(mvregister.has_value(m1, 0, 100))
    assert not bool(mvregister.has_value(m1, 0, 300))


def test_mvr_local_dominates_keeps_local():
    a = _wr(_init(), 0, 1, 0)
    _assert_equal(mvregister.merge(a, _init()), a, "stale")


def test_mvr_no_divergence_on_equal_key_clocks():
    a = _wr(_init(), 0, 100, 0)
    c = mvregister.merge(_init(), a)
    d = mvregister.merge(_init(), a)
    cw = _wr(_init(), 0, 200, 1)
    c = mvregister.merge(c, cw)         # {100, 200}
    d = _wr(d, 0, 200, 1)               # observed 100 -> {200}
    m1, m2 = mvregister.merge(c, d), mvregister.merge(d, c)
    _assert_equal(m1, m2, "commutes")
    assert _live(m1, 0) == {200}


def test_mvr_write_collapses_concurrency():
    a = _wr(_init(), 0, 100, 0)
    b = _wr(_init(), 0, 200, 1)
    m = _wr(mvregister.merge(a, b), 0, 300, 0)  # observes both
    assert _live(m, 0) == {300}
    for other in (a, b):
        assert _live(mvregister.merge(m, other), 0) == {300}
    np.testing.assert_array_equal(
        mvregister.key_clock(m).numpy(),
        np.asarray(jax_mvr.key_clock(_jax(m))))

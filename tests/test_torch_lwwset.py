"""Parity of the port's LWW-Set (janus_tpu_torch, on the CPU) with the
JAX package's: the timestamp order (``ts_after`` / ``ts_max``), the apply
uncaptured and captured (``lww_apply``), the single-op capture
(``capture_and_apply`` through ``lww_capture``, and the plain lane loop
``base.capture_scan``), the join (``lww_union``), the Store's full and
delta converge (``join_replicas`` and ``join_replica_rows`` through
``lww_union_rows``), SafeKV rounds, and tests/test_models.py's LWW
scenarios. On the CPU each wrapper runs its kernel's plain version.

Inputs are seeded numpy draws handed to both packages. Hazards: keys in
[-2K, 2K) (a lane reads the clamped row and writes nothing), every op
code, non-canonical rows holding one elem twice, full rows (drops),
negative low words (the unsigned order) and equal stamps (add wins).
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
from janus_tpu.models import lwwset as jax_lww
from janus_tpu.ops import ts_after as jax_ts_after
from janus_tpu.ops import ts_max as jax_ts_max
from janus_tpu.runtime import store as jax_store
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import base, lwwset
from janus_tpu_torch.ops import ts_after, ts_max
from janus_tpu_torch.runtime import safecrdt, store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_lww._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_lww.SPEC, st, o)))
J_MERGE = jax.jit(jax.vmap(
    lambda a, b: jax_lww.slot_union(a, b, jax_lww.KEY_FIELDS,
                                    jax_lww._combine,
                                    capacity=a["elem"].shape[-1])))

V, K, C, B = 3, 5, 8, 40


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


def _state(rng, **kw):
    st = workloads.lww_slots(rng, (V, K), C, num_elems=2 * C, **kw)
    return {"valid": st["valid"], **{f: st[f] for f in lwwset.FIELDS
                                     if f != "valid"}}


# -- timestamps (tests/test_lattice.py) --------------------------------------

def test_ts_pair_order_unsigned_low_word():
    """Low words with bit 31 set order as unsigned."""
    i32 = torch.int32
    a_hi, a_lo = torch.tensor(0, dtype=i32), torch.tensor(-(2**31), dtype=i32)
    b_hi, b_lo = torch.tensor(0, dtype=i32), torch.tensor(2**31 - 1, dtype=i32)
    assert bool(ts_after(a_hi, a_lo, b_hi, b_lo))
    assert not bool(ts_after(b_hi, b_lo, a_hi, a_lo))
    mh, ml = ts_max(b_hi, b_lo, a_hi, a_lo)
    assert (int(mh), int(ml)) == (0, -(2**31))


@pytest.mark.parametrize("span", [3, 2**31])
def test_ts_after_and_max_match_jax(span):
    """Random (hi, lo) pairs, small and over the whole int32 range (the
    sign flip), equal stamps among them, against the JAX functions and a
    64-bit reference with an unsigned low word."""
    rng = np.random.default_rng(span % 97)
    x = [rng.integers(-span, span, 256).astype(np.int32) for _ in range(4)]
    x[2][:32], x[3][:32] = x[0][:32], x[1][:32]  # equal stamps
    got_after = ts_after(*map(torch.from_numpy, x))
    got_max = ts_max(*map(torch.from_numpy, x))
    np.testing.assert_array_equal(got_after.numpy(),
                                  np.asarray(jax_ts_after(*map(jnp.asarray, x))))
    for g, w in zip(got_max, jax_ts_max(*map(jnp.asarray, x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    va = x[0].astype(np.int64) * (1 << 32) + (x[1].astype(np.int64) & 0xFFFFFFFF)
    vb = x[2].astype(np.int64) * (1 << 32) + (x[3].astype(np.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(got_after.numpy(), va >= vb)


# -- apply, capture, merge ----------------------------------------------------

def _apply_case(name, rng):
    """(state [V, K, C], ops [V, B]) of one named hazard."""
    if name == "hazards":  # keys in [-2K, 2K), every code, duplicate elems
        st = _state(rng, canonical=False, dup_rows=0.5)
        return st, workloads.lww_mixed_ops(rng, (V, B), K, 2 * C)
    if name == "captured":  # an ok flag per op, removes of absent elems
        st = _state(rng, canonical=False, dup_rows=0.3)
        return st, workloads.lww_mixed_ops(rng, (V, B), K, 2 * C,
                                           captured=True)
    if name == "full_rows":  # adds of absent elems into full rows drop
        st = _state(rng, full_rows=1.0)
        ops = workloads.lww_mixed_ops(rng, (V, B), K, 4 * C, hazards=False)
        ops["op"][:, ::2] = lwwset.OP_ADD
        return st, ops
    assert name == "one_row"  # every lane on one key, lane after lane
    st = _state(rng, full_rows=0.0, fill=0.3)
    ops = workloads.lww_mixed_ops(rng, (V, B), K, C)
    ops["key"][:] = np.where(np.arange(B) % 5 == 0, K + 3, K - 1)
    return st, ops


@pytest.mark.parametrize("name,seed", [("hazards", 1), ("captured", 2),
                                       ("full_rows", 3), ("one_row", 4)])
def test_apply_matches_jax_scan(name, seed):
    """``apply_ops_dropped`` (the ``lww_apply`` wrapper) against JAX's
    vmapped ``_apply_ops_impl``: the state after the batch and the drops
    per view."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    want_st, want_drop = J_APPLY(_jax(st), _jax(ops))
    got_st, got_drop = lwwset.apply_ops_dropped(_torch(st), _torch(ops))
    _assert_equal(got_st, want_st, name)
    _assert_equal(got_drop, want_drop, f"{name} dropped")
    if name == "full_rows":
        assert int(got_drop.sum()) > 0


@pytest.mark.parametrize("name,seed", [("hazards", 5), ("full_rows", 6),
                                       ("one_row", 7)])
def test_capture_matches_jax_scan(name, seed):
    """``capture_and_apply(lwwset.SPEC)`` (the ``lww_capture`` wrapper) and
    ``base.capture_scan`` against JAX's vmapped scan: the state after the
    batch and the prepared ops with ``ok``; removes that found their elem
    and removes that did not."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    want_st, want_ops = J_CAPTURE(_jax(st), _jax(ops))
    for capture in (base.capture_and_apply, base.capture_scan):
        got_st, got_ops = capture(lwwset.SPEC, _torch(st), _torch(ops))
        _assert_equal(got_ops, want_ops, f"{capture.__name__} ops")
        _assert_equal(got_st, want_st, f"{capture.__name__} state")
    ok = np.asarray(want_ops["ok"])[..., 0]
    rm = ops["op"] == lwwset.OP_REMOVE
    assert ok[rm].any() and not ok[rm].all()


@pytest.mark.parametrize("canonical,seed", [(True, 8), (False, 9)])
def test_merge_matches_jax(canonical, seed):
    """``merge_with_stats`` (``lww_union``) against JAX's slot union with
    the LWW fold: duplicate elems across and within the inputs (equal
    stamps, negative low words), full rows that overflow."""
    rng = np.random.default_rng(seed)
    a = _state(rng, canonical=canonical, dup_rows=0.3, full_rows=0.5)
    b = _state(rng, canonical=canonical, dup_rows=0.3, full_rows=0.5)
    want, want_ovf = J_MERGE(_jax(a), _jax(b))
    got, ovf = lwwset.merge_with_stats(_torch(a), _torch(b))
    _assert_equal({"valid": got["valid"], **got}, want, "merge")
    _assert_equal(ovf, want_ovf, "overflow")
    assert int(ovf.sum()) > 0


# -- the Store: full and delta converge ----------------------------------------

R, KS, CS, BS = 4, 16, 8, 12


def _store_stream(seed, ticks):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        ops = workloads.lww_add_remove(rng, R, KS, BS, t, num_elems=12)
        if t % 2:  # hazards: keys in [-2K, 2K), no-ops
            ops["key"] = rng.integers(-2 * KS, 2 * KS, (R, BS)).astype(np.int32)
            ops["op"] = np.where(rng.random((R, BS)) < 0.2, 0, ops["op"]).astype(np.int32)
        out.append(ops)
    return out


@pytest.mark.parametrize("budget", [None, 2, KS])
def test_store_fused_tick_matches_jax(budget):
    """``Store.fused_tick`` with the LWW-Set against the JAX ``Store``:
    the full arm (``budget`` None: ``join_replicas``), and the delta arm
    (``converge_delta`` through ``join_replica_rows``) at a budget every
    tick overflows (2) and one none does (K). States, dirty masks and
    flushed metrics bit-equal after every tick; the rows of a few keys
    hold more elements than the capacity, so merges drop."""
    dims = {"lww": dict(num_keys=KS, capacity=CS)}
    ref = jax_store.Store(R, dims, dirty_budget=budget)
    mine = store.Store(R, dims, dirty_budget=budget, device="cpu")
    for t, ops in enumerate(_store_stream(11, 6)):
        ref.fused_tick({"lww": _jax(ops)})
        mine.fused_tick({"lww": _torch(ops)})
        _assert_equal(mine.states["lww"], ref.states["lww"], f"tick {t}")
        _assert_equal(mine.dirty["lww"], ref.dirty["lww"], f"dirty {t}")
        for f, x in mine.states["lww"].items():  # converged replicas
            assert torch.equal(x, x[:1].expand_as(x)), (t, f)
    assert mine.flush_metrics() == pytest.approx(ref.flush_metrics())
    assert int(mine.states["lww"]["valid"].sum(-1).max()) == CS


def test_load_store_continues_a_jax_store():
    """``convert.load_store`` carries a JAX ``Store``'s LWW-Set state and
    dirty masks into the port's, which continues bit-equal."""
    dims = {"lww": dict(num_keys=KS, capacity=CS)}
    stream = _store_stream(16, 4)
    ref = jax_store.Store(R, dims, dirty_budget=KS // 2)
    for ops in stream[:2]:
        ref.fused_tick({"lww": _jax(ops)})
    mine = store.Store(R, dims, dirty_budget=KS // 2, device="cpu")
    convert.load_store(mine, ref.states, ref.dirty)
    _assert_equal(mine.states["lww"], ref.states["lww"], "loaded")
    for t, ops in enumerate(stream[2:]):
        ref.fused_tick({"lww": _jax(ops)})
        mine.fused_tick({"lww": _torch(ops)})
        _assert_equal(mine.states["lww"], ref.states["lww"], f"tick {t}")


# -- SafeKV ---------------------------------------------------------------------

N, W, KC, CC, BC = 4, 8, 6, 8, 16


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


def _by_elem(st):
    return convert.tree_to_numpy(kernels.lww_rows.canonical_row(
        {f: st[f] for f in lwwset.FIELDS}))


def test_safekv_rounds_match_jax():
    """The LWW-Set through the port's ``SafeKV.step`` and JAX's at N=4,
    W=8: the add/remove stream of the smoke script's lww_consensus phase
    (stamps strictly increasing per node from one epoch, so equal stamps
    across nodes), node 3 crashed for a few rounds, then idle rounds; every
    device leaf (the ring's ``ok`` extra among them) and the packed output
    bit-equal after every round. The drained stable views are bit-equal,
    and every view's prospective state holds the stable elements by (key,
    elem), in the slots its apply order gave them (no row overflows: the
    stream draws no more elements than a row holds)."""
    mine = safecrdt.SafeKV(DagConfig(N, W), lwwset.SPEC, ops_per_block=BC,
                           device="cpu", num_keys=KC, capacity=CC)
    ref = JaxSafeKV(JaxDagConfig(N, W), jax_lww.SPEC, ops_per_block=BC,
                    num_keys=KC, capacity=CC)
    rng = np.random.default_rng(12)
    idle = {f: np.zeros((N, BC), np.int32) for f in base.OP_FIELDS}
    for t in range(14):
        ops = (workloads.lww_add_remove(rng, N, KC, BC, t, num_elems=CC)
               if t < 6 else idle)
        active = np.ones(N, bool)
        active[N - 1] = not 2 <= t < 4
        packed, meta = mine.step_dispatch(ops, active=active)
        jpacked, jmeta = ref.step_dispatch(ops, active=active)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked),
                                      err_msg=f"packed round {t}")
        mine.step_absorb(packed, meta)
        ref.step_absorb(jpacked, jmeta)
        _assert_equal(_device_state(mine), _device_state(ref), f"round {t}")
    assert mine.stats == ref.stats and mine.stats["slots_dropped"] == 0
    assert mine.stats["state_transfers"] > 0
    ring_ok = mine.ops_buffer["ok"]
    assert ring_ok.shape == (W, N, BC, 1)
    for f, x in mine.stable.items():
        assert torch.equal(x, x[:1].expand_as(x)), f
    p, s = _by_elem(mine.prospective), _by_elem(mine.stable)
    for f in s:
        np.testing.assert_array_equal(p[f], s[f], err_msg=f)


# -- tests/test_models.py's scenarios ----------------------------------------

def _lww(st, op, key, elem, hi, lo):
    return lwwset.apply_ops(st, base.make_op_batch(
        op=[op], key=[key], a0=[elem], a1=[hi], a2=[lo], device="cpu"))


def test_lww_add_remove_readd():
    st = lwwset.init(1, 8, device="cpu")
    st = _lww(st, lwwset.OP_ADD, 0, 5, 0, 10)
    assert bool(lwwset.contains(st, 0, 5))
    st = _lww(st, lwwset.OP_REMOVE, 0, 5, 0, 20)
    assert not bool(lwwset.contains(st, 0, 5))
    st = _lww(st, lwwset.OP_ADD, 0, 5, 0, 30)
    assert bool(lwwset.contains(st, 0, 5))


def test_lww_add_wins_tie():
    st = lwwset.init(1, 8, device="cpu")
    st = _lww(st, lwwset.OP_ADD, 0, 5, 0, 10)
    st = _lww(st, lwwset.OP_REMOVE, 0, 5, 0, 10)  # same stamp: add wins
    assert bool(lwwset.contains(st, 0, 5))


def test_lww_remove_requires_presence():
    st = lwwset.init(1, 8, device="cpu")
    st = _lww(st, lwwset.OP_REMOVE, 0, 5, 0, 50)  # ignored: not present
    st = _lww(st, lwwset.OP_ADD, 0, 5, 0, 10)     # older add still lands
    assert bool(lwwset.contains(st, 0, 5))


def test_lww_merge_convergence():
    """Both merge orders agree with each other and with JAX; merge is
    idempotent."""
    a = lwwset.init(2, 8, device="cpu")
    b = lwwset.init(2, 8, device="cpu")
    a = _lww(a, lwwset.OP_ADD, 0, 1, 0, 10)
    b = _lww(b, lwwset.OP_ADD, 0, 1, 0, 5)
    b = _lww(b, lwwset.OP_ADD, 1, 2, 0, 7)
    m1, m2 = lwwset.merge(a, b), lwwset.merge(b, a)
    _assert_equal(m1, m2, "commutes")
    assert bool(lwwset.contains(m1, 0, 1)) and bool(lwwset.contains(m1, 1, 2))
    _assert_equal(lwwset.merge(m1, m1), m1, "idempotent")
    _assert_equal({"valid": m1["valid"], **m1},
                  jax_lww.merge(_jax(a), _jax(b)), "jax")
    assert int(lwwset.live_count(m1).sum()) == 2
    np.testing.assert_array_equal(lwwset.lookup_mask(m1).numpy(),
                                  np.asarray(jax_lww.lookup_mask(
                                      jax_lww.merge(_jax(a), _jax(b)))))

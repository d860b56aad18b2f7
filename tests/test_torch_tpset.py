"""Parity of the port's 2P-Set (janus_tpu_torch, on the CPU) with the JAX
package's: the apply uncaptured and captured (``tpset_apply``), the
single-op capture (``capture_and_apply`` through ``tpset_capture``, and
the plain lane loop ``base.capture_scan``), the join (``tp_union``), the
Store's full and delta converge (``join_replicas`` and
``join_replica_rows`` through ``tp_union_rows``), SafeKV rounds, and the
2P-Set scenarios of tests/test_models.py and tests/test_replay.py. On the
CPU each wrapper runs its kernel's plain version.

Inputs are seeded numpy draws handed to both packages. Hazards: keys in
[-2K, 2K) (a lane reads the clamped row and writes nothing), every op
code, non-canonical rows holding one elem twice (tombstoned and not),
full rows (drops, a captured remove's inserted tombstone among them),
re-adds of removed elems and removes of absent ones. Every comparison is
bit-equal (int32 and bool state, int counts; tolerance exactly 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import base as jax_base
from janus_tpu.models import tpset as jax_tp
from janus_tpu.runtime import store as jax_store
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import base, tpset
from janus_tpu_torch.runtime import safecrdt, store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_tp._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_tp.SPEC, st, o)))
J_MERGE = jax.jit(jax.vmap(
    lambda a, b: jax_tp.slot_union(a, b, jax_tp.KEY_FIELDS, jax_tp._combine,
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
    return workloads.tp_slots(rng, (V, K), C, num_elems=2 * C, **kw)


# -- apply, capture, merge ----------------------------------------------------

def _apply_case(name, rng):
    """(state [V, K, C], ops [V, B]) of one named hazard."""
    if name == "hazards":  # keys in [-2K, 2K), every code, duplicate elems
        st = _state(rng, canonical=False, dup_rows=0.5)
        return st, workloads.tp_mixed_ops(rng, (V, B), K, 2 * C)
    if name == "captured":  # an ok flag per op, removes of absent elems
        st = _state(rng, canonical=False, dup_rows=0.3)
        return st, workloads.tp_mixed_ops(rng, (V, B), K, 2 * C,
                                          captured=True)
    if name == "full_rows":  # upserts of absent elems into full rows drop
        st = _state(rng, full_rows=1.0)
        ops = workloads.tp_mixed_ops(rng, (V, B), K, 4 * C, hazards=False,
                                     captured=True)
        ops["op"][:, ::2] = tpset.OP_ADD
        ops["op"][:, 1::2] = tpset.OP_REMOVE
        return st, ops
    assert name == "one_row"  # every lane on one key, lane after lane
    st = _state(rng, full_rows=0.0, fill=0.3)
    ops = workloads.tp_mixed_ops(rng, (V, B), K, C)
    ops["key"][:] = np.where(np.arange(B) % 5 == 0, K + 3, K - 1)
    return st, ops


@pytest.mark.parametrize("name,seed", [("hazards", 1), ("captured", 2),
                                       ("full_rows", 3), ("one_row", 4)])
def test_apply_matches_jax_scan(name, seed):
    """``apply_ops_dropped`` (the ``tpset_apply`` wrapper) against JAX's
    vmapped ``_apply_ops_impl``: the state after the batch and the drops
    per view."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    want_st, want_drop = J_APPLY(_jax(st), _jax(ops))
    got_st, got_drop = tpset.apply_ops_dropped(_torch(st), _torch(ops))
    _assert_equal(got_st, want_st, name)
    _assert_equal(got_drop, want_drop, f"{name} dropped")
    if name == "full_rows":  # adds and captured removes both dropped
        assert int(got_drop.sum()) > 0


@pytest.mark.parametrize("name,seed", [("hazards", 5), ("full_rows", 6),
                                       ("one_row", 7)])
def test_capture_matches_jax_scan(name, seed):
    """``capture_and_apply(tpset.SPEC)`` (the ``tpset_capture`` wrapper)
    and ``base.capture_scan`` against JAX's vmapped scan: the state after
    the batch and the prepared ops with ``ok``; removes that found their
    elem and removes that did not; every other lane's ``ok`` is 1, no-ops
    and unknown codes included."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    ops.pop("ok", None)
    want_st, want_ops = J_CAPTURE(_jax(st), _jax(ops))
    for capture in (base.capture_and_apply, base.capture_scan):
        got_st, got_ops = capture(tpset.SPEC, _torch(st), _torch(ops))
        _assert_equal(got_ops, want_ops, f"{capture.__name__} ops")
        _assert_equal(got_st, want_st, f"{capture.__name__} state")
    ok = np.asarray(want_ops["ok"])[..., 0]
    rm = ops["op"] == tpset.OP_REMOVE
    assert ok[rm].any() and not ok[rm].all()
    assert ok[~rm].all()


def test_two_phase_rules():
    """Each 2P rule on its own: a re-add keeps the tombstone; an
    uncaptured remove of an absent elem records nothing; a captured
    remove with ``ok`` inserts a tombstone into a row that lacks the elem,
    using a slot (and dropping when the row is full); ``prepare_ops``
    gives 1 to everything but a remove."""
    st = tpset.init(2, 2, device="cpu")

    def run(state, op, key, elem, ok=None):
        ops = base.make_op_batch(op=[op], key=[key], a0=[elem], device="cpu")
        if ok is not None:
            ops["ok"] = torch.tensor([[ok]], dtype=torch.int32)
        return tpset.apply_ops_dropped(state, ops)

    run(st, tpset.OP_ADD, 0, 4)
    run(st, tpset.OP_REMOVE, 0, 4)
    run(st, tpset.OP_ADD, 0, 4)                   # re-add: still removed
    assert not bool(tpset.contains(st, 0, 4))
    assert int(st["valid"][0].sum()) == 1
    run(st, tpset.OP_REMOVE, 1, 6)                # uncaptured, absent
    assert int(st["valid"][1].sum()) == 0
    run(st, tpset.OP_REMOVE, 1, 6, ok=1)          # captured, absent
    assert bool(st["valid"][1, 0]) and bool(st["removed"][1, 0])
    run(st, tpset.OP_ADD, 1, 6)                   # late add: no resurrect
    assert not bool(tpset.contains(st, 1, 6))
    _, d = run(st, tpset.OP_ADD, 1, 7)
    _, d = run(st, tpset.OP_REMOVE, 1, 8, ok=1)   # the row is full
    assert int(d) == 1
    prep = tpset.prepare_ops(st, base.make_op_batch(
        op=[0, 1, 2, 2, 3], key=[1] * 5, a0=[9, 9, 7, 6, 9], device="cpu"))
    assert prep["ok"][:, 0].tolist() == [1, 1, 1, 0, 1]


@pytest.mark.parametrize("canonical,seed", [(True, 8), (False, 9)])
def test_merge_matches_jax(canonical, seed):
    """``merge_with_stats`` (``tp_union``) against JAX's slot union with
    the tombstone OR: duplicate elems across and within the inputs, one
    copy tombstoned, full rows that overflow."""
    rng = np.random.default_rng(seed)
    a = _state(rng, canonical=canonical, dup_rows=0.3, full_rows=0.5)
    b = _state(rng, canonical=canonical, dup_rows=0.3, full_rows=0.5)
    want, want_ovf = J_MERGE(_jax(a), _jax(b))
    got, ovf = tpset.merge_with_stats(_torch(a), _torch(b))
    _assert_equal(got, want, "merge")
    _assert_equal(ovf, want_ovf, "overflow")
    assert int(ovf.sum()) > 0


# -- the Store: full and delta converge ----------------------------------------

R, KS, CS, BS = 4, 16, 8, 12


def _store_stream(seed, ticks):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        ops = workloads.tpset_add_remove(rng, R, KS, BS, num_elems=12)
        if t % 2:  # hazards: keys in [-2K, 2K), no-ops
            ops["key"] = rng.integers(-2 * KS, 2 * KS, (R, BS)).astype(np.int32)
            ops["op"] = np.where(rng.random((R, BS)) < 0.2, 0, ops["op"]).astype(np.int32)
        out.append(ops)
    return out


@pytest.mark.parametrize("budget", [None, 2, KS])
def test_store_fused_tick_matches_jax(budget):
    """``Store.fused_tick`` with the 2P-Set against the JAX ``Store``: the
    full arm (``budget`` None: ``join_replicas``), and the delta arm
    (``converge_delta`` through ``join_replica_rows``) at a budget every
    tick overflows (2) and one none does (K). States, dirty masks and
    flushed metrics bit-equal after every tick; a few keys' rows hold more
    elements than the capacity, so merges drop."""
    dims = {"tpset": dict(num_keys=KS, capacity=CS)}
    ref = jax_store.Store(R, dims, dirty_budget=budget)
    mine = store.Store(R, dims, dirty_budget=budget, device="cpu")
    for t, ops in enumerate(_store_stream(11, 6)):
        ref.fused_tick({"tpset": _jax(ops)})
        mine.fused_tick({"tpset": _torch(ops)})
        _assert_equal(mine.states["tpset"], ref.states["tpset"], f"tick {t}")
        _assert_equal(mine.dirty["tpset"], ref.dirty["tpset"], f"dirty {t}")
        for f, x in mine.states["tpset"].items():  # converged replicas
            assert torch.equal(x, x[:1].expand_as(x)), (t, f)
    assert mine.flush_metrics() == pytest.approx(ref.flush_metrics())
    assert int(mine.states["tpset"]["valid"].sum(-1).max()) == CS


def test_load_store_continues_a_jax_store():
    """``convert.load_store`` carries a JAX ``Store``'s 2P-Set state and
    dirty masks into the port's, which continues bit-equal."""
    dims = {"tpset": dict(num_keys=KS, capacity=CS)}
    stream = _store_stream(16, 4)
    ref = jax_store.Store(R, dims, dirty_budget=KS // 2)
    for ops in stream[:2]:
        ref.fused_tick({"tpset": _jax(ops)})
    mine = store.Store(R, dims, dirty_budget=KS // 2, device="cpu")
    convert.load_store(mine, ref.states, ref.dirty)
    _assert_equal(mine.states["tpset"], ref.states["tpset"], "loaded")
    for t, ops in enumerate(stream[2:]):
        ref.fused_tick({"tpset": _jax(ops)})
        mine.fused_tick({"tpset": _torch(ops)})
        _assert_equal(mine.states["tpset"], ref.states["tpset"], f"tick {t}")


# -- SafeKV ---------------------------------------------------------------------

N, W, KC, CC, BC = 4, 8, 6, 8, 16


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


def test_safekv_rounds_match_jax():
    """The 2P-Set through the port's ``SafeKV.step`` and JAX's at N=4, W=8:
    the add/remove stream of the smoke script's tpset_consensus phase,
    node 3 crashed for a few rounds, then idle rounds; every device leaf
    (the ring's ``ok`` extra among them) and the packed output bit-equal
    after every round. The drained stable views are bit-equal, and every
    view's prospective state holds the stable elements and tombstones by
    (key, elem), in the slots its apply order gave them."""
    mine = safecrdt.SafeKV(DagConfig(N, W), tpset.SPEC, ops_per_block=BC,
                           device="cpu", num_keys=KC, capacity=CC)
    ref = JaxSafeKV(JaxDagConfig(N, W), jax_tp.SPEC, ops_per_block=BC,
                    num_keys=KC, capacity=CC)
    rng = np.random.default_rng(12)
    idle = {f: np.zeros((N, BC), np.int32) for f in base.OP_FIELDS}
    for t in range(14):
        ops = (workloads.tpset_add_remove(rng, N, KC, BC, num_elems=CC)
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
    assert mine.ops_buffer["ok"].shape == (W, N, BC, 1)
    for f, x in mine.stable.items():
        assert torch.equal(x, x[:1].expand_as(x)), f
    p = kernels.tp_rows.canonical_row(mine.prospective)
    s = kernels.tp_rows.canonical_row(mine.stable)
    for f in s:
        assert torch.equal(p[f], s[f]), f


# -- tests/test_models.py's and tests/test_replay.py's scenarios ----------------

def _tp(st, op, key, elem):
    return tpset.apply_ops(st, base.make_op_batch(op=[op], key=[key],
                                                  a0=[elem], device="cpu"))


def test_tpset_no_readd_after_remove():
    st = tpset.init(1, 8, device="cpu")
    st = _tp(st, tpset.OP_ADD, 0, 9)
    assert bool(tpset.contains(st, 0, 9))
    st = _tp(st, tpset.OP_REMOVE, 0, 9)
    assert not bool(tpset.contains(st, 0, 9))
    st = _tp(st, tpset.OP_ADD, 0, 9)  # 2P: re-add has no effect
    assert not bool(tpset.contains(st, 0, 9))


def test_tpset_remove_requires_membership():
    st = tpset.init(1, 8, device="cpu")
    st = _tp(st, tpset.OP_REMOVE, 0, 9)  # not present: no tombstone
    st = _tp(st, tpset.OP_ADD, 0, 9)
    assert bool(tpset.contains(st, 0, 9))


def test_tpset_merge_remove_propagates():
    """Both merge orders agree with each other and with JAX."""
    a = _tp(tpset.init(1, 8, device="cpu"), tpset.OP_ADD, 0, 9)
    b = tpset.merge(tpset.init(1, 8, device="cpu"), a)
    b = _tp(b, tpset.OP_REMOVE, 0, 9)
    m1, m2 = tpset.merge(a, b), tpset.merge(b, a)
    _assert_equal(m1, m2, "commutes")
    assert not bool(tpset.contains(m1, 0, 9))
    _assert_equal(m1, jax_tp.merge(_jax(convert.tree_to_numpy(a)),
                                   _jax(convert.tree_to_numpy(b))), "jax")
    assert int(tpset.live_count(m1).sum()) == 0


def test_tpset_replay_orders_converge():
    """Captured ops applied in either order on fresh replicas join to the
    same state, equal to JAX's; the captured remove fires on a replica
    that never saw the add, and a late add does not bring it back."""
    origin = _tp(tpset.init(1, 8, device="cpu"), tpset.OP_ADD, 0, 5)
    ops = base.make_op_batch(op=[tpset.OP_ADD, tpset.OP_REMOVE], key=[0, 0],
                             a0=[6, 5], device="cpu")
    prepared = tpset.SPEC.prepare_ops(origin, ops)
    jorigin = jax_tp.apply_ops(jax_tp.init(1, 8), jax_base.make_op_batch(
        op=[jax_tp.OP_ADD], key=[0], a0=[5]))
    _assert_equal(prepared, jax_tp.SPEC.prepare_ops(
        jorigin, jax_base.make_op_batch(op=[1, 2], key=[0, 0], a0=[6, 5])),
        "prepared")
    joined = []
    for order in ((0, 1), (1, 0)):
        st = tpset.init(1, 8, device="cpu")
        for i in order:
            st = tpset.apply_ops(st, {f: v[i:i + 1] for f, v in prepared.items()})
        joined.append(tpset.merge(st, tpset.init(1, 8, device="cpu")))
    _assert_equal(joined[0], joined[1], "orders")
    fresh = tpset.apply_ops(tpset.init(1, 8, device="cpu"),
                            {f: v[1:2] for f, v in prepared.items()})
    assert not bool(tpset.contains(_tp(fresh, tpset.OP_ADD, 0, 5), 0, 5))

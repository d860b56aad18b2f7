"""Parity of the port's OR-Set (janus_tpu_torch, on the CPU) with the JAX
package's ``models/orset.py``: batched capture, captured replay and the
uncaptured scan apply (each through its kernel wrapper, which runs the
plain version on the CPU, and through the model), merge, the replica-axis
converge, queries, compaction, and the anti-entropy tick.

Inputs are seeded numpy draws at small sizes (K <= 8 keys, C <= 8 slots,
B <= 32 ops) handed to both packages; the JAX functions run per view
under ``jax.vmap`` on the CPU. The hazard cases: keys in [-K, 2K), adds
whose tag is SENTINEL, captured lanes that are SENTINEL, one tag carried
several times by a batch (and so folded from three or more copies), full
rows, and non-canonical rows with junk in invalid slots. Every comparison
is bit-equal (tolerance exactly 0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import orset as jax_orset
from janus_tpu.runtime import engine as jax_engine
from janus_tpu.runtime import store as jax_store

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import orset
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.runtime import engine, store
from janus_tpu_torch.utils.ids import TagMinter

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

FIELDS = ("tag_rep", "tag_ctr", "elem", "removed", "valid")


def _assert_equal(got, want, where=""):
    if isinstance(want, dict):
        got = convert.tree_to_numpy(got)
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    got, want = convert.tree_to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        where, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _state(rng, lead, k, c, r_cap, **kw):
    st = workloads.orset_slots(rng, lead + (k,), c, **kw)
    st["_rm_cap"] = np.zeros(lead + (r_cap, 0), np.int32)
    return st


def _ops(rng, lead, b, k, c, hazards=True):
    return workloads.orset_mixed_ops(rng, lead + (b,), k, c, hazards)


def _dirty(ops, k):
    """bool[V, K]: rows a non-no-op lane's key lands on (negative keys
    count from the end; keys still out of range touch nothing)."""
    key = np.where(ops["key"] < 0, ops["key"] + k, ops["key"])
    hit = (ops["op"] != 0) & (key >= 0) & (key < k)
    out = np.zeros(ops["key"].shape[:-1] + (k,), bool)
    for v in range(out.shape[0]):
        out[v, key[v][hit[v]]] = True
    return out


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return convert.tree_from_numpy(tree, "cpu")


CASES = [  # (V, K, C, B, r_cap, canonical)
    (3, 5, 6, 24, 3, True),
    (2, 4, 8, 32, 8, False),
    (4, 3, 4, 16, 6, True),    # r_cap > C
    (2, 8, 8, 32, 1, True),
]


@pytest.mark.parametrize("v,k,c,b,r_cap,canonical", CASES)
def test_capture_matches_jax(v, k, c, b, r_cap, canonical):
    rng = np.random.default_rng(b + c)
    st = _state(rng, (v,), k, c, r_cap, canonical=canonical, full_rows=0.4)
    ops = _ops(rng, (v,), b, k, c)
    # a batch that carries one tag twice
    ops["a1"][:, 3], ops["a2"][:, 3] = ops["a1"][:, 1], ops["a2"][:, 1]
    want = jax.vmap(jax_orset.prepare_ops_batch)(_jax(st), _jax(ops))
    got = orset.prepare_ops_batch(_torch(st), _torch(ops))
    _assert_equal(got, {f: np.asarray(x) for f, x in want.items()}, "capture")
    assert (np.asarray(want["rm_rep"]) != SENTINEL).any()
    # the wrapper alone, on the [V, K, C] fields
    cap = kernels.orset_capture({f: _torch(st)[f] for f in FIELDS}, _torch(ops),
                                r_cap)
    for f, x in zip(("rm_rep", "rm_ctr", "rm_elem"), cap):
        _assert_equal(x, want[f], f)


def test_capture_sees_earlier_adds_of_its_batch():
    """A remove after an add of its key and element in the same batch
    captures that add's tag; one before it does not."""
    st = _state(np.random.default_rng(0), (1,), 2, 4, 2, full_rows=0.0, fill=0.0)
    ops = {"op": [[2, 1, 2, 3]], "key": [[0, 0, 0, 0]], "a0": [[5, 5, 5, 0]],
           "a1": [[0, 7, 0, 0]], "a2": [[0, 9, 0, 0]], "writer": [[0] * 4]}
    ops = {f: np.asarray(x, np.int32) for f, x in ops.items()}
    got = orset.prepare_ops_batch(_torch(st), _torch(ops))
    want = jax.vmap(jax_orset.prepare_ops_batch)(_jax(st), _jax(ops))
    _assert_equal(got["rm_rep"], want["rm_rep"])
    assert got["rm_ctr"][0, :, 0].tolist() == [SENTINEL, SENTINEL, 9, 9]


def _captured(rng, st, ops, r_cap):
    """JAX's capture of ``ops`` with the replay's hazard lanes mixed in."""
    cap = jax.vmap(jax_orset.prepare_ops_batch)(_jax(st), _jax(ops))
    return workloads.with_capture_hazards(
        rng, {f: np.asarray(x) for f, x in cap.items()})


@pytest.mark.parametrize("v,k,c,b,r_cap,canonical", CASES)
def test_replay_matches_jax(v, k, c, b, r_cap, canonical):
    rng = np.random.default_rng(100 + b + c)
    st = _state(rng, (v,), k, c, r_cap, canonical=canonical, full_rows=0.4)
    ops = _captured(rng, st, _ops(rng, (v,), b, k, c), r_cap)
    want, want_drop = jax.vmap(jax_orset._apply_captured_batch)(_jax(st), _jax(ops))
    got, drop = kernels.orset_replay({f: _torch(st)[f] for f in FIELDS},
                                     _torch(ops))
    _assert_equal(got, {f: want[f] for f in FIELDS}, "replay")
    _assert_equal(drop, want_drop, "dropped")
    assert np.asarray(want_drop).sum() > 0 or not canonical
    # the model: apply_ops_delta takes the replay for a captured batch
    st2, info = orset.apply_ops_delta(_torch(st), _torch(ops))
    _assert_equal({f: st2[f] for f in FIELDS}, {f: want[f] for f in FIELDS})
    _assert_equal(info["slots_dropped"], want_drop)
    _assert_equal(info["dirty"], _dirty(ops, k), "dirty rows")


def test_replay_folds_many_copies_of_one_tag():
    """One tag from the state, an add and three captured removes, all on
    one key: one slot, tombstoned, elem from the state's copy."""
    st = _state(np.random.default_rng(1), (1,), 2, 4, 2, full_rows=0.0, fill=0.0)
    st["tag_rep"][0, 1, 0], st["tag_ctr"][0, 1, 0] = 2, 5
    st["elem"][0, 1, 0], st["valid"][0, 1, 0] = 3, True
    ops = {"op": [[1, 2, 2, 3]], "key": [[1] * 4], "a0": [[6, 3, 3, 0]],
           "a1": [[2, 0, 0, 0]], "a2": [[5, 0, 0, 0]], "writer": [[0] * 4]}
    ops = {f: np.asarray(x, np.int32) for f, x in ops.items()}
    for f, val in (("rm_rep", 2), ("rm_ctr", 5), ("rm_elem", 9)):
        ops[f] = np.full((1, 4, 2), SENTINEL if f != "rm_elem" else 0, np.int32)
        ops[f][0, 1:, 0] = val
    want, want_drop = jax.vmap(jax_orset._apply_captured_batch)(_jax(st), _jax(ops))
    got, drop = kernels.orset_replay({f: _torch(st)[f] for f in FIELDS},
                                     _torch(ops))
    _assert_equal(got, {f: want[f] for f in FIELDS})
    _assert_equal(drop, want_drop)
    row = {f: got[f][0, 1].tolist() for f in FIELDS}
    assert row["valid"] == [True, False, False, False]
    assert row["removed"][0] and row["elem"][0] == 3


@pytest.mark.parametrize("v,k,c,b,canonical", [
    (3, 5, 6, 24, False), (2, 4, 8, 32, True), (4, 2, 4, 32, True)])
def test_scan_apply_matches_jax(v, k, c, b, canonical):
    """The uncaptured per-op apply: keys in [-K, 2K), SENTINEL adds, folds
    into existing tags, evictions from full rows (counted drops)."""
    rng = np.random.default_rng(200 + b + c)
    st = _state(rng, (v,), k, c, 2, canonical=canonical, full_rows=0.5)
    ops = _ops(rng, (v,), b, k, c)
    want, want_drop = jax.vmap(jax_orset._apply_ops_impl)(_jax(st), _jax(ops))
    tst = {f: _torch(st)[f] for f in FIELDS}
    drop = kernels.orset_apply(tst, _torch(ops))
    _assert_equal(tst, {f: want[f] for f in FIELDS}, "scan")
    _assert_equal(drop, want_drop, "dropped")
    assert np.asarray(want_drop).sum() > 0
    # the model, in place, with the delta info
    tst = _torch(st)
    out, info = orset.apply_ops_delta(tst, _torch(ops))
    assert out is tst
    _assert_equal({f: out[f] for f in FIELDS}, {f: want[f] for f in FIELDS})
    _assert_equal(info["slots_dropped"], want_drop)
    _assert_equal(info["dirty"], _dirty(ops, k), "dirty rows")


def test_merge_queries_and_compaction_match_jax():
    rng = np.random.default_rng(7)
    a = _state(rng, (3,), 6, 5, 2, full_rows=0.5)
    b = _state(rng, (3,), 6, 5, 2, full_rows=0.5)
    want, want_ovf = jax_orset.merge_with_stats(_jax(a), _jax(b))
    got, ovf = orset.merge_with_stats(_torch(a), _torch(b))
    _assert_equal(got, want, "merge")
    _assert_equal(ovf, want_ovf, "overflow")
    _assert_equal(orset.merge(_torch(a), _torch(b)), jax_orset.merge(_jax(a), _jax(b)))

    one = {f: x[0] for f, x in a.items()}
    for key in (0, 3, 5, -1, -6):
        for elem in range(8):
            _assert_equal(orset.contains(_torch(one), key, elem),
                          jax_orset.contains(_jax(one), key, elem),
                          f"contains {key} {elem}")
    for q in ("live_count", "element_count"):
        _assert_equal(getattr(orset, q)(_torch(a)), getattr(jax_orset, q)(_jax(a)), q)
    _assert_equal(orset.lookup_mask(_torch(a)), jax_orset.lookup_mask(_jax(a)))

    protect = rng.random((3, 6, 5)) < 0.3
    _assert_equal(orset.compact(_torch(a), torch.from_numpy(protect)),
                  jax_orset.compact(_jax(a), jnp.asarray(protect)), "compact")
    _assert_equal(orset.compact(_torch(a)), jax_orset.compact(_jax(a)))
    live = _ops(rng, (), 40, 6, 5, hazards=False)
    live["a2"] = rng.integers(1, 8, 40).astype(np.int32)
    _assert_equal(orset.compact_fence(_torch(a), _torch(live)),
                  jax_orset.compact_fence(_jax(a), _jax(live)), "compact_fence")


@pytest.mark.parametrize("live_adds", [True, False])
def test_compact_fence_batched_views_match_jax(live_adds):
    """``compact_fence`` on a state of 2 x 4 views at once (the
    ``orset_watermark`` and ``orset_compact`` wrappers) against JAX's
    ``vmap`` over the views, with the ring as SafeKV flattens it; without
    a live add the watermark is SENTINEL and only live slots stay (tags at
    SENTINEL aside). ``compact_fences`` of two states shares the one
    watermark."""
    rng = np.random.default_rng(17 + live_adds)
    sts = [_state(rng, (2, 4), 6, 8, 3, full_rows=0.5) for _ in range(2)]
    for st in sts:  # some tombstoned tags at SENTINEL, kept by the fence
        st["tag_ctr"][..., 0] = np.where(st["valid"][..., 0] & (
            rng.random(st["valid"].shape[:-1]) < 0.3), SENTINEL,
            st["tag_ctr"][..., 0])
    live = _ops(rng, (8, 4), 5, 6, 8, hazards=False)
    live["a2"] = rng.integers(1, 12, live["a2"].shape).astype(np.int32)
    if not live_adds:
        live["op"] = np.where(live["op"] == orset.OP_ADD, 0, live["op"])
    flat = {f: x.reshape(-1) for f, x in live.items()}
    fence = jax.jit(jax.vmap(jax.vmap(jax_orset.compact_fence,
                                      in_axes=(0, None)), in_axes=(0, None)))
    want = [fence(_jax(st), _jax(flat)) for st in sts]
    _assert_equal(orset.compact_fence(_torch(sts[0]), _torch(flat)), want[0],
                  "compact_fence")
    got = orset.compact_fences(tuple(_torch(st) for st in sts), _torch(flat))
    for g, w in zip(got, want):
        _assert_equal(g, w, "compact_fences")
    wm = kernels.orset_watermark(*(torch.from_numpy(flat[f])
                                   for f in ("op", "a2")))
    adds = flat["op"] == orset.OP_ADD
    assert int(wm[0]) == (int(flat["a2"][adds].min()) if live_adds
                          else SENTINEL)


def test_compact_fences_at_sixteen_views_without_a_live_add_match_jax():
    """``compact_fences`` of two states of harness preset orset's 16
    views at C 64 (few keys) behind a ring with no live add (the
    watermark is SENTINEL: every tombstone drops but those at SENTINEL)
    against JAX's ``compact_fence`` vmapped over the views."""
    rng = np.random.default_rng(29)
    sts = [_state(rng, (16,), 6, 64, 4, full_rows=0.5) for _ in range(2)]
    for st in sts:  # tombstoned tags at SENTINEL stay
        st["tag_ctr"][..., 0] = np.where(st["valid"][..., 0] & (
            rng.random(st["valid"].shape[:-1]) < 0.3), SENTINEL,
            st["tag_ctr"][..., 0])
    live = _ops(rng, (8, 16), 40, 6, 64, hazards=False)
    live["op"] = np.where(live["op"] == orset.OP_ADD, orset.OP_REMOVE,
                          live["op"])
    flat = {f: x.reshape(-1) for f, x in live.items()}
    fence = jax.jit(jax.vmap(jax_orset.compact_fence, in_axes=(0, None)))
    got = orset.compact_fences(tuple(_torch(st) for st in sts), _torch(flat))
    for g, st in zip(got, sts):
        _assert_equal(g, fence(_jax(st), _jax(flat)), "compact_fences")


def test_watermark_protects_live_buffered_add():
    """tests/test_compact.py::test_watermark_protects_live_buffered_add:
    a tag tombstoned by a captured clear while its add may still ride the
    live window (ctr 20 >= watermark 10) survives the fence, an older one
    (ctr 5) is reclaimed; the port equals JAX at each step. The clear is
    captured in a batch of two lanes (the one-lane captured apply is not
    ported)."""
    from janus_tpu.models import base as jax_base
    from janus_tpu_torch.models import base

    st = orset.init(num_keys=2, capacity=8, rm_capacity=4, device="cpu")
    ops = dict(op=[orset.OP_ADD] * 2, key=[0, 0], a0=[7, 7], a1=[0, 1],
               a2=[5, 20])
    st = orset.apply_ops(st, base.make_op_batch(**ops, device="cpu"))
    jst = jax_orset.apply_ops(jax_orset.init(2, 8, 4),
                              jax_base.make_op_batch(**ops))
    clear = dict(op=[orset.OP_CLEAR, 0], key=[0, 0])
    st = orset.apply_ops(st, orset.prepare_ops_batch(
        st, base.make_op_batch(**clear, device="cpu")))
    jst = jax_orset.apply_ops(jst, jax_orset.prepare_ops_batch(
        jst, jax_base.make_op_batch(**clear)))
    _assert_equal(st, jst, "after the clear")
    assert not bool(orset.contains(st, 0, 7))
    live = dict(op=[orset.OP_ADD], a1=[1], a2=[10], batch=4)
    out = orset.compact_fence(st, base.make_op_batch(**live, device="cpu"))
    _assert_equal(out, jax_orset.compact_fence(jst, jax_base.make_op_batch(
        **live)), "compact_fence")
    kept = {(int(r), int(c)) for r, c, v in zip(
        out["tag_rep"][0], out["tag_ctr"][0], out["valid"][0]) if v}
    assert (1, 20) in kept and (0, 5) not in kept
    assert bool(out["removed"][0][out["valid"][0]].all())


def test_init_and_state_cross_over():
    """``init`` equals JAX's; a JAX state (bool leaves, the zero-width
    ``_rm_cap``) crosses over through numpy and back unchanged."""
    want = jax_orset.init(5, 6, rm_capacity=3)
    got = orset.init(5, 6, rm_capacity=3, device="cpu")
    _assert_equal(got, want)
    assert tuple(got["_rm_cap"].shape) == (3, 0)
    _assert_equal(orset.init(2, 4, device="cpu"), jax_orset.init(2, 4))
    rng = np.random.default_rng(3)
    st = jax_orset.merge(_jax(_state(rng, (2,), 3, 4, 2)),
                         _jax(_state(rng, (2,), 3, 4, 2)))
    back = convert.tree_to_numpy(convert.tree_from_numpy(
        convert.tree_to_numpy(st), "cpu"))
    _assert_equal(back, st)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_converge_and_gossip_match_jax(r):
    rng = np.random.default_rng(r)
    st = _state(rng, (r,), 4, 6, 2, full_rows=0.4)
    want = jax_store.converge(jax_orset.SPEC, _jax(st))
    got = store.converge(orset.SPEC, _torch(st))
    _assert_equal(got, {f: np.broadcast_to(np.asarray(x), x.shape)
                        for f, x in want.items()}, "converge")
    _assert_equal(store.gossip_step(orset.SPEC, _torch(st), 1),
                  jax_store.gossip_step(jax_orset.SPEC, _jax(st), 1), "gossip")
    _assert_equal(store.join_all(orset.SPEC, _torch(st)),
                  jax_store.join_all(jax_orset.SPEC, _jax(st)), "join_all")


def test_anti_entropy_tick_matches_jax():
    """Path B at a small size: R=4 replicas, K=8 keys, C=8, B=16 uncaptured
    ops per replica per tick in a rotating Zipf hot window of 4 keys, a
    full converge every tick; bit-equal after every one of 6 ticks."""
    r, k, c, b = 4, 8, 8, 16
    rng = np.random.default_rng(5)
    minters = [TagMinter(i) for i in range(r)]
    jst = jax_store.replicated_init(jax_orset.SPEC, r, num_keys=k, capacity=c,
                                    rm_capacity=2)
    tst = store.replicated_init(orset.SPEC, r, device="cpu", num_keys=k,
                                capacity=c, rm_capacity=2)
    jtick = jax.jit(jax_engine.make_tick(jax_orset.SPEC))
    ttick = engine.make_tick(orset.SPEC, device="cpu")
    for t in range(6):
        ops = workloads.orset_hot_window(rng, minters, k, b, t, hot=4)
        jst = jtick(jst, _jax(ops))
        tst = ttick(tst, _torch(ops))
        _assert_equal(tst, {f: np.asarray(x) for f, x in jst.items()},
                      f"tick {t}")
    assert int(np.asarray(jst["valid"]).sum()) > 0


@pytest.mark.parametrize("v,k,c,b,r_cap,canonical", CASES)
def test_single_op_capture_and_one_lane_apply_match_jax(v, k, c, b, r_cap,
                                                        canonical):
    """The single-op capture (``prepare_ops``) of one lane against JAX's,
    then the one-lane captured apply (the ``orset_apply`` wrapper's
    captured mode) against JAX's scan, lane after lane over the batch:
    captured tags into full rows (drops), tags already present (folded,
    the tombstone sticky), keys in [-K, 2K); and ``base.capture_scan``
    over the whole batch against JAX's ``capture_and_apply`` scan."""
    from janus_tpu.models import base as jax_base
    from janus_tpu_torch.models import base

    rng = np.random.default_rng(3 * b + c)
    st = _state(rng, (v,), k, c, r_cap, canonical=canonical, full_rows=0.5)
    ops = _ops(rng, (v,), b, k, c)
    jax_prepare = jax.jit(jax.vmap(jax_orset.prepare_ops))
    jax_apply = jax.jit(jax.vmap(jax_orset._apply_ops_impl))
    tst, jst = _torch(st), _jax(st)
    drops = 0
    for lane in range(b):
        one = {f: x[:, lane:lane + 1] for f, x in ops.items()}
        want_ops = jax_prepare(jst, _jax(one))
        got_ops = orset.prepare_ops(tst, _torch(one))
        _assert_equal(got_ops, {f: np.asarray(x) for f, x in want_ops.items()},
                      f"prepare_ops lane {lane}")
        jst, want_drop = jax_apply(jst, want_ops)
        tst, got_drop = orset.SPEC.apply_ops_dropped(tst, got_ops)
        _assert_equal(tst, jst, f"apply lane {lane}")
        _assert_equal(got_drop, want_drop, f"drops lane {lane}")
        drops += int(np.asarray(want_drop).sum())
    assert drops > 0
    scan_spec = dataclasses.replace(jax_orset.SPEC, prepare_ops_batch=None)
    want_st, want_prep = jax.vmap(
        lambda s, o: jax_base.capture_and_apply(scan_spec, s, o))(
        _jax(st), _jax(ops))
    got_st, got_prep = base.capture_scan(orset.SPEC, _torch(st), _torch(ops))
    _assert_equal(got_prep, {f: np.asarray(x) for f, x in want_prep.items()},
                  "capture_scan ops")
    _assert_equal(got_st, want_st, "capture_scan state")

"""Parity of the port's RGA sequence CRDT (janus_tpu_torch, on the CPU)
with the JAX package's ``models/rga.py``: the apply (uncaptured and with
``eff_ctr``), ``merge_with_stats``, the replica-axis converge and its
row-list mode against ``store.converge`` / ``store.converge_delta``,
``compact``, the linearization (``_order_row`` / ``text``), the delta
apply's dirty mask, the semantic cases of tests/test_rga.py that need no
consensus, and harness preset ``rga`` shrunk to R=8, K=4, L=2 over 8
ticks. On the CPU each wrapper runs its kernel's plain version.

Inputs are seeded numpy draws handed to both packages; hazards include
keys in [-K, 2K), full rows, deletes before their insert, re-inserts,
negative and SENTINEL ids, non-canonical rows with junk and repeated ids,
dangling parents and chains deeper than ``max_depth``. Every comparison is
bit-equal (int32 and bool state; tolerance exactly 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import base as jax_base
from janus_tpu.models import rga as jax_rga
from janus_tpu.runtime import engine as jax_engine
from janus_tpu.runtime import store as jax_store

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import base, rga
from janus_tpu_torch.runtime import engine, store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax_rga.apply_ops)
J_APPLY_IMPL = jax.jit(jax.vmap(jax_rga._apply_ops_impl))
J_MERGE = jax.jit(jax_rga.merge)
J_COMPACT = jax.jit(jax_rga.compact)
J_TEXT = jax.jit(jax_rga.text, static_argnums=1)
J_LENGTH = jax.jit(jax_rga.length, static_argnums=1)
J_CONVERGE = jax.jit(lambda st: jax_store.converge(jax_rga.SPEC, st))
J_CONVERGE_DELTA = jax.jit(
    lambda st, dirty, budget: jax_store.converge_delta(jax_rga.SPEC, st, dirty,
                                                       budget),
    static_argnums=2)
J_ORDER = jax.jit(jax.vmap(jax_rga._order_row, in_axes=(0, None)),
                  static_argnums=1)


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return convert.tree_from_numpy(convert.tree_to_numpy(tree), "cpu")


def _assert_equal(got, want, where=""):
    got = convert.tree_to_numpy(got)
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        where, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _state(rng, lead, k, c, depth=4, **kw):
    """Random RGA state ``lead + (K, C)`` as numpy, with a random Lamport
    floor per document and the ``_depth`` shape carrier."""
    st = workloads.rga_slots(rng, tuple(lead) + (k,), c, **kw)
    st["_depth"] = np.zeros(tuple(lead) + (depth, 0), np.int32)
    st["ctr_floor"] = rng.integers(-2, c + 2, tuple(lead) + (k,)).astype(np.int32)
    return st


@pytest.mark.parametrize("r,k,c,b,canonical,captured,seed", [
    (3, 4, 8, 24, True, False, 1),     # uncaptured, keys in [-K, 2K)
    (2, 3, 6, 32, False, False, 2),    # non-canonical rows, repeated ids
    (4, 2, 4, 16, True, True, 3),      # eff_ctr, re-inserts, small full rows
    (2, 4, 8, 20, False, True, 4),
])
def test_apply_matches_jax(r, k, c, b, canonical, captured, seed):
    rng = np.random.default_rng(seed)
    st = _state(rng, (r,), k, c, canonical=canonical, dup_rows=0.5,
                full_rows=0.5, negative=0.1)
    ops = workloads.rga_mixed_ops(rng, (r, b), k, c, captured=captured)
    want, want_drop = J_APPLY_IMPL(_jax(st), _jax(ops))
    got, drop = rga.apply_ops_dropped(_torch(st), _torch(ops))
    _assert_equal(got, want, "state")
    _assert_equal(drop, want_drop, "dropped")
    assert np.asarray(want_drop).any()
    # the delta form's dirty mask, with ctr_floor as the first leaf
    t = _torch(st)
    t = {"ctr_floor": t.pop("ctr_floor"), **t}
    _, info = rga.SPEC.apply_ops_delta(t, _torch(ops))
    _, jinfo = jax.vmap(jax_rga.apply_ops_delta)(_jax(st), _jax(ops))
    _assert_equal(info["dirty"], jinfo["dirty"], "dirty")
    _assert_equal(info["slots_dropped"], jinfo["slots_dropped"], "dropped")


def test_apply_ops_delta_takes_the_key_axis_from_the_key_leaf():
    """The key count comes from ``spec.key_leaf``, not from whichever
    leaf comes first: here ``ctr_floor`` ``[R, K]`` with R != K."""
    st = rga.init(num_keys=3, capacity=4, device="cpu")
    st = {f: x.expand((5,) + tuple(x.shape)).clone() for f, x in st.items()}
    st = {"ctr_floor": st.pop("ctr_floor"), **st}
    ops = base.make_op_batch(op=[[rga.OP_INSERT]] * 5, key=[[2]] * 5,
                             a0=[[65]] * 5, writer=[[1]] * 5, device="cpu")
    _, info = rga.SPEC.apply_ops_delta(st, ops)
    assert tuple(info["dirty"].shape) == (5, 3)
    assert info["dirty"][:, 2].all() and not info["dirty"][:, :2].any()


@pytest.mark.parametrize("lead,c,canonical,seed", [
    ((3, 4), 8, True, 5),    # full rows: overflow
    ((2, 3), 6, False, 6),   # non-canonical, repeated ids, junk
])
def test_merge_with_stats_matches_jax(lead, c, canonical, seed):
    rng = np.random.default_rng(seed)
    a = _state(rng, lead[:1], lead[1], c, canonical=canonical, dup_rows=0.4,
               full_rows=0.5)
    b = _state(rng, lead[:1], lead[1], c, canonical=canonical, dup_rows=0.4,
               full_rows=0.5)
    # half of b's ids copied from a, so the union meets duplicates
    take = rng.random(lead + (c,)) < 0.5
    for f in ("id_ctr", "id_rep", "valid"):
        b[f] = np.where(take, a[f], b[f])
    want, want_ovf = jax_rga.merge_with_stats(_jax(a), _jax(b))
    got, ovf = rga.merge_with_stats(_torch(a), _torch(b))
    _assert_equal(got, want)
    _assert_equal(ovf, want_ovf, "overflow")
    assert np.asarray(want_ovf).any()
    # the generic union with the fold, and the in-place form
    out = {f: torch.zeros((2,) + lead + (c,), dtype=got[f].dtype)
           for f in rga.FIELDS}
    kernels.rga_union(_torch(a), _torch(b), c, out=out)
    for f in rga.FIELDS:
        _assert_equal(out[f], np.broadcast_to(np.asarray(want[f]),
                                              (2,) + lead + (c,)), f)


@pytest.mark.parametrize("r", [1, 2, 3, 5, 8])
def test_join_replicas_matches_converge(r):
    rng = np.random.default_rng(10 + r)
    st = _state(rng, (r,), 3, 8, canonical=r % 2 == 0, dup_rows=0.3,
                fill=0.4, full_rows=0.1)
    want = J_CONVERGE(_jax(st))
    got = store.converge(rga.SPEC, _torch(st))
    _assert_equal(got, want)


def _dirty_state(rng, r, k, c, dirty):
    """A converged random state whose dirty (replica, row) pairs are
    replaced by fresh random rows and floors: the invariant of
    ``converge_delta`` (clean rows equal across replicas, canonical)."""
    base_ = J_CONVERGE(_jax(_state(rng, (r,), k, c,
                                                         fill=0.4)))
    st = convert.tree_to_numpy(base_)
    fresh = _state(rng, (r,), k, c, fill=0.4, full_rows=0.2)
    for f in rga.FIELDS:
        st[f] = np.where(dirty[..., None], fresh[f], st[f])
    st["ctr_floor"] = np.where(dirty, fresh["ctr_floor"], st["ctr_floor"])
    return st


@pytest.mark.parametrize("r,case", [(3, "none"), (3, "all"), (5, "exact"),
                                    (5, "over"), (2, "some"), (1, "some")])
def test_join_replica_rows_matches_converge_delta(r, case):
    k, c, budget = 6, 8, 3
    rng = np.random.default_rng(20 + r)
    rows = {"none": [], "all": list(range(k)), "exact": [0, 2, 5],
            "over": [0, 1, 3, 4], "some": [1, 4]}[case]
    dirty = np.zeros((r, k), bool)
    for j, row in enumerate(rows):
        dirty[j % r, row] = True
    st = _dirty_state(rng, r, k, c, dirty)
    want, w_ovf, w_cnt = J_CONVERGE_DELTA(_jax(st), jnp.asarray(dirty), budget)
    got, ovf, cnt = store.converge_delta(rga.SPEC, _torch(st),
                                         torch.from_numpy(dirty), budget)
    _assert_equal(got, want)
    assert bool(ovf) == bool(w_ovf) and int(cnt) == int(w_cnt)


@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("canonical,seed", [(True, 30), (False, 31)])
def test_compact_matches_jax(protect, canonical, seed):
    rng = np.random.default_rng(seed)
    st = _state(rng, (3,), 4, 12, canonical=canonical, dup_rows=0.4,
                dead=0.6, negative=0.1)
    prot = rng.random((3, 4, 12)) < 0.3 if protect else None
    want = J_COMPACT(_jax(st), None if prot is None else jnp.asarray(prot))
    got = rga.compact(_torch(st), None if prot is None else torch.from_numpy(prot))
    _assert_equal(got, want)
    # the kernel's plain version writing fresh tensors
    fresh = kernels.rga_compact({f: _torch(st)[f] for f in rga.FIELDS},
                                None if prot is None else torch.from_numpy(prot))
    _assert_equal(fresh, {f: want[f] for f in rga.FIELDS})


@pytest.mark.parametrize("c,depth,canonical,seed", [
    (16, 4, True, 40),    # chains deeper than depth: overflow
    (12, 3, False, 41),   # repeated ids, junk, cycles
    (32, 4, True, 42),
    (8, 1, False, 43),
])
def test_order_matches_jax(c, depth, canonical, seed):
    rng = np.random.default_rng(seed)
    rows = workloads.rga_slots(rng, (6,), c, canonical=canonical,
                               dup_rows=0.6, chain=0.6, dangling=0.1,
                               negative=0.1, full_rows=0.5)
    want = J_ORDER(_jax(rows), depth)
    got = kernels.rga_order(_torch(rows), depth)
    for g, w, what in zip(got, want, ("order", "depth_of", "overflow")):
        _assert_equal(g, w, what)
    assert np.asarray(want[2]).any()
    # text of every document of a [K, C] state, and the queries
    st = {f: x.reshape(2, 3, c) for f, x in rows.items()}
    st["_depth"] = np.zeros((2, depth, 0), np.int32)
    st["ctr_floor"] = np.zeros((2, 3), np.int32)
    for key in (0, -1, 5):
        one = {f: x[1] for f, x in st.items()}
        _assert_equal(rga.text(_torch(one), key), J_TEXT(_jax(one), key),
                      f"text {key}")
        _assert_equal(rga.length(_torch(one), key),
                      J_LENGTH(_jax(one), key), f"length {key}")
    # batched over a leading replica axis, as the Store's queries are
    _assert_equal(rga.text(_torch(st), 1),
                  jax.vmap(jax_rga.text, in_axes=(0, None))(_jax(st), 1))
    _assert_equal(rga.element_count(_torch(st)), jax_rga.element_count(_jax(st)))


def _both(fn):
    """Run ``fn(module, make_ops, to_np)`` with the JAX package and with
    the port on the CPU; returns both results."""
    def jax_ops(**kw):
        return jax_base.make_op_batch(**{f: np.asarray(v, np.int32)
                                         for f, v in kw.items()})

    def torch_ops(**kw):
        return base.make_op_batch(**kw, device="cpu")

    def port_init(**kw):
        return rga.init(**kw, device="cpu")

    class Port:
        init = staticmethod(port_init)
        apply_ops = staticmethod(rga.apply_ops)
        merge = staticmethod(rga.merge)
        compact = staticmethod(rga.compact)
    class Jax:
        init = staticmethod(jax_rga.init)
        apply_ops = staticmethod(J_APPLY)
        merge = staticmethod(J_MERGE)
        compact = staticmethod(J_COMPACT)
    return fn(Jax, jax_ops), fn(Port, torch_ops)


def _typing(m, ops):
    st = m.init(num_keys=2, capacity=16, max_depth=8)
    prev = (0, 0)
    for i, ch in enumerate("HELLO"):
        st = m.apply_ops(st, ops(op=[1], key=[0], a0=[ord(ch)], a1=[prev[0]],
                                 a2=[prev[1]], writer=[0]))
        prev = (0, i + 1)
    return st


def _concurrent(m, ops):
    a = m.init(num_keys=2, capacity=16, max_depth=8)
    b = m.init(num_keys=2, capacity=16, max_depth=8)
    a = m.apply_ops(a, ops(op=[1], key=[0], a0=[ord("A")], writer=[1]))
    b = m.apply_ops(b, ops(op=[1], key=[0], a0=[ord("B")], writer=[2]))
    return m.merge(a, b)


def _tombstones(m, ops):
    st = m.init(num_keys=2, capacity=16, max_depth=8)
    st = m.apply_ops(st, ops(op=[1], key=[0], a0=[ord("X")], writer=[0]))
    st = m.apply_ops(st, ops(op=[1], key=[0], a0=[ord("Y")], a1=[0], a2=[1],
                             writer=[0]))
    st = m.apply_ops(st, ops(op=[1], key=[0], a0=[ord("Z")], a1=[0], a2=[2],
                             writer=[0]))
    st = m.apply_ops(st, ops(op=[2], key=[0], a1=[0], a2=[1], writer=[0]))
    st = m.apply_ops(st, ops(op=[2], key=[0], a1=[0], a2=[3], writer=[0]))
    return m.compact(st)


def _delete_first(m, ops):
    st = m.init(num_keys=2, capacity=16, max_depth=8)
    st = m.apply_ops(st, ops(op=[2], key=[0], a1=[3], a2=[1], writer=[0]))
    one = ops(op=[1], key=[0], a0=[ord("Z")], writer=[3])
    eff = np.asarray([[1]], np.int32)
    one["eff_ctr"] = (torch.from_numpy(eff) if isinstance(one["op"], torch.Tensor)
                      else jnp.asarray(eff))
    return m.apply_ops(st, one)


def _deep(m, ops):
    st = m.init(num_keys=2, capacity=16, max_depth=4)
    prev = (0, 0)
    for i in range(6):
        st = m.apply_ops(st, ops(op=[1], key=[0], a0=[97 + i], a1=[prev[0]],
                                 a2=[prev[1]], writer=[0]))
        prev = (0, i + 1)
    return st


def _random_trace(m, ops):
    """tests/test_rga.py's random trace: 3 replicas insert (anchored at
    random observed ids) and delete, with random pairwise merges."""
    rng = np.random.default_rng(11)
    states = [m.init(num_keys=1, capacity=32, max_depth=4) for _ in range(3)]
    seen = [[] for _ in range(3)]
    for _ in range(40):
        r = int(rng.integers(3))
        if seen[r] and rng.random() < 0.2:
            ctr, rep = seen[r][int(rng.integers(len(seen[r])))]
            states[r] = m.apply_ops(states[r], ops(op=[2], key=[0], a1=[rep],
                                                   a2=[ctr], writer=[0]))
        else:
            par = ((0, 0) if not seen[r] or rng.random() < 0.3
                   else seen[r][int(rng.integers(len(seen[r])))])
            states[r] = m.apply_ops(states[r], ops(
                op=[1], key=[0], a0=[97 + int(rng.integers(26))],
                a1=[par[1]], a2=[par[0]], writer=[r]))
            cnt = np.asarray(states[r]["id_ctr"])[0]
            val = np.asarray(states[r]["valid"])[0]
            seen[r].append((int(cnt[val].max()), r))
        if rng.random() < 0.3:
            j = int(rng.integers(3))
            states[r] = m.merge(states[r], states[j])
            states[j] = m.merge(states[j], states[r])
            seen[r] = sorted(set(seen[r]) | set(seen[j]))
            seen[j] = list(seen[r])
    out = states[0]
    for j in range(3):
        out = m.merge(out, states[j])
    return out


@pytest.mark.parametrize("scenario,text", [
    (_typing, "HELLO"), (_concurrent, "BA"), (_tombstones, "Y"),
    (_delete_first, ""), (_deep, None), (_random_trace, None)])
def test_semantics_match_jax(scenario, text):
    """The cases of tests/test_rga.py that need no consensus, run in both
    packages: states bit-equal, the same text and overflow flag."""
    want, got = _both(scenario)
    _assert_equal(got, want)
    tw, tg = J_TEXT(want, 0), rga.text(got, 0)
    _assert_equal(tg, tw, "text")
    chars = "".join(chr(c) for c, m in zip(np.asarray(tw["chr"]),
                                           np.asarray(tw["live"])) if m)
    if text is not None:
        assert chars == text
    if scenario is _deep:
        assert bool(np.asarray(tw["overflow"]))


def test_preset_shrunk_matches_jax_every_tick():
    """Harness preset ``rga`` at R=8, K=4, L=2 (ins_per_doc_tick 4,
    capacity 32), max_depth 4, delete lag 2, compaction every 4 ticks, 8
    ticks: the port's ``make_tick`` + ``compact`` against ``jit_tick`` +
    ``vmap(rga.compact)``, bit-equal after every tick; then the text of
    document 0 and the live counts the harness checks."""
    R, K, L, lag, every, ticks = 8, 4, 2, 2, 4, 8
    cap = R * L // K * (lag + every + 2)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    jst = jax_store.replicated_init(jax_rga.SPEC, R, num_keys=K, capacity=cap,
                                    max_depth=4)
    tst = store.replicated_init(rga.SPEC, R, device="cpu", num_keys=K,
                                capacity=cap, max_depth=4)
    assert tuple(tst["_depth"].shape) == (R, 4, 0)
    jtick = jax_engine.jit_tick(jax_rga.SPEC)
    jcompact = jax.jit(jax.vmap(jax_rga.compact))
    ttick = engine.make_tick(rga.SPEC, device="cpu")
    for t in range(ticks):
        jops = workloads.rga_text_replay(rng_j, R, K, L, lag, t)
        jst = jtick(jst, jax_base.make_op_batch(**jops))
        tst = ttick(tst, convert.tree_from_numpy(
            workloads.rga_text_replay(rng_t, R, K, L, lag, t), "cpu"))
        if t % every == every - 1:
            jst = jcompact(jst)
            tst = rga.compact(tst)
        _assert_equal(tst, jst, f"tick {t}")
    live = (tst["valid"] & ~tst["dead"]).sum(-1)
    assert (live == R * L // K * lag).all()
    _assert_equal(rga.text({f: x[0] for f, x in tst.items()}, 0),
                  jax_rga.text(jax.tree.map(lambda x: x[0], jst), 0))


@pytest.mark.parametrize("budget,delta", [(3, True), (6, True), (6, False)])
def test_store_fused_tick_matches_jax(budget, delta):
    """Four RGA ticks through the Store's ``fused_tick`` (hazard ops: keys
    in [-K, 2K), full rows that drop) against the JAX Store: states and
    dirty masks every tick, and the device accumulators (drops, overflows
    at budget 3, dirty counts)."""
    R, K, C = 4, 6, 8
    dims = dict(num_keys=K, capacity=C, max_depth=4)
    ref = jax_store.Store(R, {"rga": dims}, dirty_budget=budget)
    mine = store.Store(R, {"rga": dims}, dirty_budget=budget, device="cpu")
    rng = np.random.default_rng(50 + budget)
    for t in range(4):
        ops = workloads.rga_mixed_ops(rng, (R, 8), K, C)
        ref.fused_tick({"rga": _jax(ops)}, delta=delta)
        mine.fused_tick({"rga": _torch(ops)}, delta=delta)
        _assert_equal(mine.states, ref.states, f"fused_tick {t}")
        _assert_equal(mine.dirty, ref.dirty, f"fused_tick {t} dirty")
    _assert_equal({k: v for k, v in mine._fused_acc.items()},
                  {k: np.asarray(v) for k, v in ref._fused_acc.items()},
                  "accumulators")
    assert int(mine._fused_acc["dropped"]) > 0
    if delta:
        assert (int(mine._fused_acc["overflow_rga"]) > 0) == (budget == 3)


def test_prepare_ops_matches_jax():
    """The single-op capture's counter (``prepare_ops``, plain PyTorch on
    the spec) on one document state, keys in [-K, 2K); and the sequential
    capture that calls it lane by lane (``capture_and_apply``, through the
    spec's ``capture_apply``) against JAX's scan: state and prepared ops."""
    rng = np.random.default_rng(60)
    st = {f: x[0] for f, x in _state(rng, (1,), 4, 8, negative=0.1).items()}
    ops = {f: x[0] for f, x in workloads.rga_mixed_ops(rng, (1, 12), 4, 8).items()}
    want = jax_rga.prepare_ops(_jax(st), _jax(ops))
    got = rga.prepare_ops(_torch(st), _torch(ops))
    _assert_equal(got, want)
    want_st, want_ops = jax_base.capture_and_apply(jax_rga.SPEC, _jax(st),
                                                   _jax(ops))
    got_st, got_ops = base.capture_and_apply(rga.SPEC, _torch(st), _torch(ops))
    _assert_equal(got_ops, want_ops)
    _assert_equal(got_st, want_st)

"""Parity of the port's 2P2P Graph (janus_tpu_torch, on the CPU) with the
JAX package's: the gated apply uncaptured and captured (``graph_apply``),
the single-op capture (``capture_and_apply`` through ``graph_capture``,
and the plain lane loop ``base.capture_scan``), the join (``tp_union``
and ``edge_union``), the dangling-edge filter (``edge_mask``) and the four
queries on it, the Store's full and delta converge (two trees a join,
through ``tp_union_rows`` and ``edge_union_rows``), the states carried
across by ``convert``, SafeKV rounds, and the Graph scenarios of
tests/test_models.py and tests/test_replay.py. On the CPU each wrapper
runs its kernel's plain version.

Inputs are seeded numpy draws handed to both packages. Hazards: keys in
[-2K, 2K), op codes from -1 to 5, self-loops, endpoints at INT32_MAX,
non-canonical rows holding one vertex or edge twice, full blocks (drops).
Every comparison is bit-equal (int32 and bool state, int counts;
tolerance exactly 0).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import base as jax_base
from janus_tpu.models import graph as jax_graph
from janus_tpu.runtime import store as jax_store
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.kernels import replica_tree
from janus_tpu_torch.kernels.tp_rows import canonical_row, edge_view, vertex_view
from janus_tpu_torch.models import base, graph, tpset
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.runtime import safecrdt, store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_graph._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_graph.SPEC, st, o)))
J_MERGE = jax.jit(jax.vmap(jax_graph.merge))
J_EDGE_MASK = jax.jit(jax_graph.edge_mask)

V, K, CV, CE, B, NV = 3, 5, 6, 10, 48, 5


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


def _state(rng, lead=(V, K), nv=NV, **kw):
    return workloads.graph_slots(rng, lead, CV, CE, nv, **kw)


# -- apply, capture, merge ----------------------------------------------------

def _apply_case(name, rng):
    """(state [V, K, ...], ops [V, B]) of one named hazard."""
    if name == "hazards":  # keys in [-2K, 2K), codes -1..5, INT32_MAX ends
        st = _state(rng, canonical=False, dup_rows=0.5, at_max=0.1)
        return st, workloads.graph_mixed_ops(rng, (V, B), K, NV)
    if name == "captured":  # an ok flag per op: ae without endpoints
        st = _state(rng, canonical=False, dup_rows=0.3)
        return st, workloads.graph_mixed_ops(rng, (V, B), K, NV,
                                             captured=True)
    if name == "full_rows":  # upserts of absent keys into full blocks drop
        st = _state(rng, full_rows=1.0, removed=0.0)
        ops = workloads.graph_mixed_ops(rng, (V, B), K, 2 * NV,
                                        hazards=False, captured=True)
        return st, ops
    assert name == "one_row"  # every lane on one key, lane after lane
    st = _state(rng, full_rows=0.0, fill=0.3)
    ops = workloads.graph_mixed_ops(rng, (V, B), K, NV, hazards=False)
    ops["key"][:] = np.where(np.arange(B) % 5 == 0, K + 3, K - 1)
    return st, ops


@pytest.mark.parametrize("name,seed", [("hazards", 1), ("captured", 2),
                                       ("full_rows", 3), ("one_row", 4)])
def test_apply_matches_jax_scan(name, seed):
    """``apply_ops_dropped`` (the ``graph_apply`` wrapper) against JAX's
    vmapped ``_apply_ops_impl``: both blocks after the batch and the drops
    per view."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    want_st, want_drop = J_APPLY(_jax(st), _jax(ops))
    got_st, got_drop = graph.apply_ops_dropped(_torch(st), _torch(ops))
    _assert_equal(got_st, want_st, name)
    _assert_equal(got_drop, want_drop, f"{name} dropped")
    if name == "full_rows":
        assert int(got_drop.sum()) > 0


@pytest.mark.parametrize("name,seed", [("hazards", 5), ("full_rows", 6),
                                       ("one_row", 7)])
def test_capture_matches_jax_scan(name, seed):
    """``capture_and_apply(graph.SPEC)`` (the ``graph_capture`` wrapper)
    and ``base.capture_scan`` against JAX's vmapped scan: the state and
    the prepared ops with ``ok``, every gate passing and failing, every
    other code's ``ok`` 1."""
    st, ops = _apply_case(name, np.random.default_rng(seed))
    ops.pop("ok", None)
    want_st, want_ops = J_CAPTURE(_jax(st), _jax(ops))
    for capture in (base.capture_and_apply, base.capture_scan):
        got_st, got_ops = capture(graph.SPEC, _torch(st), _torch(ops))
        _assert_equal(got_ops, want_ops, f"{capture.__name__} ops")
        _assert_equal(got_st, want_st, f"{capture.__name__} state")
    ok = np.asarray(want_ops["ok"])[..., 0]
    gated = np.isin(ops["op"], (2, 3, 4))
    assert ok[gated].any() and not ok[gated].all()
    assert ok[~gated].all()


def _run(st, op, a0=0, a1=0, ok=None, key=0):
    ops = base.make_op_batch(op=[op], key=[key], a0=[a0], a1=[a1],
                             device="cpu")
    if ok is not None:
        ops["ok"] = torch.tensor([[ok]], dtype=torch.int32)
    return graph.apply_ops_dropped(st, ops)[1]


def test_graph_gates():
    """Each gate on its own: ``rv`` counts a self-loop as incident; a gate
    reads the row before its lane (an ``rv`` in the lane after its vertex's
    ``av`` passes); a code outside 1-4 gates true and changes nothing; in
    captured mode the gate is ``ok`` alone, so an ``ae`` at a replica that
    lacks its endpoints still inserts the edge, which ``edge_mask`` then
    filters."""
    st = graph.init(1, 4, 4, device="cpu")
    _run(st, graph.OP_ADD_VERTEX, 3)
    _run(st, graph.OP_ADD_EDGE, 3, 3)                   # a self-loop
    assert int(graph.edge_count(st)[0]) == 1
    _run(st, graph.OP_REMOVE_VERTEX, 3)                 # incident: refused
    assert bool(graph.contains_vertex(st, 0, 3))
    prep = graph.prepare_ops(st, base.make_op_batch(
        op=[2, 5, -1, 0, 3, 4, 4], key=[0] * 7, a0=[3, 3, 3, 3, 3, 3, 1],
        a1=[0, 0, 0, 0, 3, 3, 3], device="cpu"))
    assert prep["ok"][:, 0].tolist() == [0, 1, 1, 1, 1, 1, 0]
    before = convert.tree_to_numpy(st)
    _run(st, 5, 3, 3)
    _run(st, -1, 3, 3)
    _assert_equal(st, before, "codes outside 1-4")
    ops = base.make_op_batch(op=[1, 2], key=[0, 0], a0=[7, 7], device="cpu")
    st2, prepared = base.capture_and_apply(graph.SPEC, graph.init(
        1, 4, 4, device="cpu"), ops)
    assert prepared["ok"][:, 0].tolist() == [1, 1]      # rv saw the av
    assert not bool(graph.contains_vertex(st2, 0, 7))
    fresh = graph.init(1, 4, 4, device="cpu")
    _run(fresh, graph.OP_ADD_EDGE, 1, 2, ok=1)          # replayed ae
    assert bool(fresh["e_valid"][0, 0])
    assert int(graph.edge_count(fresh)[0]) == 0
    _run(fresh, graph.OP_ADD_VERTEX, 1)
    _run(fresh, graph.OP_ADD_VERTEX, 2)
    assert bool(graph.contains_edge(fresh, 0, 1, 2))


@pytest.mark.parametrize("canonical,seed", [(True, 8), (False, 9)])
def test_merge_matches_jax(canonical, seed):
    """``merge_with_stats`` (``tp_union`` on the vertices, ``edge_union``
    on the edges) against JAX's ``merge``: duplicates across and within
    the inputs, one copy tombstoned, full blocks that overflow."""
    rng = np.random.default_rng(seed)
    a = _state(rng, nv=2 * CV, canonical=canonical, dup_rows=0.3,
               full_rows=0.5)
    b = _state(rng, nv=2 * CV, canonical=canonical, dup_rows=0.3,
               full_rows=0.5)
    want = J_MERGE(_jax(a), _jax(b))
    got, (v_ovf, e_ovf) = graph.merge_with_stats(_torch(a), _torch(b))
    _assert_equal(got, want, "merge")
    assert int(v_ovf.sum()) > 0 and int(e_ovf.sum()) > 0


@pytest.mark.parametrize("lead,at_max,seed", [((V, K), 0.0, 10),
                                              ((8, 16), 0.2, 11),
                                              ((40,), 0.3, 12)])
def test_edge_mask_and_queries_match_jax(lead, at_max, seed):
    """``edge_mask`` and ``vertex_count``, ``edge_count``,
    ``contains_vertex`` and ``contains_edge`` against JAX, bit-equal, the
    INT32_MAX quirk included: an endpoint of that value counts as live
    wherever its row has a slot that holds no live vertex."""
    rng = np.random.default_rng(seed)
    st = _state(rng, lead, canonical=False, dup_rows=0.3, at_max=at_max)
    mine, ref = _torch(st), _jax(st)
    _assert_equal(graph.edge_mask(mine), J_EDGE_MASK(ref), "edge_mask")
    _assert_equal(graph.vertex_count(mine),
                  jax_graph.vertex_count(ref).astype(jnp.int32), "vertices")
    _assert_equal(graph.edge_count(mine),
                  jax_graph.edge_count(ref).astype(jnp.int32), "edges")
    if len(lead) == 1:  # JAX's point queries index the key axis first
        n = lead[0]
        for key in (0, n - 1, -1, -n, n + 2, -n - 3):
            for v in (0, 2, SENTINEL):
                _assert_equal(graph.contains_vertex(mine, int(key), v),
                              jax_graph.contains_vertex(ref, int(key), v), "cv")
                for w in (1, 3, SENTINEL):
                    _assert_equal(
                        graph.contains_edge(mine, int(key), v, w),
                        jax_graph.contains_edge(ref, int(key), v, w), "ce")
    if at_max:
        quirk = ((mine["src"] == SENTINEL) | (mine["dst"] == SENTINEL)) \
            & graph.edge_mask(mine)
        assert bool(quirk.any())


def test_edge_mask_sentinel_quirk():
    """A live edge to INT32_MAX passes the filter exactly when its row has
    a slot that is not a live vertex, as in JAX."""
    st = graph.init(1, 2, 2, device="cpu")
    _run(st, graph.OP_ADD_VERTEX, 1)
    _run(st, graph.OP_ADD_EDGE, 1, SENTINEL, ok=1)
    assert int(graph.edge_count(st)[0]) == 1           # slot 1 is empty
    _run(st, graph.OP_ADD_VERTEX, 2)
    assert int(graph.edge_count(st)[0]) == 0           # no dead slot now
    _assert_equal(graph.edge_mask(st), J_EDGE_MASK(_jax(
        convert.tree_to_numpy(st))), "jax")


# -- the Store: full and delta converge, convert --------------------------------

R, KS, CVS, CES, BS = 4, 12, 6, 10, 24


def _store_stream(seed, ticks):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        # three hot keys with no vertex removed, so that their edge blocks
        # fill and overflow
        ops = workloads.graph_ops(rng, R, 3, BS, num_vertices=6,
                                  out_degree=3)
        ops["op"][ops["op"] == graph.OP_REMOVE_VERTEX] = graph.OP_ADD_VERTEX
        if t % 2:  # hazards: keys in [-2K, 2K), no-ops
            ops["key"] = rng.integers(-2 * KS, 2 * KS, (R, BS)).astype(np.int32)
            ops["op"] = np.where(rng.random((R, BS)) < 0.2, 0, ops["op"]).astype(np.int32)
        out.append(ops)
    return out


@pytest.mark.parametrize("budget", [None, 2, KS])
def test_store_fused_tick_matches_jax(budget):
    """``Store.fused_tick`` with the Graph against the JAX ``Store``: the
    full arm (two ``join_tree`` runs), and the delta arm (two
    ``join_tree_rows`` runs) at a budget every tick overflows (2) and one
    none does (K). States, dirty masks and flushed metrics bit-equal after
    every tick; the edge blocks of a few keys overflow."""
    dims = {"graph": dict(num_keys=KS, v_capacity=CVS, e_capacity=CES)}
    ref = jax_store.Store(R, dims, dirty_budget=budget)
    mine = store.Store(R, dims, dirty_budget=budget, device="cpu")
    for t, ops in enumerate(_store_stream(13, 8)):
        ref.fused_tick({"graph": _jax(ops)})
        mine.fused_tick({"graph": _torch(ops)})
        _assert_equal(mine.states["graph"], ref.states["graph"], f"tick {t}")
        _assert_equal(mine.dirty["graph"], ref.dirty["graph"], f"dirty {t}")
        for f, x in mine.states["graph"].items():
            assert torch.equal(x, x[:1].expand_as(x)), (t, f)
    assert mine.flush_metrics() == pytest.approx(ref.flush_metrics())
    assert int(mine.states["graph"]["e_valid"].sum(-1).max()) == CES


def test_two_types_one_store_share_tree_scratch():
    """The 2P-Set and the Graph in one Store at equal geometry (C = CV):
    both bit-equal to JAX's after every tick while the 2P-Set's converge
    tree and the Graph's vertex tree run one after the other in the same
    scratch tensors (same field names and geometry), and the edge tree in
    its own."""
    dims = {"tpset": dict(num_keys=KS, capacity=CVS),
            "graph": dict(num_keys=KS, v_capacity=CVS, e_capacity=CES)}
    ref = jax_store.Store(5, dims)
    mine = store.Store(5, dims, device="cpu")
    rng = np.random.default_rng(14)
    for t in range(3):
        ops = {"tpset": workloads.tpset_add_remove(rng, 5, KS, BS, num_elems=8),
               "graph": workloads.graph_ops(rng, 5, KS, BS, num_vertices=6,
                                            out_degree=3)}
        ref.fused_tick({tc: _jax(o) for tc, o in ops.items()})
        mine.fused_tick({tc: _torch(o) for tc, o in ops.items()})
        for tc in dims:
            _assert_equal(mine.states[tc], ref.states[tc], f"{tc} tick {t}")
    tp = replica_tree.tree_scratch(tpset.FIELDS, mine.states["tpset"], 3)
    vx = replica_tree.tree_scratch(tpset.FIELDS,
                                   vertex_view(mine.states["graph"]), 3)
    ed = replica_tree.tree_scratch(("src", "dst", "removed", "valid"),
                                   edge_view(mine.states["graph"]), 3)
    assert vx is tp
    assert ed["removed"].shape[-1] == CES != CVS


def test_convert_carries_a_jax_store():
    """``convert.load_store`` carries a JAX ``Store``'s Graph (two blocks
    of different widths) and 2P-Set states and dirty masks into the
    port's, which continues bit-equal."""
    dims = {"graph": dict(num_keys=KS, v_capacity=CVS, e_capacity=CES),
            "tpset": dict(num_keys=KS, capacity=CVS)}
    rng = np.random.default_rng(15)
    stream = [{"graph": g, "tpset": workloads.tpset_add_remove(
        rng, R, KS, BS, num_elems=8)} for g in _store_stream(16, 4)]
    ref = jax_store.Store(R, dims, dirty_budget=KS // 2)
    for ops in stream[:2]:
        ref.fused_tick({tc: _jax(o) for tc, o in ops.items()})
    mine = store.Store(R, dims, dirty_budget=KS // 2, device="cpu")
    convert.load_store(mine, ref.states, ref.dirty)
    for ops in stream[2:]:
        ref.fused_tick({tc: _jax(o) for tc, o in ops.items()})
        mine.fused_tick({tc: _torch(o) for tc, o in ops.items()})
        for tc in dims:
            _assert_equal(mine.states[tc], ref.states[tc], tc)
    assert mine.states["graph"]["v"].shape == (R, KS, CVS)
    assert mine.states["graph"]["src"].shape == (R, KS, CES)


# -- SafeKV ---------------------------------------------------------------------

N, W, KC, CVC, CEC, BC = 4, 8, 6, 8, 24, 16


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


def _by_key(st):
    return {**canonical_row(vertex_view(st)),
            **{f"e_{f}": x for f, x in canonical_row(
                edge_view(st), ("src", "dst")).items()}}


def test_safekv_rounds_match_jax():
    """The Graph through the port's ``SafeKV.step`` and JAX's at N=4, W=8:
    the op mix of the smoke script's graph_consensus phase over 8 vertex
    ids, node 3 crashed for a few rounds, then idle rounds; every device
    leaf and the packed output bit-equal after every round. The drained
    stable views are bit-equal, every view's prospective state holds the
    stable vertices and edges by key, and ``edge_count`` of the views
    equals JAX's. A second port SafeKV loads the JAX one's state after
    round 4 (``load_state``, the two blocks of different widths carried
    across as numpy) and continues bit-equal."""
    dims = dict(num_keys=KC, v_capacity=CVC, e_capacity=CEC)
    mine = safecrdt.SafeKV(DagConfig(N, W), graph.SPEC, ops_per_block=BC,
                           device="cpu", **dims)
    ref = JaxSafeKV(JaxDagConfig(N, W), jax_graph.SPEC, ops_per_block=BC,
                    **dims)
    rng = np.random.default_rng(18)
    idle = {f: np.zeros((N, BC), np.int32) for f in base.OP_FIELDS}
    loaded = None
    for t in range(14):
        ops = (workloads.graph_ops(rng, N, KC, BC, num_vertices=8,
                                   out_degree=3) if t < 6 else idle)
        active = np.ones(N, bool)
        active[N - 1] = not 2 <= t < 4
        if t == 5:
            loaded = safecrdt.SafeKV(DagConfig(N, W), graph.SPEC,
                                     ops_per_block=BC, device="cpu", **dims)
            loaded.load_state({**_device_state(ref),
                               **{f: copy.deepcopy(getattr(ref, f))
                                  for f in safecrdt.HOST_FIELDS}})
        if loaded is not None:
            loaded.step(ops, active=active)
        packed, meta = mine.step_dispatch(ops, active=active)
        jpacked, jmeta = ref.step_dispatch(ops, active=active)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked),
                                      err_msg=f"packed round {t}")
        mine.step_absorb(packed, meta)
        ref.step_absorb(jpacked, jmeta)
        _assert_equal(_device_state(mine), _device_state(ref), f"round {t}")
        _assert_equal(mine.query_prospective("edge_count"),
                      np.asarray(ref.query_prospective("edge_count"),
                                 np.int32), f"edge_count {t}")
    assert mine.stats == ref.stats and mine.stats["slots_dropped"] == 0
    assert mine.stats["state_transfers"] > 0
    _assert_equal(_device_state(loaded), _device_state(ref), "loaded")
    for f, x in mine.stable.items():
        assert torch.equal(x, x[:1].expand_as(x)), f
    p, s = _by_key(mine.prospective), _by_key(mine.stable)
    for f in s:
        assert torch.equal(p[f], s[f]), f
    assert int(mine.query_stable("edge_count").sum()) > 0


def test_intra_batch_dependency_through_safekv():
    """[av v, av w, ae v->w] in one batch through the port's SafeKV: each
    op's capture observes the earlier ops of its batch, so the origin sees
    the edge at once and every replica's stable state holds it after a
    few idle rounds, as in JAX."""
    n, b = 4, 4
    dims = dict(num_keys=2, v_capacity=8, e_capacity=8)
    kv = safecrdt.SafeKV(DagConfig(n, 8), graph.SPEC, ops_per_block=b,
                         device="cpu", **dims)
    ref = JaxSafeKV(JaxDagConfig(n, 8), jax_graph.SPEC, ops_per_block=b,
                    **dims)
    ops = {f: np.zeros((n, b), np.int32) for f in base.OP_FIELDS}
    ops["op"][0, :3] = [graph.OP_ADD_VERTEX, graph.OP_ADD_VERTEX,
                        graph.OP_ADD_EDGE]
    ops["a0"][0, :3] = [1, 2, 1]
    ops["a1"][0, 2] = 2
    kv.step(ops)
    ref.step(ops)
    assert int(kv.query_prospective("edge_count")[0, 0]) == 1
    idle = {f: np.zeros_like(x) for f, x in ops.items()}
    for _ in range(4):
        kv.step(idle)
        ref.step(idle)
    counts = kv.query_stable("edge_count")[:, 0]
    assert (counts == 1).all(), counts
    _assert_equal(_device_state(kv), _device_state(ref), "safekv")


# -- tests/test_models.py's and tests/test_replay.py's scenarios ----------------

def _g(st, op, a0=0, a1=0):
    return graph.apply_ops(st, base.make_op_batch(op=[op], key=[0], a0=[a0],
                                                  a1=[a1], device="cpu"))


def test_graph_vertex_edge_lifecycle():
    st = graph.init(1, v_capacity=8, e_capacity=8, device="cpu")
    st = _g(st, graph.OP_ADD_VERTEX, a0=1)
    st = _g(st, graph.OP_ADD_VERTEX, a0=2)
    assert bool(graph.contains_vertex(st, 0, 1))
    st = _g(st, graph.OP_ADD_EDGE, a0=1, a1=2)
    assert bool(graph.contains_edge(st, 0, 1, 2))
    st = _g(st, graph.OP_REMOVE_VERTEX, a0=1)  # incident live edge
    assert bool(graph.contains_vertex(st, 0, 1))
    st = _g(st, graph.OP_REMOVE_EDGE, a0=1, a1=2)
    assert not bool(graph.contains_edge(st, 0, 1, 2))
    st = _g(st, graph.OP_REMOVE_VERTEX, a0=1)
    assert not bool(graph.contains_vertex(st, 0, 1))


def test_graph_edge_requires_vertices():
    st = _g(graph.init(1, 8, 8, device="cpu"), graph.OP_ADD_EDGE, a0=1, a1=2)
    assert int(graph.edge_count(st)[0]) == 0


def test_graph_dangling_edge_filtered_after_merge():
    """Concurrent remove-vertex / add-edge: the edge survives in the state
    but the filter hides it; both merge orders agree, and with JAX."""
    a = graph.init(1, 8, 8, device="cpu")
    a = _g(a, graph.OP_ADD_VERTEX, a0=1)
    a = _g(a, graph.OP_ADD_VERTEX, a0=2)
    b = graph.merge(graph.init(1, 8, 8, device="cpu"), a)
    a = _g(a, graph.OP_ADD_EDGE, a0=1, a1=2)
    b = _g(b, graph.OP_REMOVE_VERTEX, a0=2)
    m1, m2 = graph.merge(a, b), graph.merge(b, a)
    _assert_equal(m1, m2, "commutes")
    assert not bool(graph.contains_edge(m1, 0, 1, 2))
    assert int(graph.edge_count(m1)[0]) == 0
    _assert_equal(m1, jax_graph.merge(_jax(convert.tree_to_numpy(a)),
                                      _jax(convert.tree_to_numpy(b))), "jax")


def test_graph_merge_idempotent():
    a = graph.init(1, 8, 8, device="cpu")
    a = _g(a, graph.OP_ADD_VERTEX, a0=1)
    a = _g(a, graph.OP_ADD_VERTEX, a0=2)
    a = _g(a, graph.OP_ADD_EDGE, a0=1, a1=2)
    _assert_equal(graph.merge(a, a), a, "idempotent")


def test_graph_replay_orders_converge():
    """Captured ops applied in either order on fresh replicas join to the
    same state; an ``rv`` refused at capture (a live incident edge) stays
    refused on replay, as in JAX."""
    origin = graph.apply_ops(graph.init(1, 8, 8, device="cpu"),
                             base.make_op_batch(op=[1, 1, 3], key=[0, 0, 0],
                                                a0=[1, 2, 1], a1=[0, 0, 2],
                                                device="cpu"))
    ops = base.make_op_batch(op=[4, 1], key=[0, 0], a0=[1, 3], a1=[2, 0],
                             device="cpu")
    prepared = graph.SPEC.prepare_ops(origin, ops)
    joined = []
    for order in ((0, 1), (1, 0)):
        st = graph.init(1, 8, 8, device="cpu")
        for i in order:
            st = graph.apply_ops(st, {f: v[i:i + 1] for f, v in prepared.items()})
        joined.append(graph.merge(st, graph.init(1, 8, 8, device="cpu")))
    _assert_equal(joined[0], joined[1], "orders")
    rv = graph.SPEC.prepare_ops(origin, base.make_op_batch(
        op=[2], key=[0], a0=[1], device="cpu"))
    assert int(rv["ok"][0, 0]) == 0
    st = graph.apply_ops(origin, rv)
    assert bool(graph.contains_vertex(st, 0, 1))
    jorigin = jax_graph.apply_ops(jax_graph.init(1, 8, 8), jax_base.make_op_batch(
        op=[1, 1, 3], key=[0, 0, 0], a0=[1, 2, 1], a1=[0, 0, 2]))
    _assert_equal(prepared, jax_graph.SPEC.prepare_ops(
        jorigin, jax_base.make_op_batch(op=[4, 1], key=[0, 0], a0=[1, 3],
                                        a1=[2, 0])), "prepared")

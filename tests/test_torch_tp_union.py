"""The 2P-Set's and the Graph's union edge cases on the CPU: the port's
``kernels.tp_union``, ``edge_union`` and their row-list modes (their plain
versions, which run for CPU tensors) against JAX's ``setops.slot_union``
under ``tpset._combine`` and the Graph merge's tombstone OR, ``graph.merge``
and ``store.converge_delta``'s slab join, bit-equal (tolerance exactly 0).

The cases come from ``workloads.tp_union_case``, which the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` reuse to hold the
kernels' merge of sorted rows (a row's appended tail sorted and merged
into its prefix) against the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import graph as jax_graph
from janus_tpu.models import tpset as jax_tpset
from janus_tpu.ops import setops as jax_setops
from janus_tpu.runtime import store as jax_store

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import graph, tpset
from janus_tpu_torch.runtime import store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

K, C, CV = 6, 16, 8
CASES = workloads.TP_UNION_CASES
LAYOUTS = ("tp", "edge")
WRAPPERS = {"tp": kernels.tp_union, "edge": kernels.edge_union}

# the JAX functions, jitted so that each shape compiles once; the edge
# union folds as graph.merge does (graph.py:184-193)
J_UNION = {
    "tp": jax.jit(lambda a, b, cap: jax_setops.slot_union(
        a, b, jax_tpset.KEY_FIELDS, jax_tpset._combine, capacity=cap),
        static_argnums=2),
    "edge": jax.jit(lambda a, b, cap: jax_setops.slot_union(
        a, b, ("src", "dst"),
        lambda p, q: {"removed": p["removed"] | q["removed"]}, capacity=cap),
        static_argnums=2)}
J_GRAPH_MERGE = jax.jit(jax_graph.merge)
SPECS = {"tp": (jax_tpset.SPEC, tpset.SPEC), "edge": (jax_graph.SPEC,
                                                      graph.SPEC)}
J_CONVERGE = {layout: jax.jit(lambda st, s=SPECS[layout][0]:
                              jax_store.converge(s, st))
              for layout in LAYOUTS}
J_CONVERGE_DELTA = {layout: jax.jit(
    lambda st, dirty, budget, s=SPECS[layout][0]: jax_store.converge_delta(
        s, st, dirty, budget), static_argnums=2) for layout in LAYOUTS}


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    """Copies: the port writes in place, and JAX on the CPU may still be
    reading the same numpy memory (its dispatch is asynchronous)."""
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _assert_equal(got, want, where=""):
    got = convert.tree_to_numpy(got)
    for f in want:
        w = np.asarray(want[f])
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, (where, f)
        np.testing.assert_array_equal(got[f], w, err_msg=f"{where}.{f}")


def _case(layout, case, seed, c=C):
    return workloads.tp_union_case(np.random.default_rng(seed), case, (K,), c,
                                   edges=layout == "edge")


@pytest.mark.parametrize("cap", [10, C, 40])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_union_matches_slot_union(layout, case, cap):
    """Fresh outputs at a capacity below, at and above one row's: the
    cut to ``cap`` with its overflow, and the canonical fill."""
    a, b = _case(layout, case, CASES.index(case))
    want, want_ovf = J_UNION[layout](_jax(a), _jax(b), cap)
    got, ovf = WRAPPERS[layout](_torch(a), _torch(b), cap)
    _assert_equal(got, want, case)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
    if case == "full" and cap < 2 * C:
        assert (ovf.numpy() > 0).all()


@pytest.mark.parametrize("mode", ["alias", "repeat", "narrow"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_union_out_matches_slot_union(layout, case, mode):
    """``out`` aliasing ``a`` (the converge's last level writes into the
    replicas it read), ``out`` of three planes (its broadcast), and rows of
    unequal widths (Ca != Cb)."""
    a, b = _case(layout, case, 20 + CASES.index(case))
    fn = WRAPPERS[layout]
    if mode == "narrow":
        b = {f: np.ascontiguousarray(x[..., :9]) for f, x in b.items()}
        want, want_ovf = J_UNION[layout](_jax(a), _jax(b), 12)
        got, ovf = fn(_torch(a), _torch(b), 12)
        _assert_equal(got, want, case)
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
        return
    want, want_ovf = J_UNION[layout](_jax(a), _jax(b), C)
    ta, tb = _torch(a), _torch(b)
    if mode == "alias":
        out = {f: x.unsqueeze(0) for f, x in ta.items()}
    else:
        out = {f: torch.full((3, K, C), 7, dtype=x.dtype)
               for f, x in ta.items()}
    _, ovf = fn(ta, tb, C, out=out)
    for p in range(out["valid"].shape[0]):
        _assert_equal({f: x[p] for f, x in out.items()}, want, f"{case} {p}")
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))


def _graph(vertices, edges):
    """The Graph's leaves of a TP case's rows and an EDGE case's."""
    return {**{leaf: vertices[f] for leaf, f in zip(
                ("v", "v_removed", "v_valid"), ("elem", "removed", "valid"))},
            **{leaf: edges[f] for leaf, f in zip(
                ("src", "dst", "e_removed", "e_valid"),
                ("src", "dst", "removed", "valid"))}}


@pytest.mark.parametrize("case", CASES)
def test_graph_merge_matches_jax(case):
    """``graph.merge`` (``tp_union`` on the vertex block, ``edge_union``
    on the edge block) against JAX's ``graph.merge``, the edge case in
    both blocks."""
    seed = 60 + CASES.index(case)
    va, vb = _case("tp", case, seed, CV)
    ea, eb = _case("edge", case, seed + 1)
    a, b = _graph(va, ea), _graph(vb, eb)
    want = J_GRAPH_MERGE(_jax(a), _jax(b))
    _assert_equal(graph.merge(_torch(a), _torch(b)), want, case)


def _state(layout, case, r, seed):
    """``[r, K, ...]`` state from the case's rows: replicas a, b, then a
    second draw's a (the Graph's vertex block from the TP case at CV
    slots, its edge block from the EDGE case)."""
    def reps(lay, c):
        a, b = _case(lay, case, seed, c)
        a2, _ = _case(lay, case, seed + 100, c)
        return [a, b, a2][:r]
    if layout == "tp":
        st = reps("tp", C)
        return {f: np.stack([x[f] for x in st]) for f in tpset.FIELDS}
    rows = [_graph(v, e) for v, e in zip(reps("tp", CV), reps("edge", C))]
    return {f: np.stack([x[f] for x in rows]) for f in graph.FIELDS}


def _rows_state(layout, case, r, dirty_rows, seed):
    """A state whose rows ``dirty_rows`` hold the case's rows and whose
    other rows are the converged (canonical, replica-equal) rows of a
    ``shared_elems`` draw: the invariant ``converge_delta`` assumes of
    clean rows, which JAX's slab join reads as padding. The dirty mask
    marks each listed row in one replica."""
    raw = _state(layout, case, r, seed)
    clean = convert.tree_to_numpy(J_CONVERGE[layout](_jax(_state(
        layout, "shared_elems", r, seed))))
    dirty = np.zeros((r, K), bool)
    dirty[np.arange(len(dirty_rows)) % r, dirty_rows] = True
    row = dirty.any(0)
    return {f: np.where(row[:, None], raw[f], clean[f]) for f in raw}, dirty


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("n_rows", [0, 1, K])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_union_rows_matches_converge_delta(layout, case, n_rows, r):
    """The row-list trees (``tp_union_rows``, and for the Graph also
    ``edge_union_rows``, per level, through ``store.converge_delta`` with
    a budget of one row) over no dirty row, one, and all K (the budget
    overflows: every row is joined); at r = 2 the one level writes the
    rows it read."""
    seed = 40 + CASES.index(case)
    dirty_rows = np.random.default_rng(seed).permutation(K)[:n_rows]
    st, dirty = _rows_state(layout, case, r, dirty_rows, seed)
    want, w_ovf, w_cnt = J_CONVERGE_DELTA[layout](_jax(st), jnp.asarray(dirty),
                                                  1)
    before = kernels.launches()
    got, ovf, cnt = store.converge_delta(SPECS[layout][1], _torch(st),
                                         torch.from_numpy(dirty), 1)
    assert kernels.launches() == before  # the CPU runs the plain versions
    _assert_equal(got, want, case)
    assert bool(ovf) == bool(w_ovf) and int(cnt) == int(w_cnt) == n_rows

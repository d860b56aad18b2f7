"""The RGA union's edge cases on the CPU: the port's ``kernels.rga_union``
and ``rga_union_rows`` (their plain versions, which run for CPU tensors)
against JAX's ``setops.slot_union`` under ``rga._combine`` and
``store.converge_delta``'s slab join, bit-equal (tolerance exactly 0).

The cases come from ``workloads.rga_union_case``, which the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` reuse to hold the
kernel's merge of sorted rows against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import rga as jax_rga
from janus_tpu.ops import setops as jax_setops
from janus_tpu.runtime import store as jax_store

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import rga
from janus_tpu_torch.runtime import store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

K, C = 6, 16
CASES = workloads.RGA_UNION_CASES

# the JAX functions, jitted so that each shape compiles once
J_UNION = jax.jit(
    lambda a, b, cap: jax_setops.slot_union(a, b, jax_rga.KEY_FIELDS,
                                            jax_rga._combine, capacity=cap),
    static_argnums=2)
J_CONVERGE = jax.jit(lambda st: jax_store.converge(jax_rga.SPEC, st))
J_CONVERGE_DELTA = jax.jit(
    lambda st, dirty, budget: jax_store.converge_delta(jax_rga.SPEC, st, dirty,
                                                       budget),
    static_argnums=2)


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


def _case(case, seed):
    return workloads.rga_union_case(np.random.default_rng(seed), case, (K,), C)


@pytest.mark.parametrize("cap", [10, C, 40])
@pytest.mark.parametrize("case", CASES)
def test_rga_union_matches_slot_union(case, cap):
    """Fresh outputs at a capacity below, at and above one row's: the
    cut to ``cap`` with its overflow, and the canonical fill."""
    a, b = _case(case, CASES.index(case))
    want, want_ovf = J_UNION(_jax(a), _jax(b), cap)
    got, ovf = kernels.rga_union(_torch(a), _torch(b), cap)
    _assert_equal(got, want, case)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
    if case == "full" and cap < 2 * C:
        assert (ovf.numpy() > 0).all()


@pytest.mark.parametrize("mode", ["alias", "repeat"])
@pytest.mark.parametrize("case", CASES)
def test_rga_union_out_matches_slot_union(case, mode):
    """``out`` aliasing ``a`` (the converge's last level writes into the
    replicas it read) and ``out`` of three planes (its broadcast)."""
    a, b = _case(case, 20 + CASES.index(case))
    want, want_ovf = J_UNION(_jax(a), _jax(b), C)
    ta, tb = _torch(a), _torch(b)
    if mode == "alias":
        out = {f: x.unsqueeze(0) for f, x in ta.items()}
    else:
        out = {f: torch.full((3, K, C), 7, dtype=x.dtype)
               for f, x in ta.items()}
    _, ovf = kernels.rga_union(ta, tb, C, out=out)
    for p in range(out["valid"].shape[0]):
        _assert_equal({f: x[p] for f, x in out.items()}, want, f"{case} {p}")
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))


def _replicas(case, r, seed):
    """``[r, K, C]`` RGA state from the case's rows: replicas a, b, then a
    second draw's a; random Lamport floors."""
    a, b = _case(case, seed)
    a2, _ = _case(case, seed + 100)
    st = {f: np.stack([x[f] for x in (a, b, a2)[:r]]) for f in rga.FIELDS}
    rng = np.random.default_rng(seed)
    st["ctr_floor"] = rng.integers(-2, C + 2, (r, K)).astype(np.int32)
    st["_depth"] = np.zeros((r, 4, 0), np.int32)
    return st


def _rows_state(case, r, dirty_rows, seed):
    """A state whose rows ``dirty_rows`` hold the case's rows and whose
    other rows are the converged (canonical, replica-equal) rows of a
    ``sorted`` draw: the invariant ``converge_delta`` assumes of clean
    rows, which JAX's slab join reads as padding. The dirty mask marks
    each listed row in one replica."""
    raw = _replicas(case, r, seed)
    clean = convert.tree_to_numpy(J_CONVERGE(_jax(_replicas("sorted", r,
                                                            seed))))
    dirty = np.zeros((r, K), bool)
    dirty[np.arange(len(dirty_rows)) % r, dirty_rows] = True
    row = dirty.any(0)
    st = {f: np.where(row[:, None], raw[f], clean[f]) for f in rga.FIELDS}
    st["ctr_floor"] = np.where(row, raw["ctr_floor"], clean["ctr_floor"])
    st["_depth"] = raw["_depth"]
    return st, dirty


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("n_rows", [0, 1, K])
@pytest.mark.parametrize("case", CASES)
def test_rga_union_rows_matches_converge_delta(case, n_rows, r):
    """The row-list tree (``rga_union_rows`` per level, through
    ``store.converge_delta`` with a budget of one row) over no dirty row,
    one, and all K (the budget overflows: every row is joined)."""
    seed = 40 + CASES.index(case)
    dirty_rows = np.random.default_rng(seed).permutation(K)[:n_rows]
    st, dirty = _rows_state(case, r, dirty_rows, seed)
    want, w_ovf, w_cnt = J_CONVERGE_DELTA(_jax(st), jnp.asarray(dirty), 1)
    before = kernels.rga_union_rows.launches
    got, ovf, cnt = store.converge_delta(rga.SPEC, _torch(st),
                                         torch.from_numpy(dirty), 1)
    assert kernels.rga_union_rows.launches == before  # the CPU runs plain
    _assert_equal(got, want, case)
    assert bool(ovf) == bool(w_ovf) and int(cnt) == int(w_cnt) == n_rows

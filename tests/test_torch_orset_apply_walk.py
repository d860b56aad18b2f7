"""The OR-Set apply's and the delta apply's selection edge cases on the
CPU: the port's ``kernels.orset_apply`` (its plain version, which runs for
CPU tensors) against JAX's ``orset._apply_ops_impl`` vmapped over the
replicas, uncaptured and as the one-lane captured scan, and the port's
``kernels.block_select`` against JAX's ``SafeKV._delta_apply`` at W*N =
1,024 blocks a view; bit-equal (tolerance exactly 0): the state, the
drops, the selection.

The apply's cases come from ``workloads.orset_apply_case``: a hot row
past its bucket, NOOP lanes on non-canonical rows, non-canonical rows no
lane gathers, out-of-range keys on full clamped rows, the INT32_MAX tag,
rows filled exactly to C and one add past it. The card tests
(``tests/test_torch_cuda.py``) reuse the generator to hold the kernel
(lanes bucketed by row, only those rows walked) against the plain
version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import orset as jax_orset
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import pncounter

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.ORSET_APPLY_CASES
GEOMETRIES = [  # (R, K, C, B)
    (2, 10, 8, 300),
    (3, 24, 16, 64),
    (2, 6, 64, 40),
]

# JAX's scan per replica, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_orset._apply_ops_impl))


def _torch(tree):
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _assert_equal(got, want, where=""):
    got, want = convert.tree_to_numpy(got), convert.tree_to_numpy(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    x, y = np.asarray(got), np.asarray(want)
    assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype,
                                                       x.shape, y.shape)
    np.testing.assert_array_equal(x, y, err_msg=where)


def _apply_both(st, ops):
    want_st, want_drop = J_APPLY(st, {f: jnp.asarray(x) for f, x in ops.items()})
    mine = _torch(st)
    drop = kernels.orset_apply(mine, _torch(ops))
    return mine, drop, want_st, want_drop


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "R{}K{}C{}B{}"
                         .format(*g))
@pytest.mark.parametrize("case", CASES)
def test_orset_apply_walk_matches_jax(case, geo):
    r, k, c, b = geo
    rng = np.random.default_rng(10 * CASES.index(case) + GEOMETRIES.index(geo))
    st, ops = workloads.orset_apply_case(rng, case, (r, b), k, c)
    before = kernels.launches()
    mine, drop, want_st, want_drop = _apply_both(st, ops)
    _assert_equal(mine, want_st, f"{case} state")
    _assert_equal(drop, want_drop, f"{case} dropped")
    assert kernels.launches() == before  # the CPU ran the plain version
    if case == "untouched":  # the rows no lane gathers, byte for byte
        half = max(k // 2, 1)
        _assert_equal({f: x[:, half:] for f, x in mine.items()},
                      {f: x[:, half:] for f, x in st.items()}, "untouched")
    if case == "out_of_range_full":  # nothing written, drops counted
        _assert_equal(mine, st, "out of range")
        assert int(drop.sum()) > 0
    if case == "exact_fill":
        assert int(drop.sum()) > 0 and bool(mine["valid"].all())


@pytest.mark.parametrize("r_cap", [1, 8])
@pytest.mark.parametrize("case", ["mixed", "out_of_range_full", "int32_max",
                                  "noop_noncanonical"])
def test_orset_apply_captured_one_lane_matches_jax(case, r_cap):
    """The captured mode: JAX's one-lane captured scan (a batch of one
    lane a replica) on every replica of a state."""
    rng = np.random.default_rng(7 * r_cap + CASES.index(case))
    st, ops = workloads.orset_apply_case(rng, case, (12, 1), 6, 8,
                                         r_cap=r_cap)
    mine, drop, want_st, want_drop = _apply_both(st, ops)
    _assert_equal(mine, want_st, f"{case} r{r_cap} state")
    _assert_equal(drop, want_drop, f"{case} r{r_cap} dropped")


@pytest.mark.parametrize("budget", [1, 1024])
@pytest.mark.parametrize("order", ["prospective", "commit"])
def test_block_select_matches_delta_apply(budget, order):
    """SafeKV's delta apply at N 64, W 16 (1,024 blocks a view), apply
    budget 1 and 1,024 (every block), in prospective and commit order:
    the port's selection and gather, then the type's apply, against JAX's
    ``_delta_apply`` with the same keys."""
    n, w, b, k = 64, 16, 2, 5
    rng = np.random.default_rng(budget + len(order))
    ring = workloads.pnc_uniform(rng, w * n, k, b)
    ring = {f: np.ascontiguousarray(x.reshape((w, n) + x.shape[1:]), np.int32)
            for f, x in ring.items()}
    ring["writer"] = rng.integers(0, n, (w, n, b)).astype(np.int32)
    ready = rng.random((n, w, n)) < 0.6
    applied = rng.random((n, w, n)) < 0.2
    slot_round = (np.arange(w) + 40).astype(np.int32)
    rng.shuffle(slot_round)
    base = np.int32(38)
    seq = None
    rel = (slot_round - base)[None, :, None] * n + np.arange(n)[None, None, :]
    key = np.broadcast_to(rel, (n, w, n)).astype(np.int32)
    if order == "commit":
        seq = rng.integers(0, 3, (n, w, n)).astype(np.int32)
        key = (seq * (w * n) + key).astype(np.int32)
    state = {f: np.zeros((n, k, n), np.int32) for f in ("p", "n")}
    jkv = JaxSafeKV(JaxDagConfig(n, w), jax_pnc.SPEC, ops_per_block=b,
                    apply_budget=budget, num_keys=k, num_writers=n)
    want_st, want_mask, _ = jkv._delta_apply(
        {f: jnp.asarray(x) for f, x in state.items()},
        {f: jnp.asarray(x) for f, x in ring.items()},
        jnp.asarray(ready & ~applied), jnp.asarray(key))
    applied_t = torch.tensor(applied)
    batch, idx, chosen = kernels.block_select(
        DagConfig(n, w), _torch(ring), torch.tensor(ready), applied_t,
        budget, torch.tensor(slot_round), torch.tensor(base),
        None if seq is None else torch.tensor(seq))
    got_st = pncounter.SPEC.apply_ops(_torch(state), batch)
    _assert_equal(got_st, want_st, f"{order} A{budget} state")
    _assert_equal(applied_t & ~torch.tensor(applied), want_mask,
                  f"{order} A{budget} selection")
    assert idx.shape == chosen.shape == (n, min(budget, w * n))
    assert int(chosen.sum()) == int(np.asarray(want_mask).sum())

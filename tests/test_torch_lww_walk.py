"""The LWW-Set walk's edge cases on the CPU: the port's
``kernels.lww_apply`` (uncaptured and captured) and ``kernels.lww_capture``
(their plain versions, which run for CPU tensors) against JAX's
``lwwset._apply_ops_impl`` and ``base.capture_and_apply`` with
``lwwset.prepare_ops``, vmapped over the views, bit-equal (tolerance
exactly 0): the state, the drops per view and the captured ``ok``.

The cases come from ``workloads.lww_walk_case``: hazard lanes on
non-canonical rows, typed_store's 64 lanes a replica over rows of 64 and
256 slots, rows walked by hundreds of lanes, a row past its bucket, and
full rows that drop. The card tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` reuse the generator to hold the kernel (live lanes
bucketed by row, many rows a warp) against the plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from janus_tpu.models import base as jax_base
from janus_tpu.models import lwwset as jax_lwwset

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models.base import OP_FIELDS

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.LWW_WALK_CASES
GEOMETRIES = [  # (V, K, C, B)
    (3, 24, 8, 64),
    (2, 10, 16, 300),
]

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_lwwset._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_lwwset.SPEC, st, o)))


def _torch(tree):
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _assert_equal(got, want, where=""):
    got, want = convert.tree_to_numpy(got), convert.tree_to_numpy(want)
    if isinstance(want, dict):
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    x, y = np.asarray(got), np.asarray(want)
    assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype,
                                                       x.shape, y.shape)
    np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "V{}K{}C{}B{}"
                         .format(*g))
@pytest.mark.parametrize("case", CASES)
def test_lww_walk_matches_jax(case, geo, mode):
    """One batch through the port and through JAX: the uncaptured apply,
    the captured apply (the case's ``ok``) and the capture (its ``ok``,
    then the same state and drops as the captured apply of what it
    captured)."""
    v, k, c, b = geo
    rng = np.random.default_rng(10 * CASES.index(case) + GEOMETRIES.index(geo))
    st, ops = workloads.lww_walk_case(rng, case, (v, b), k, c,
                                      captured=mode == "captured")
    mine = _torch(st)
    before = kernels.launches()
    if mode == "capture":
        want_st, prepared = J_CAPTURE(st, ops)
        _, want_drop = J_APPLY(st, prepared)
        ok, drop = kernels.lww_capture(mine, _torch(ops))
        _assert_equal(ok, prepared["ok"], f"{case} ok")
    else:
        want_st, want_drop = J_APPLY(st, ops)
        drop = kernels.lww_apply(mine, _torch(ops))
    assert kernels.launches() == before  # the CPU runs plain
    _assert_equal(mine, want_st, f"{case} {mode}")
    _assert_equal(drop, want_drop, f"{case} {mode} dropped")
    if case == "full_drop":
        assert (np.asarray(want_drop) > 0).all()


def test_lww_walk_cases_reach_their_edges():
    """Each case holds what it names, at the second geometry."""
    v, k, c, b = GEOMETRIES[1]

    def case(name):
        return workloads.lww_walk_case(np.random.default_rng(1), name,
                                       (v, b), k, c)

    _, ops = case("long_rows")
    live = np.isin(ops["op"], (1, 2))
    assert live.all() and (ops["key"] < 8).all()
    _, ops = case("hot_row")
    assert (ops["key"] == 1).mean() >= 0.9
    st, _ = case("full_drop")
    assert st["valid"].all()
    _, ops = case("hazards")
    assert (ops["key"] < 0).any() and (ops["key"] >= k).any()
    assert set(np.unique(ops["op"])) == {0, 1, 2, 3}
    assert sorted(OP_FIELDS) == sorted(case("typed_store")[1])

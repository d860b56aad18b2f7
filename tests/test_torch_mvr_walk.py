"""The MVRegister walk's edge cases on the CPU: the port's
``kernels.mvr_apply`` (captured and uncaptured) and ``kernels.mvr_capture``
(their plain versions, which run for CPU tensors) against JAX's
``mvregister._apply_ops_impl`` and ``base.capture_and_apply``, vmapped
over the views, bit-equal (tolerance exactly 0): the state, the drops per
view and the captured clocks.

The cases come from ``workloads.mvr_walk_case``: one row of more than
3,000 writes (longer than the kernel's ring of lanes in flight and than
one window of 2,048 lane indices), a row whose frontier passes the
capacity V and falls back many times, exact twins, and negative and
out-of-range keys and writers; at V = 1, 8 and 32 values a key, W = 4 and
64 clock lanes. The card tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` reuse the generator to hold the kernel against the
plain version.
"""
import jax
import numpy as np
import pytest
import torch

from janus_tpu.models import base as jax_base
from janus_tpu.models import mvregister as jax_mvr

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.kernels.mvr_rows import OP_FIELDS

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.MVR_WALK_CASES
V, K, B = 2, 5, 3200
# (values a key, clock lanes)
GEOMETRY = [(1, 64), (8, 64), (32, 4)]

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_mvr._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_mvr.SPEC, st, o)))


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


@pytest.mark.parametrize("vc,w", GEOMETRY)
@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case", CASES)
def test_walk_matches_jax(case, mode, vc, w):
    """One batch of B = 3,200 lanes a view through the port and through
    JAX: the uncaptured apply, the captured apply (the case's wclocks) and
    the capture (its clocks, then the same state and drops as the
    captured apply of what it captured)."""
    seed = 10 * CASES.index(case) + vc + w
    st, ops = workloads.mvr_walk_case(np.random.default_rng(seed), case, V, K,
                                      vc, w, B)
    if mode != "captured":
        ops = {f: ops[f] for f in OP_FIELDS}
    mine = _torch(st)
    before = kernels.launches()
    if mode == "capture":
        want_st, prepared = J_CAPTURE(st, ops)
        _, want_drop = J_APPLY(st, prepared)
        wclock, drop = kernels.mvr_capture(mine, _torch(ops))
        _assert_equal(wclock, prepared["wclock"], f"{case} wclock")
    else:
        want_st, want_drop = J_APPLY(st, ops)
        drop = kernels.mvr_apply(mine, _torch(ops))
    assert kernels.launches() == before  # the CPU runs plain
    _assert_equal(mine, want_st, f"{case} {mode}")
    _assert_equal(drop, want_drop, f"{case} {mode} dropped")
    if case == "cut" and mode == "captured":
        assert (np.asarray(want_drop) > 0).all()

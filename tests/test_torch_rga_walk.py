"""The RGA walk's edge cases on the CPU, at the shape of SafeKV's delta
applies: the port's ``kernels.rga_apply`` (captured and uncaptured) and
``kernels.rga_capture`` (their plain versions, which run for CPU
tensors) against JAX's ``rga._apply_ops_impl`` and
``base.capture_and_apply`` with ``rga.prepare_ops``, vmapped over the
views, bit-equal (tolerance exactly 0): the state with its Lamport
floors, the drops per view and the captured counters.

The cases come from ``workloads.rga_walk_case``: batches of 16 blocks a
view whose first quarter is live and the rest OP_NOOP or code 3 at key 0
or at the keys of live lanes, as a delta apply's batch is; negative
floors in front of full rows of negative counters, where an in-range
no-op's clamp of the floor at 0 changes the next uncaptured insert's
counter; rows only no-ops touch; keys in [-K, 2K) with codes -1 to 5;
and one row gathering two thirds of the live lanes. The card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` reuse the generator
to hold the kernel's walk against the plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from janus_tpu.models import base as jax_base
from janus_tpu.models import rga as jax_rga

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.kernels.rga_rows import FIELDS

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.RGA_WALK_CASES
V, K, C, BLOCK = 2, 8, 16, 32

# the JAX functions, jitted so that each shape compiles once
J_APPLY = jax.jit(jax.vmap(jax_rga._apply_ops_impl))
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_rga.SPEC, st, o)))


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


def _case(case):
    seed = 40 + CASES.index(case)
    return workloads.rga_walk_case(np.random.default_rng(seed), case, V, K,
                                   C, BLOCK)


def _jax_state(st):
    return {**st, "_depth": np.zeros((V, 4, 0), np.int32)}


@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case", CASES)
def test_walk_matches_jax(case, mode):
    """One batch of 512 lanes a view through the port and through JAX:
    the uncaptured apply, the captured apply (the case's ``eff_ctr``) and
    the capture (its counters, then the same state)."""
    st, ops = _case(case)
    if mode != "captured":
        ops = {f: x for f, x in ops.items() if f != "eff_ctr"}
    mine = _torch(st)
    if mode == "capture":
        eff, drop = kernels.rga_capture(mine, _torch(ops))
        want_st, want_ops = J_CAPTURE(_jax_state(st), ops)
        _assert_equal(eff, want_ops["eff_ctr"], "eff_ctr")
        _, want_drop = J_APPLY(_jax_state(st), {**ops, "eff_ctr":
                                                np.asarray(want_ops["eff_ctr"])})
    else:
        drop = kernels.rga_apply(mine, _torch(ops))
        want_st, want_drop = J_APPLY(_jax_state(st), ops)
    _assert_equal(drop, want_drop, "dropped")
    _assert_equal(mine, {f: want_st[f] for f in (*FIELDS, "ctr_floor")},
                  "state")


def test_cases_reach_what_they_are_for():
    """Each case holds what its name says at the tested shape: live lanes a
    quarter of the batch (a half for the hot row), a row past a walk's
    bucket of 128 lanes, rows only no-ops gather, and in the negative-floor
    case uncaptured mints that read the floor's clamp."""
    live = {}
    for case in CASES:
        st, ops = _case(case)
        op = ops["op"]
        live[case] = ((op == 1) | (op == 2)).mean()
        if case == "hot_row":
            hot = ((ops["key"] == 1) & ((op == 1) | (op == 2))).sum(axis=1)
            assert (hot > 128).all()
        if case == "noop_rows":
            quiet = np.arange(1, K, 3)
            for v in range(V):
                gathered = np.isin(ops["key"][v], quiet)
                assert gathered.any()
                assert not ((op[v] == 1) | (op[v] == 2))[gathered].any()
        if case == "negative_floors":
            assert (st["ctr_floor"] < 0).all()
            full = st["valid"].all(axis=-1) & (st["id_ctr"] < 0).all(axis=-1)
            assert full[:, ::3].all()
            # the clamp shows: a mint there differs with it and without it
            plain = {f: x for f, x in ops.items() if f != "eff_ctr"}
            eff, _ = kernels.rga_capture(_torch(st), _torch(plain))
            assert (eff.numpy()[..., 0] == 1).any()
            assert (eff.numpy()[..., 0] < 0).any()
    assert live["consensus"] == pytest.approx(0.25, abs=0.01)
    assert live["hot_row"] == pytest.approx(0.5, abs=0.01)

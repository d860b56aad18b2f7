"""Parity of the port's PN-Counter (and its ``pnc_apply`` kernel's plain
version, which the wrapper runs for CPU tensors) with the JAX package.

Inputs are made with numpy from a seed and fed to both. Every comparison
is bit-equal (int32 state; tolerance exactly 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from janus_tpu.models import pncounter as jax_pnc

from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import base, pncounter

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

K, W = 7, 5
INT32_MAX = np.iinfo(np.int32).max


def _ops(rng, shape, num_keys=K, num_writers=W, big=False):
    """Ops with duplicates, no-ops, unknown op codes, keys and writers in
    [-size, 2*size), and (optionally) amounts near INT32_MAX."""
    a0 = (rng.integers(INT32_MAX - 50, INT32_MAX, shape) if big
          else rng.integers(-20, 20, shape))
    return {
        "op": rng.integers(0, 4, shape).astype(np.int32),
        "key": rng.integers(-num_keys, 2 * num_keys, shape).astype(np.int32),
        "a0": a0.astype(np.int32),
        "a1": np.zeros(shape, np.int32),
        "a2": np.zeros(shape, np.int32),
        "writer": rng.integers(-num_writers, 2 * num_writers, shape).astype(np.int32),
    }


def _state(rng, lead=()):
    shape = lead + (K, W)
    return {f: rng.integers(-1000, 1000, shape).astype(np.int32) for f in "pn"}


def _jax_apply(state, ops):
    out = jax_pnc.apply_ops({f: jnp.asarray(v) for f, v in state.items()},
                            {f: jnp.asarray(v) for f, v in ops.items()})
    return {f: np.asarray(v) for f, v in out.items()}


def _torch(tree):
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


@pytest.mark.parametrize("big", [False, True], ids=["small", "wraparound"])
def test_apply_ops_matches_jax(big):
    """Duplicates, no-ops, op codes outside {1, 2}, keys and writers in
    [-size, 2*size) and int32 wraparound: bit-equal to JAX's scatter-add."""
    rng = np.random.default_rng(1 if big else 0)
    state, ops = _state(rng), _ops(rng, (64,), big=big)
    ref = _jax_apply(state, ops)
    out = pncounter.apply_ops(_torch(state), _torch(ops))
    for f in "pn":
        np.testing.assert_array_equal(out[f].numpy(), ref[f])
    if big:  # the sums really wrapped
        assert (ref["p"] < 0).any() or (ref["n"] < 0).any()


def test_apply_ops_batched_over_replicas_matches_vmap():
    """State [R, K, W] with ops [R, B] (the kernel's replica axis) equals
    JAX's per-replica apply."""
    import jax

    rng = np.random.default_rng(2)
    state, ops = _state(rng, (3,)), _ops(rng, (3, 40))
    ref = jax.vmap(jax_pnc.apply_ops)(
        {f: jnp.asarray(v) for f, v in state.items()},
        {f: jnp.asarray(v) for f, v in ops.items()})
    out = pncounter.apply_ops(_torch(state), _torch(ops))
    for f in "pn":
        np.testing.assert_array_equal(out[f].numpy(), np.asarray(ref[f]))


def test_apply_ops_pnc_uniform_workload():
    """The bench generator draws the same batches as the JAX package's."""
    from janus_tpu.bench.workloads import pnc_uniform as jax_uniform

    a = workloads.pnc_uniform(np.random.default_rng(5), 4, K, 32)
    b = jax_uniform(np.random.default_rng(5), 4, K, 32)
    for f in base.OP_FIELDS:
        np.testing.assert_array_equal(a[f], np.asarray(b[f]))
        assert a[f].dtype == np.int32
    ops = workloads.ops_to_device(a, "cpu")
    state = {f: np.zeros((4, K, 4), np.int32) for f in "pn"}
    out = pncounter.apply_ops(_torch(state), ops)
    import jax
    ref = jax.vmap(jax_pnc.apply_ops)(
        {f: jnp.asarray(v) for f, v in state.items()}, b)
    for f in "pn":
        np.testing.assert_array_equal(out[f].numpy(), np.asarray(ref[f]))


def test_merge_and_value_match_jax():
    rng = np.random.default_rng(3)
    a, b = _state(rng, (2,)), _state(rng, (2,))
    a["p"][0, 0, :] = INT32_MAX  # the value's int32 sum wraps
    ref_m = jax_pnc.merge({f: jnp.asarray(v) for f, v in a.items()},
                          {f: jnp.asarray(v) for f, v in b.items()})
    out_m = pncounter.merge(_torch(a), _torch(b))
    for f in "pn":
        np.testing.assert_array_equal(out_m[f].numpy(), np.asarray(ref_m[f]))
    ref_v = np.asarray(jax_pnc.value({f: jnp.asarray(v) for f, v in a.items()}))
    out_v = pncounter.value(_torch(a))
    assert out_v.dtype == torch.int32
    np.testing.assert_array_equal(out_v.numpy(), ref_v)


def test_apply_ops_delta_dirty_rows_match_jax():
    rng = np.random.default_rng(4)
    state, ops = _state(rng), _ops(rng, (30,))
    ref_st, ref_info = jax_pnc.apply_ops_delta(
        {f: jnp.asarray(v) for f, v in state.items()},
        {f: jnp.asarray(v) for f, v in ops.items()})
    st, info = pncounter.apply_ops_delta(_torch(state), _torch(ops))
    np.testing.assert_array_equal(info["dirty"].numpy(),
                                  np.asarray(ref_info["dirty"]))
    assert int(info["slots_dropped"]) == int(ref_info["slots_dropped"]) == 0
    for f in "pn":
        np.testing.assert_array_equal(st[f].numpy(), np.asarray(ref_st[f]))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launches()
    rng = np.random.default_rng(6)
    state, ops = _state(rng, (2,)), _ops(rng, (2, 16))
    a, b = _torch(state), _torch(state)
    kernels.pnc_apply(a["p"], a["n"], _torch(ops))
    kernels.pnc_apply_plain(b["p"], b["n"], _torch(ops))
    kernels.replica_join(a["p"], a["n"])
    kernels.replica_join_plain(b["p"], b["n"])
    for f in "pn":
        assert torch.equal(a[f], b[f])
    assert kernels.launches() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert {"pnc_apply", "replica_join"} <= kernels.WRAPPERS.keys()


@pytest.mark.parametrize("field", ["op", "key", "a0", "writer"])
def test_pnc_apply_refuses_an_op_field_of_another_shape(field):
    """Every field the kernel reads must be [R, B] with the B of ``op``:
    one column short, or one replica row short, raises before any
    version runs."""
    rng = np.random.default_rng(8)
    state, ops = _torch(_state(rng, (2,))), _torch(_ops(rng, (2, 16)))
    before = {f: v.clone() for f, v in state.items()}
    for short in (ops[field][:, :15], ops[field][:1]):
        with pytest.raises(ValueError, match="op field"):
            kernels.pnc_apply(state["p"], state["n"], {**ops, field: short})
    for f in "pn":
        assert torch.equal(state[f], before[f])


def test_make_op_batch_pads_and_checks_shapes():
    ops = base.make_op_batch(op=[1, 2], key=[0, 1], batch=4, device="cpu")
    assert all(v.shape == (4,) and v.dtype == torch.int32 for v in ops.values())
    assert ops["op"].tolist() == [1, 2, 0, 0]
    with pytest.raises(ValueError):
        base.make_op_batch(op=[1, 2], key=[0], device="cpu")
    with pytest.raises(NotImplementedError, match="Captured"):
        spec = base.CRDTTypeSpec(
            name="Captured", type_code="cap", init=None, apply_ops=None,
            merge=None, queries={}, op_codes={}, prepare_ops=lambda s, o: o)
        base.capture_and_apply(spec, {}, ops)

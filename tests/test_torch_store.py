"""Parity of the port's replicated store and engine tick (with the
``replica_join`` kernel's plain version, which the wrapper runs for CPU
tensors) with the JAX package.

Inputs are made with numpy from a seed and fed to both. Every comparison
is bit-equal (int32 state; tolerance exactly 0).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from janus_tpu.bench.workloads import pnc_uniform as jax_uniform
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.runtime import engine as jax_engine
from janus_tpu.runtime import store as jax_store

from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.runtime import engine, store

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

K, W = 6, 9


def _state(rng, r):
    return {f: rng.integers(-(2**31), 2**31 - 1, (r, K, W), dtype=np.int64)
            .astype(np.int32) for f in "pn"}


def _torch(tree):
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _jnp(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


@pytest.mark.parametrize("r", [1, 2, 5, 8])
def test_join_all_matches_jax(r):
    st = _state(np.random.default_rng(r), r)
    ref = jax_store.join_all(jax_pnc.SPEC, _jnp(st))
    out = store.join_all(pncounter.SPEC, _torch(st))
    for f in "pn":
        np.testing.assert_array_equal(out[f].numpy(), np.asarray(ref[f]))


@pytest.mark.parametrize("r", [1, 3, 4, 7])
def test_converge_matches_jax_and_is_materialized(r):
    st = _state(np.random.default_rng(10 + r), r)
    ref = jax_store.converge(jax_pnc.SPEC, _jnp(st))
    out = store.converge(pncounter.SPEC, _torch(st))
    for f in "pn":
        np.testing.assert_array_equal(out[f].numpy(), np.asarray(ref[f]))
        # a real [R, K, W] buffer, not R aliases of one row
        assert out[f].is_contiguous() and out[f].stride()[0] == K * W
    if r > 1:
        out["p"][0, 0, 0] += 1  # writing one replica leaves the others
        assert out["p"][1, 0, 0] == out["p"][0, 0, 0] - 1


def test_replicated_init_and_gossip_step_match_jax():
    st0 = store.replicated_init(pncounter.SPEC, 3, device="cpu",
                                num_keys=K, num_writers=W)
    ref0 = jax_store.replicated_init(jax_pnc.SPEC, 3, num_keys=K, num_writers=W)
    for f in "pn":
        np.testing.assert_array_equal(st0[f].numpy(), np.asarray(ref0[f]))
        assert st0[f].stride()[0] == K * W
    st = _state(np.random.default_rng(20), 5)
    for d in (1, 2):
        ref = jax_store.gossip_step(jax_pnc.SPEC, _jnp(st), d)
        out = store.gossip_step(pncounter.SPEC, _torch(st), d)
        for f in "pn":
            np.testing.assert_array_equal(out[f].numpy(), np.asarray(ref[f]))


def test_apply_replica_ops_delta_matches_jax():
    rng = np.random.default_rng(21)
    st = _state(rng, 3)
    ops = workloads.pnc_uniform(rng, 3, K, 12)
    ref, ref_dirty, ref_drop = jax_store.apply_replica_ops_delta(
        jax_pnc.SPEC, _jnp(st), _jnp(ops))
    out, dirty, drop = store.apply_replica_ops_delta(
        pncounter.SPEC, _torch(st), _torch(ops))
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(ref_dirty))
    assert int(drop) == int(ref_drop) == 0
    for f in "pn":
        np.testing.assert_array_equal(out[f].numpy(), np.asarray(ref[f]))


@pytest.mark.parametrize("r", [4, 5])
def test_make_tick_five_ticks_match_jax(r):
    """5 ticks of the engine (apply + converge) at odd and even R."""
    rng = np.random.default_rng(30 + r)
    batches = [jax_uniform(rng, r, K, 16) for _ in range(5)]
    ref = jax_store.replicated_init(jax_pnc.SPEC, r, num_keys=K, num_writers=r)
    tick_ref = jax.jit(jax_engine.make_tick(jax_pnc.SPEC))
    st = store.replicated_init(pncounter.SPEC, r, device="cpu",
                               num_keys=K, num_writers=r)
    tick = engine.make_tick(pncounter.SPEC, device="cpu")
    local = engine.make_local_tick(pncounter.SPEC, device="cpu")
    for ops in batches:
        ref = tick_ref(ref, ops)
        st = tick(st, workloads.ops_to_device(
            {f: np.asarray(v) for f, v in ops.items()}, "cpu"))
        for f in "pn":
            np.testing.assert_array_equal(st[f].numpy(), np.asarray(ref[f]))
    # the local tick applies without converging
    ops = batches[0]
    ref_local = jax_engine.make_local_tick(jax_pnc.SPEC)(ref, ops)
    st = local(st, workloads.ops_to_device(
        {f: np.asarray(v) for f, v in ops.items()}, "cpu"))
    for f in "pn":
        np.testing.assert_array_equal(st[f].numpy(), np.asarray(ref_local[f]))


def test_tick_refuses_state_on_another_device():
    tick = engine.make_tick(pncounter.SPEC, device="cpu")
    st = store.replicated_init(pncounter.SPEC, 2, device="cpu",
                               num_keys=K, num_writers=2)
    ops = workloads.ops_to_device(
        workloads.pnc_uniform(np.random.default_rng(0), 2, K, 4), "cpu")
    ops["key"] = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tick(st, ops)

"""Parity of the port's DAG and Tusk commit (janus_tpu_torch, on the CPU)
with the JAX package.

Inputs (crash, withhold and invalid masks) are made with numpy from a
seed and fed to both. Every comparison is bit-equal (bool and int32
state; tolerance exactly 0).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from janus_tpu.consensus import dag as jax_dag
from janus_tpu.consensus import tusk as jax_tusk

from janus_tpu_torch import convert
from janus_tpu_torch.consensus import dag, tusk

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

N, W = 4, 8


def _assert_state_equal(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = convert.tree_to_numpy(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: {k}")


def test_leader_of_across_2_31_and_seeds():
    """uint32 mix held in int64: waves across 2^31 (and negative int32
    waves, read as uint32) for seeds 0, 1 and 7. For seed 7 the JAX
    ``leader_of`` refuses the seed constant (above 32 bits), so the
    reference is the JAX package's ``_mix32`` with the constant reduced
    to 32 bits, as its ``leaders`` does."""
    waves = np.array([0, 1, 2, 3, 1000, 2**31 - 2, 2**31 - 1, 2**31,
                      2**31 + 1, 2**31 + 12345, 2**32 - 2, 2**32 - 1],
                     dtype=np.uint32)
    for n in (4, 7):
        cfg = dag.DagConfig(n, W)
        jcfg = jax_dag.DagConfig(n, W)
        for seed in (0, 1, 7):
            if seed * 0x9E3779B9 + 1 <= 0xFFFFFFFF:
                ref = np.asarray(jax_tusk.leader_of(jcfg, jnp.asarray(waves), seed))
            else:
                w32 = jnp.asarray(waves)
                h = jax_tusk._mix32(
                    w32 * jnp.uint32(2654435761)
                    + jnp.uint32((seed * 0x9E3779B9 + 1) & 0xFFFFFFFF))
                ref = np.asarray((h % jnp.uint32(n)).astype(jnp.int32))
            out = tusk.leader_of(cfg, torch.from_numpy(waves.astype(np.int64)), seed)
            assert out.dtype == torch.int32
            np.testing.assert_array_equal(out.numpy(), ref)
            # int32 waves that wrap negative read as uint32
            neg = torch.tensor([-1, -2, -(2**31)], dtype=torch.int32)
            np.testing.assert_array_equal(
                tusk.leader_of(cfg, neg, seed).numpy(),
                tusk.leader_of(cfg, neg.to(torch.int64) & 0xFFFFFFFF, seed).numpy())
            np.testing.assert_array_equal(tusk.leaders(cfg, seed),
                                          jax_tusk.leaders(jcfg, seed))


def _masks(t, rng):
    """Crash, withhold and invalid masks of round t (or None)."""
    active = np.ones((N,), bool)
    if 8 <= t < 16:
        active[2] = False
    withhold = (rng.random((W, N)) < 0.15) if t % 3 == 0 else None
    invalid = (rng.random((W, N)) < 0.1) if t % 5 == 1 else None
    return active, withhold, invalid


@pytest.fixture(scope="module")
def dag_run():
    """40 JAX round_steps under crash/withhold/invalid masks, with a
    commit_view and a GC recycle of rounds every view has finished; the
    DAG state, commit state and order keys after each round."""
    rng = np.random.default_rng(3)
    cfg = jax_dag.DagConfig(N, W)
    step = jax.jit(functools.partial(jax_dag.round_step, cfg))
    commit = jax.jit(functools.partial(jax_tusk.commit_view, cfg, seed=1, steps=2))
    state, cstate = jax_dag.init(cfg), jax_tusk.init_commit(cfg)
    masks, out = [], []
    for t in range(40):
        m = _masks(t, rng)
        masks.append(m)
        state = step(state, *m)
        cstate = commit(state, cstate)
        key = jax_tusk.order_key(cfg, cstate, base=state["base_round"])
        new_base = _finished_base(state, cstate)
        state = jax_dag.recycle(cfg, state, new_base)
        cstate = jax_tusk.recycle_commit(cfg, cstate, new_base)
        out.append((state, cstate, key, new_base))
    return masks, out


def _finished_base(state, cstate):
    """A GC frontier for the test run: two rounds below the lowest node
    round, never backwards (numpy, shared by both sides)."""
    nr = np.asarray(state["node_round"]).min()
    return max(int(np.asarray(state["base_round"])), int(nr) - 2)


def test_round_step_commit_and_recycle_match_jax_every_round(dag_run):
    masks, ref = dag_run
    cfg = dag.DagConfig(N, W)
    state, cstate = dag.init(cfg, "cpu"), tusk.init_commit(cfg, "cpu")
    committed_any = False
    for t, (active, withhold, invalid) in enumerate(masks):
        as_t = (lambda m: None if m is None else torch.from_numpy(m))
        state = dag.round_step(cfg, state, as_t(active), as_t(withhold),
                               as_t(invalid))
        cstate = tusk.commit_view(cfg, state, cstate, seed=1, steps=2)
        key = tusk.order_key(cfg, cstate, base=state["base_round"])
        r_state, r_cstate, r_key, new_base = ref[t]
        np.testing.assert_array_equal(key.numpy(), np.asarray(r_key),
                                      err_msg=f"order_key round {t}")
        state = dag.recycle(cfg, state, new_base)
        cstate = tusk.recycle_commit(cfg, cstate, new_base)
        _assert_state_equal(state, r_state, f"dag round {t}")
        _assert_state_equal(cstate, r_cstate, f"commit round {t}")
        committed_any |= bool(cstate["committed"].any())
        for v in range(N):
            assert (tusk.ordered_blocks(cfg, cstate, v)
                    == jax_tusk.ordered_blocks(jax_dag.DagConfig(N, W), r_cstate, v))
    assert committed_any and int(state["base_round"]) > 0


def test_phases_match_jax_with_partial_delivery_masks():
    """Each phase alone, with random [recipient, slot, source] delivery
    masks, from a mid-run state."""
    rng = np.random.default_rng(9)
    jcfg, cfg = jax_dag.DagConfig(N, W), dag.DagConfig(N, W)
    js = jax_dag.init(jcfg)
    for _ in range(5):
        js = jax_dag.round_step(jcfg, js)
    ts = convert.tree_from_numpy(convert.tree_to_numpy(js), "cpu")
    for _ in range(3):
        m = rng.random((N, W, N)) < 0.6
        act = rng.random(N) < 0.8
        phases = [
            (jax_dag.create_blocks, dag.create_blocks, act),
            (jax_dag.deliver_blocks, dag.deliver_blocks, m),
            (jax_dag.sign_blocks, dag.sign_blocks, m),
            (jax_dag.form_certificates, dag.form_certificates, m[0]),
            (jax_dag.deliver_certificates, dag.deliver_certificates, m),
            (jax_dag.advance_rounds, dag.advance_rounds, None),
        ]
        for jf, tf, arg in phases:
            args = () if arg is None else (arg,)
            js = jf(jcfg, js, *(jnp.asarray(a) for a in args))
            ts = tf(cfg, ts, *(torch.from_numpy(a) for a in args))
            _assert_state_equal(ts, js, jf.__name__)
        np.testing.assert_array_equal(
            dag.structural_validity(cfg, ts).numpy(),
            np.asarray(jax_dag.structural_validity(jcfg, js)))


def test_order_key_wraps_in_int32_like_jax():
    cfg, jcfg = dag.DagConfig(N, W), jax_dag.DagConfig(N, W)
    rng = np.random.default_rng(4)
    cs = {
        "committed": rng.random((N, W, N)) < 0.7,
        "commit_seq": rng.integers(2**31 // (W * N) - 3, 2**31 // (W * N) + 3,
                                   (N, W, N)).astype(np.int32),
        "slot_round": (np.arange(W) + 37).astype(np.int32),
    }
    for base in (None, 37):
        ref = jax_tusk.order_key(jcfg, {k: jnp.asarray(v) for k, v in cs.items()},
                                 base=None if base is None else jnp.int32(base))
        out = tusk.order_key(cfg, convert.tree_from_numpy(cs, "cpu"),
                             base=None if base is None
                             else torch.tensor(base, dtype=torch.int32))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert (np.asarray(ref) < 0).any()  # the key really wrapped

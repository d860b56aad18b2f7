"""Parity of the consensus functions that the port runs as hand kernels
(``tusk.commit_view``, ``dag.round_step``, ``SafeKV._causal_closure``),
through the port's public functions on the CPU (their plain versions),
with the JAX package on arbitrary states.

The states are random bool tensors and round counters drawn with numpy
from a seed (``workloads.consensus_state``): anchors at rounds 0-2 and
below, GC frontiers above 0, int32 wraparound. Any bool tensors are
valid inputs, since both sides compute the same function of them. One
constructed DAG makes the back-chain commit two anchors in one call.
Every comparison is bit-equal (bool and int32; tolerance exactly 0).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from janus_tpu.consensus import dag as jax_dag
from janus_tpu.consensus import tusk as jax_tusk
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import dag, tusk
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.runtime import safecrdt

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

SHAPES = [(4, 8), (7, 6)]
# the round's parity also at the main path's 16 nodes and at 64 (rows of
# a whole 64-bit mask) with a wider window
ROUND_SHAPES = SHAPES + [(16, 8), (64, 16)]
STATES = 8  # random states per shape; every fourth one wraps int32


@functools.lru_cache(maxsize=None)
def _states(n, w):
    rng = np.random.default_rng(100 + n)
    return [(*workloads.consensus_state(rng, n, w, wrap=i % 4 == 3),
             workloads.round_masks(rng, n, w)) for i in range(STATES)]


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return convert.tree_from_numpy(tree, "cpu")


def _assert_equal(out, ref, where):
    assert out.keys() == ref.keys(), where
    for k in out:
        x, y = out[k].numpy(), np.asarray(ref[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("n,w", SHAPES)
@pytest.mark.parametrize("steps", [2, None])
def test_commit_view_matches_jax_on_random_states(n, w, steps):
    """steps 2 (SafeKV's) and None (a full window of waves); the input
    commit state is left as it was."""
    jcfg, cfg = jax_dag.DagConfig(n, w), dag.DagConfig(n, w)
    commit = jax.jit(functools.partial(jax_tusk.commit_view, jcfg, seed=1,
                                       steps=steps))
    committed = 0
    for i, (d, c, _, _) in enumerate(_states(n, w)):
        ref = commit(_jax(d), _jax(c))
        before = _torch(c)
        cstate = {f: v.clone() for f, v in before.items()}
        out = tusk.commit_view(cfg, _torch(d), cstate, seed=1, steps=steps)
        _assert_equal(out, ref, f"state {i}")
        _assert_equal(cstate, before, f"input of state {i}")
        committed += int((out["commit_counter"] != before["commit_counter"]).any())
    assert committed > 0


@pytest.mark.parametrize("n,w", ROUND_SHAPES)
@pytest.mark.parametrize("masks", ["none", "active", "withhold", "invalid",
                                   "all"])
def test_round_step_matches_jax_on_random_states(n, w, masks):
    jcfg, cfg = jax_dag.DagConfig(n, w), dag.DagConfig(n, w)
    keep = {"none": (), "active": (0,), "withhold": (1,), "invalid": (2,),
            "all": (0, 1, 2)}[masks]
    step = jax.jit(functools.partial(jax_dag.round_step, jcfg))
    for i, (d, _, _, m) in enumerate(_states(n, w)):
        sel = [x if j in keep else None for j, x in enumerate(m)]
        ref = step(_jax(d), *(None if x is None else jnp.asarray(x) for x in sel))
        out = dag.round_step(cfg, _torch(d), *(None if x is None
                                               else torch.from_numpy(x)
                                               for x in sel))
        _assert_equal(out, ref, f"state {i}")


@pytest.mark.parametrize("n,w", SHAPES)
def test_causal_closure_matches_jax_on_random_states(n, w):
    jkv = JaxSafeKV(jax_dag.DagConfig(n, w), jax_pnc.SPEC, ops_per_block=4,
                    num_keys=4, num_writers=n)
    kv = safecrdt.SafeKV(dag.DagConfig(n, w), pncounter.SPEC, ops_per_block=4,
                         device="cpu", num_keys=4, num_writers=n)
    closure = jax.jit(jkv._causal_closure)
    for i, (d, _, applied, _) in enumerate(_states(n, w)):
        ref = closure(_jax(d), jnp.asarray(applied))
        out = kv._causal_closure(_torch(d), torch.from_numpy(applied))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref),
                                      err_msg=f"state {i}")


def test_backchain_commits_two_anchors_in_one_call_like_jax():
    """Wave 0's leader holds a certificate without 2f+1 support; wave 1's
    anchor reaches it, so discovery chains it: one call commits both, wave
    0's leader first (sequence 0), then wave 1's anchor (sequence 1)."""
    n, w = 4, 8
    d, c = workloads.backchain_state(n, w, seed=0)
    ref = jax_tusk.commit_view(jax_dag.DagConfig(n, w), _jax(d), _jax(c),
                               seed=0, steps=2)
    cfg = dag.DagConfig(n, w)
    out = tusk.commit_view(cfg, _torch(d), _torch(c), seed=0, steps=2)
    _assert_equal(out, ref, "back-chain")
    l0, l1 = tusk.leaders(cfg, seed=0)[:2]
    for st in ({f: v.numpy() for f, v in out.items()},
               {f: np.asarray(v) for f, v in ref.items()}):
        assert (st["commit_counter"] == 2).all()
        assert (st["last_wave"] == 1).all() and (st["eval_wave"] == 1).all()
        seq = st["commit_seq"]
        assert sorted(np.unique(seq[st["committed"]])) == [0, 1]
        assert (seq[:, 0, l0] == 0).all() and (seq[:, 2, l1] == 1).all()


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    cfg = dag.DagConfig(4, 8)
    d, c, applied, masks = _states(4, 8)[0]
    d, c, applied = _torch(d), _torch(c), torch.from_numpy(applied)
    masks = [torch.from_numpy(m) for m in masks]
    kernels.reset_launches()
    for got, ref in (
            (kernels.tusk_commit(cfg, d, c, 0, 2),
             kernels.tusk_commit_plain(cfg, d, c, 0, 2)),
            ((kernels.causal_closure(cfg, d, applied),),
             (kernels.causal_closure_plain(cfg, d, applied),)),
            (tuple(kernels.dag_round(cfg, d, *masks).values()),
             tuple(kernels.dag_round_plain(cfg, d, *masks).values()))):
        for a, b in zip(got, ref, strict=True):
            assert torch.equal(a, b)
    assert kernels.launches() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("kernel", ["tusk_commit", "causal_closure",
                                    "dag_round"])
def test_consensus_wrappers_refuse_a_wrong_shape(kernel):
    """Shapes are checked against the configuration before either
    version runs, on the CPU as on the card."""
    cfg = dag.DagConfig(4, 8)
    d, c, applied, _ = _states(4, 8)[0]
    d = dict(_torch(d), cert_seen=torch.zeros((4, 7, 4), dtype=torch.bool))
    call = {"tusk_commit": lambda: kernels.tusk_commit(cfg, d, _torch(c), 0, 2),
            "causal_closure": lambda: kernels.causal_closure(
                cfg, d, torch.from_numpy(applied)),
            "dag_round": lambda: kernels.dag_round(cfg, d)}[kernel]
    with pytest.raises(ValueError, match="cert_seen"):
        call()

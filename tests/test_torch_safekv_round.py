"""Parity of the SafeKV round's four hand kernels' plain versions (the
port on the CPU: ``safekv_submit``, ``block_select``, ``state_transfer``,
``gc_frontier``) with the JAX package's SafeKV methods.

Seeded numpy inputs go through the JAX method and the port's plain
version; every comparison is bit-equal (int32/bool, tolerance exactly 0).
The states come from a JAX run of the PN-Counter or the OR-Set at N=4,
W=8, edited to reach the cases named in each test: a rejected submit
(window full, block made, slot buffered, crashed node), a selection that
spills past the apply budget, a transfer needed by lag, by the frontier
and by force (the donor among them). The GC frontier and the pack are
held by whole rounds: JAX and the port run the same crash scenario from
the same start, at N=4 and N=64, with the logs on and off, and every
packed output and device tensor must agree; each scenario's JAX run
advances the frontier by more than one slot and loses a straggler.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.consensus import tusk as jax_tusk
from janus_tpu.models import orset as jax_orset
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import base, orset, pncounter
from janus_tpu_torch.runtime import safecrdt
from janus_tpu_torch.utils.ids import TagMinter

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

N, W, B, K = 4, 8, 8, 6
CAP, RM = 8, 2
TYPES = {"pnc": (jax_pnc.SPEC, pncounter.SPEC, dict(num_writers=N)),
         "orset": (jax_orset.SPEC, orset.SPEC,
                   dict(capacity=CAP, rm_capacity=RM))}


def _ops(tc, rng, minters, n=N):
    if tc == "pnc":
        return workloads.pnc_uniform(rng, n, K, B)
    return workloads.orset_add_remove(rng, minters, K, B)


def _assert_equal(got, want, where):
    """Bit-equal: a port tensor (or dict of them) against JAX arrays."""
    if isinstance(got, dict):
        assert got.keys() == want.keys(), where
        for k in got:
            _assert_equal(got[k], want[k], f"{where}.{k}")
        return
    x = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    y = np.asarray(want)
    assert x.shape == y.shape, (where, x.shape, y.shape)
    if x.size:
        np.testing.assert_array_equal(x, y, err_msg=where)


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


@pytest.fixture(scope="module", params=sorted(TYPES))
def mid_run(request):
    """A JAX SafeKV of the type after 6 rounds (node 3 crashed for rounds
    2-4), its device state as numpy, and the next round's ops."""
    tc = request.param
    jspec, _, dims = TYPES[tc]
    rng = np.random.default_rng(31)
    minters = [TagMinter(i) for i in range(N)]
    jkv = JaxSafeKV(JaxDagConfig(N, W), jspec, ops_per_block=B,
                    apply_budget=3, num_keys=K, **dims)
    for t in range(6):
        active = np.array([True] * 3 + [not 2 <= t < 5])
        jkv.step(_ops(tc, rng, minters), active=active)
    return tc, jkv, _device_state(jkv), _ops(tc, rng, minters)


@functools.lru_cache(maxsize=None)
def _jax_method(tc, name, budget=None):
    """A JAX SafeKV method of the type, jitted once per shape."""
    jspec, _, dims = TYPES[tc]
    jkv = JaxSafeKV(JaxDagConfig(N, W), jspec, ops_per_block=B,
                    apply_budget=budget, num_keys=K, **dims)
    return jax.jit(getattr(jkv, name))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port_kv(tc, **kw):
    _, spec, dims = TYPES[tc]
    return safecrdt.SafeKV(DagConfig(N, W), spec, ops_per_block=B,
                           device="cpu", num_keys=K, **kw, **dims)


def _t(tree):
    return convert.tree_from_numpy(convert.tree_to_numpy(tree), "cpu")


@pytest.mark.parametrize("case", ["window_full", "block_made", "buffered",
                                  "crashed"])
def test_submit_matches_jax(mid_run, case):
    tc, _, st, ops = mid_run
    dag = {f: np.array(v) for f, v in st["dag"].items()}
    filled = np.array(st["buffer_filled"])
    active = np.ones(N, bool)
    r = dag["node_round"]
    if case == "window_full":
        r[1] = dag["base_round"] + W
    elif case == "block_made":
        dag["block_exists"][r[1] % W, 1] = True
    elif case == "buffered":
        filled[r[1] % W, 1] = True
    else:
        active[1] = False
    args = (st["prospective"], dag, st["ops_buffer"], filled,
            st["prosp_applied"], ops, active)
    want = _jax_method(tc, "_submit_device")(*_j(args))
    assert not bool(np.asarray(want[4])[1])  # view 1's batch is rejected
    assert bool(np.asarray(want[4]).any())
    # the port's plain versions around the type's capture
    cfg = DagConfig(N, W)
    prosp, dag_t, ring, filled_t, applied, ops_t, active_t = (
        _t(x) for x in args)
    acc_ops, accepted, pre = kernels.safekv_submit_plain(
        cfg, dag_t, filled_t, ops_t, active_t)
    prosp, acc_ops = base.capture_and_apply(TYPES[tc][1], prosp, acc_ops)
    kernels.safekv_board_plain(cfg, ring, filled_t, applied, acc_ops,
                               accepted, pre)
    for i, got in enumerate((prosp, ring, filled_t, applied, accepted)):
        _assert_equal(got, want[i], f"{tc} {case} output {i}")
    _assert_equal(pre, dag["node_round"], "pre_round")
    assert kernels.safekv_submit.launches == 0  # the CPU ran the plain path


@pytest.mark.parametrize("order", ["prospective", "commit"])
@pytest.mark.parametrize("budget", [2, 40])
def test_delta_apply_matches_jax(mid_run, order, budget):
    """A selection over every block of the window but a few applied ones:
    budget 2 spills past the apply budget, 40 takes all W*N blocks."""
    tc, _, st, _ = mid_run
    spec = TYPES[tc][1]
    rng = np.random.default_rng(budget)
    ready = rng.random((N, W, N)) < 0.9
    applied = rng.random((N, W, N)) < 0.2
    dag, com = st["dag"], st["commit"]
    if order == "prospective":
        rel = (dag["slot_round"] - dag["base_round"]).astype(np.int32)
        key = np.broadcast_to(rel[None, :, None] * N
                              + np.arange(N, dtype=np.int32)[None, None, :],
                              (N, W, N))
        seq = None
    else:
        com = dict(com, committed=ready)
        key = np.asarray(jax_tusk.order_key(JaxDagConfig(N, W), com,
                                            base=dag["base_round"]))
        seq = com["commit_seq"]
    sel = ready & ~applied
    assert sel.sum(axis=(1, 2)).max() > min(budget, W * N) or budget == 40
    want_state, want_mask, want_drop = _jax_method(
        tc, "_delta_apply", budget)(*_j((st["stable"], st["ops_buffer"], sel,
                                        key)))
    applied_t = torch.tensor(applied)
    batch, idx, chosen = kernels.block_select_plain(
        DagConfig(N, W), _t(st["ops_buffer"]), torch.tensor(ready),
        applied_t, budget, torch.tensor(com["slot_round"]),
        torch.tensor(dag["base_round"]),
        None if seq is None else torch.tensor(seq))
    state, dropped = spec.apply_ops_dropped(_t(st["stable"]), batch)
    _assert_equal(state, want_state, f"{tc} {order} state")
    _assert_equal(applied_t & ~torch.tensor(applied), want_mask,
                  f"{tc} {order} selection")
    assert int(dropped.sum()) == int(want_drop)
    assert idx.dtype == torch.int32 and chosen.shape == idx.shape


@pytest.mark.parametrize("case", ["lag", "frontier", "force", "donor"])
def test_state_transfer_matches_jax(mid_run, case):
    tc, _, st, _ = mid_run
    dag = {f: np.array(v) for f, v in st["dag"].items()}
    com = {f: np.array(v) for f, v in st["commit"].items()}
    force = np.zeros(N, bool)
    com["last_wave"][:] = [9, 9, 8, 9]
    if case == "lag":
        com["last_wave"][2] = 6          # 3 behind the quorum's 9
    elif case == "frontier":
        dag["node_round"][2] = dag["base_round"] - 1
    elif case == "force":
        force[2] = True
    else:
        force[0] = True                  # the donor (first argmax) itself
    args = (st["prospective"], st["stable"], dag, com, st["prosp_applied"],
            st["stable_applied"], force)
    want = _jax_method(tc, "_state_transfer")(*_j(args))
    need = np.asarray(want[6])
    assert need[2 if case != "donor" else 0] and int(np.asarray(want[7])) == 0
    got = _port_kv(tc)._state_transfer(*(_t(x) for x in args))
    for i, (x, y) in enumerate(zip(got, want)):
        _assert_equal(x, y, f"{tc} {case} output {i}")


SCENARIOS = {  # nodes, crash rounds of node N-1, collect_logs, window
    "n4_logs": (4, (5, 12), True, W),
    "n4_nologs": (4, (3, 7), False, W),
    "n64_logs": (64, (3, 9), True, W),
    "n64_nologs": (64, (2, 5), False, W),
    "n16_logs": (16, (4, 10), True, W),
    "n16_w32_nologs": (16, (3, 8), False, 32),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gc_rounds_match_jax(name):
    """The GC frontier, the recycle and the pack, round by round: JAX's
    ``_step_device`` against the port's on the CPU (``gc_frontier``'s and
    ``gc_clear_ring``'s plain versions), from the same start; at 4, 16
    and 64 nodes, and at the card's W 32 limit."""
    n, crash, logs, w = SCENARIOS[name]
    b, k, rounds = 4, 4, 16
    jkv = JaxSafeKV(JaxDagConfig(n, w), jax_pnc.SPEC, ops_per_block=b,
                    collect_logs=logs, num_keys=k, num_writers=n)
    kv = safecrdt.SafeKV(DagConfig(n, w), pncounter.SPEC, ops_per_block=b,
                         collect_logs=logs, device="cpu", num_keys=k,
                         num_writers=n)
    rng = np.random.default_rng(5)
    jumps = lost = 0
    for t in range(rounds):
        active = np.ones(n, bool)
        active[n - 1] = not crash[0] <= t < crash[1]
        ops = workloads.pnc_uniform(rng, n, k, b)
        safe = rng.random((n, b)) < 0.5
        jp, jm = jkv.step_dispatch(ops, safe, active=active)
        tp, tm = kv.step_dispatch(ops, safe, active=active)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp),
                                      err_msg=f"{name} packed round {t}")
        info = jkv.step_absorb(jp, jm)
        kv.step_absorb(tp, tm)
        _assert_equal(_device_state(kv), _device_state(jkv),
                      f"{name} round {t}")
        jumps += int(info["recycled"].sum()) >= 2
        lost += int(np.asarray(jkv.force_transfer).sum())
    assert jumps > 0 and lost > 0, (jumps, lost)
    assert kv.stats == jkv.stats and kv.latency_log == jkv.latency_log
    if logs:
        assert kv.commit_log == jkv.commit_log

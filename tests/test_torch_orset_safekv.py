"""Parity of the port's SafeKV for the OR-Set (janus_tpu_torch, on the CPU)
with the JAX package's: the consensus path with effect capture at submit,
captured replay in both delta applies, and compaction at every GC advance.

One seeded numpy workload drives both: N=4 nodes, window W=8, B=16 ops per
block, K=6 keys, capacity 8, capture width 3, apply budget 8 (the harness's
``n + max(4, n // 4)``), 32 rounds of a 50/50 add/remove mix with tags
minted per node, node 3 crashed for rounds 8-15. Every comparison is
bit-equal (tolerance exactly 0): all device state (the op buffer's capture
extras and the zero-width ``_rm_cap`` leaf included) and the packed round
output after every round, then the total-order logs, the stats (GC
advances, compactions, state transfers, slots dropped) and the queries. A
second port instance takes over the JAX run's arrays at round 18 through
``load_state`` and must continue identically.
"""
import copy

import numpy as np
import pytest

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import orset as jax_orset
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import orset
from janus_tpu_torch.runtime import safecrdt
from janus_tpu_torch.utils.ids import TagMinter

N, W, B, K, CAP, RM = 4, 8, 16, 6, 8, 3
BUDGET = N + max(4, N // 4)
ROUNDS = 32
CRASHED = range(8, 16)  # rounds during which node 3 is down
HANDOVER = 18


def _workload():
    rng = np.random.default_rng(21)
    minters = [TagMinter(v) for v in range(N)]
    rounds = []
    for t in range(ROUNDS):
        ops = workloads.orset_add_remove(rng, minters, K, B, num_elems=6)
        active = np.ones((N,), bool)
        if t in CRASHED:
            active[3] = False
        rounds.append((ops, active))
    return rounds


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


def _assert_tree_equal(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{where}.{k}")


def _jax_kv():
    return JaxSafeKV(JaxDagConfig(N, W), jax_orset.SPEC, ops_per_block=B,
                     apply_budget=BUDGET, num_keys=K, capacity=CAP,
                     rm_capacity=RM)


def _port_kv():
    return safecrdt.SafeKV(DagConfig(N, W), orset.SPEC, ops_per_block=B,
                           apply_budget=BUDGET, device="cpu", num_keys=K,
                           capacity=CAP, rm_capacity=RM)


@pytest.fixture(scope="module")
def jax_run():
    rounds = _workload()
    kv = _jax_kv()
    out = {"packed": [], "state": []}
    for t, (ops, active) in enumerate(rounds):
        if t == HANDOVER:
            out["handover"] = {
                **_device_state(kv),
                **{f: copy.deepcopy(getattr(kv, f))
                   for f in safecrdt.HOST_FIELDS}}
        packed, meta = kv.step_dispatch(ops, active=active)
        kv.step_absorb(packed, meta)
        out["packed"].append(np.asarray(packed))
        out["state"].append(_device_state(kv))
    out["final"] = {
        "ordered": [kv.ordered_commits(v) for v in range(N)],
        "stats": dict(kv.stats),
        "live": np.asarray(kv.query_stable("live_count")),
        "elements": np.asarray(kv.query_prospective("element_count")),
    }
    return rounds, out


def _drive_and_compare(kv, rounds, ref, start):
    for t in range(start, ROUNDS):
        ops, active = rounds[t]
        packed, meta = kv.step_dispatch(ops, active=active)
        np.testing.assert_array_equal(packed.numpy(), ref["packed"][t],
                                      err_msg=f"packed round {t}")
        kv.step_absorb(packed, meta)
        _assert_tree_equal(_device_state(kv), ref["state"][t], f"round {t}")
    fin = ref["final"]
    assert [kv.ordered_commits(v) for v in range(N)] == fin["ordered"]
    assert kv.stats == fin["stats"]
    np.testing.assert_array_equal(kv.query_stable("live_count").numpy(),
                                  fin["live"])
    np.testing.assert_array_equal(kv.query_prospective("element_count").numpy(),
                                  fin["elements"])


def test_orset_safekv_matches_jax_every_round_with_crash(jax_run):
    rounds, ref = jax_run
    stats = ref["final"]["stats"]
    # the run exercises what it claims: GC advanced, compaction ran, the
    # crashed node was state-transferred back, captured removes landed
    assert stats["gc_advances"] > 0 and stats["compactions"] > 0
    assert stats["state_transfers"] > 0
    buf = ref["state"][-1]["ops_buffer"]
    assert buf["rm_rep"].shape == (W, N, B, RM)
    assert any((s["ops_buffer"]["rm_rep"] != orset.SENTINEL).any()
               for s in ref["state"])
    assert ref["state"][-1]["stable"]["removed"].any()
    _drive_and_compare(_port_kv(), rounds, ref, 0)


def test_orset_safekv_state_carried_across_mid_run(jax_run):
    rounds, ref = jax_run
    handover = ref["handover"]
    assert int(handover["dag"]["base_round"]) > 0  # GC frontier above 0
    kv = _port_kv()
    kv.load_state(handover)
    _assert_tree_equal(_device_state(kv), ref["state"][HANDOVER - 1],
                       "after load_state")
    _drive_and_compare(kv, rounds, ref, HANDOVER)


def test_orset_safekv_one_op_blocks_match_jax():
    """One-op blocks (B=1): every origin apply and every delta apply of a
    single block is a one-lane captured batch (JAX's scan; the port's
    ``orset_apply`` captured mode). 16 rounds at N=4, W=8, 3 keys of 8
    slots, capture width 3, an apply budget of one block: every device
    leaf bit-equal after every round, through GC advances and
    compactions."""
    n, w, k = 4, 8, 3
    rng = np.random.default_rng(11)
    minters = [TagMinter(v) for v in range(n)]
    mine = safecrdt.SafeKV(DagConfig(n, w), orset.SPEC, ops_per_block=1,
                           apply_budget=1, device="cpu", num_keys=k,
                           capacity=8, rm_capacity=3)
    ref = JaxSafeKV(JaxDagConfig(n, w), jax_orset.SPEC, ops_per_block=1,
                    apply_budget=1, num_keys=k, capacity=8, rm_capacity=3)
    for t in range(16):
        ops = workloads.orset_add_remove(rng, minters, k, 1)
        mine.step(ops)
        ref.step(ops)
        _assert_tree_equal(_device_state(mine), _device_state(ref),
                           f"round {t}")
    assert mine.stats == ref.stats
    assert mine.stats["compactions"] > 0

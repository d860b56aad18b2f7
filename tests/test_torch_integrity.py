"""The port's integrity plane (janus_tpu_torch.consensus.integrity) over
the port's SafeKV (on the CPU), against the JAX package's.

Block digests are SHA-256 over the same bytes, so they are compared byte
for byte. Signatures are not: ECDSA keys and nonces are random (the
keyed-hash fallback's keys come from the seed), so the runs compare what
signing decides. Both clusters run the same seeded rounds (N=4, W=16,
B=4, node 3 Byzantine at invalid rate 0.5) in lockstep, in the no-fetch
mode and in the fetch mode (there also with node 2 crashed for a while);
the invalid mask handed to every round, the round's outputs, every device
array after it (tolerance 0), the pruned blocks, the equivocation counts,
the verification counts and the digest table must agree. The other cases
are those of tests/test_integrity.py, on the port.
"""
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.consensus import integrity as jax_integrity
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.consensus.integrity import (
    IntegrityPlane,
    SecureCluster,
    generate_committee,
)
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.runtime import safecrdt
from janus_tpu_torch.runtime.safecrdt import SafeKV

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

N, W, B, K = 4, 16, 4, 8
BYZ = np.asarray([False, False, False, True])


def pnc_ops(rng):
    shape = (N, B)
    return {"op": rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1,
                               shape).astype(np.int32),
            "key": rng.integers(0, K, shape).astype(np.int32),
            "a0": rng.integers(1, 5, shape).astype(np.int32),
            "a1": np.zeros(shape, np.int32), "a2": np.zeros(shape, np.int32),
            "writer": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None],
                                      shape).copy()}


def make_secure(no_fetch=True, **plane_kw):
    cfg = DagConfig(N, W)
    kv = SafeKV(cfg, pncounter.SPEC, ops_per_block=B, device="cpu",
                num_keys=K, num_writers=N)
    return SecureCluster(kv, IntegrityPlane(cfg, **plane_kw),
                         no_fetch=no_fetch)


def make_jax_secure(no_fetch=True, **plane_kw):
    cfg = JaxDagConfig(N, W)
    kv = JaxSafeKV(cfg, jax_pnc.SPEC, ops_per_block=B, num_keys=K,
                   num_writers=N)
    return jax_integrity.SecureCluster(
        kv, jax_integrity.IntegrityPlane(cfg, **plane_kw), no_fetch=no_fetch)


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


@pytest.mark.parametrize("round_,source,prev,payload,seeded", [
    (5, 1, [True, True, True, False], b"payload", False),
    (0, 0, [False] * 4, b"", False),
    (6, 3, [True, False, True, True], b"\x00\xffops", True),
    (2**40, 2, [True] * 4, b"x" * 300, True),
])
def test_block_digest_matches_jax(round_, source, prev, payload, seeded):
    mine = IntegrityPlane(DagConfig(N, W))
    ref = jax_integrity.IntegrityPlane(JaxDagConfig(N, W))
    if seeded:  # previous-round digests the new one covers
        for t in range(N):
            d = bytes([t]) * 32
            mine._digest[(round_ - 1, t)] = d
            ref._digest[(round_ - 1, t)] = d
    prev = np.asarray(prev)
    got = mine.block_digest(round_, source, prev, payload)
    assert got == ref.block_digest(round_, source, prev, payload)
    assert len(got) == 32
    # the digest covers each input
    assert got != mine.block_digest(round_ + 1, source, prev, payload)
    assert got != mine.block_digest(round_, (source + 1) % N, prev, payload)
    assert got != mine.block_digest(round_, source, prev, payload + b"!")
    assert got != mine.block_digest(round_, source, ~prev, payload)


@pytest.mark.parametrize("mode", ["no_fetch", "fetch", "fetch_crash"])
def test_secure_cluster_matches_jax(mode):
    no_fetch = mode == "no_fetch"
    kw = dict(byzantine=BYZ, invalid_rate=0.5, seed=3)
    mine, ref = make_secure(no_fetch, **kw), make_jax_secure(no_fetch, **kw)
    rng = np.random.default_rng(11)
    masks = []
    for t in range(2 * W):
        ops = pnc_ops(rng)
        safe = rng.random((N, B)) < 0.5
        active = None
        if mode == "fetch_crash":
            active = np.array([True, True, not 10 <= t < 16, True])
        info = mine.step(ops, safe=safe, active=active)
        want = ref.step(ops, safe=safe, active=active)
        masks.append(mine.plane.invalid_mask())
        np.testing.assert_array_equal(masks[-1], ref.plane.invalid_mask(),
                                      err_msg=f"invalid mask {t}")
        for f in ("accepted", "own", "recycled", "slot"):
            np.testing.assert_array_equal(info[f], want[f],
                                          err_msg=f"{f} round {t}")
        _assert_tree_equal(_device_state(mine.kv), _device_state(ref.kv),
                           f"round {t}")
        np.testing.assert_array_equal(mine.kv.drain_safe_acks(),
                                      ref.kv.drain_safe_acks())
    assert mine.plane.pruned_blocks() == ref.plane.pruned_blocks()
    assert mine.plane.pruned_blocks(), "no invalid block was injected"
    assert (mine.plane.equivocation_counts()
            == ref.plane.equivocation_counts())
    assert set(mine.plane.equivocation_counts()) == {3}
    assert mine.plane.verified_ok == ref.plane.verified_ok
    assert mine.plane.verified_bad == ref.plane.verified_bad
    assert mine.plane._digest == ref.plane._digest
    assert mine.kv.commit_log == ref.kv.commit_log
    assert mine.kv.stats == ref.kv.stats
    if no_fetch:
        np.testing.assert_array_equal(mine._m_round, ref._m_round)
        assert mine._m_base == ref._m_base
    if mode == "fetch_crash":  # the crashed node boarded nothing
        assert mine.kv.stats["blocks_submitted"] < 2 * W * N - 6


def test_no_fetch_needs_full_delivery():
    sc = make_secure()
    with pytest.raises(ValueError, match="full delivery"):
        sc.step(pnc_ops(np.random.default_rng(0)),
                active=np.ones(N, bool))


def test_honest_run_all_blocks_verify():
    sc = make_secure()
    rng = np.random.default_rng(0)
    for _ in range(2 * W):
        sc.step(pnc_ops(rng), safe=np.ones((N, B), bool))
    assert sc.plane.verified_bad == 0
    assert sc.plane.verified_ok >= 2 * W * N - N
    assert sc.plane.pruned_blocks() == []
    idle = {f: np.zeros((N, B), np.int32) for f in pnc_ops(rng)}
    for _ in range(8):
        sc.step(idle, record=False)
    stable = sc.kv.query_stable("get").numpy()
    prosp = sc.kv.query_prospective("get").numpy()
    assert (stable == stable[0]).all()
    np.testing.assert_array_equal(stable, prosp)


def test_byzantine_invalid_signatures_pruned_liveness_kept():
    sc = make_secure(byzantine=BYZ, invalid_rate=0.5, seed=7)
    rng = np.random.default_rng(1)
    ticks = 2 * W + 8
    for _ in range(ticks):
        sc.step(pnc_ops(rng))
    assert int(sc.kv.dag["node_round"].min()) > ticks // 2
    assert sc.kv.base_round() > W
    pruned = sc.plane.pruned_blocks()
    assert pruned and all(src == 3 for _, src in pruned)
    assert 0.25 < len(pruned) / ticks < 0.75
    idle = {f: np.zeros((N, B), np.int32) for f in pnc_ops(rng)}
    for _ in range(W // 2):
        sc.step(idle, record=False)
    stable = sc.kv.query_stable("get").numpy()
    prosp = sc.kv.query_prospective("get").numpy()
    for v in (1, 2):
        np.testing.assert_array_equal(stable[0], stable[v])
        np.testing.assert_array_equal(prosp[0], prosp[v])
    np.testing.assert_array_equal(stable[0], prosp[0])


def test_committee_key_table():
    com = generate_committee(4, seed=3)
    assert len(com) == 4
    assert set(com.keys) == {0, 1, 2, 3}
    assert len({r.pub for r in com.replicas}) == 4


def test_no_fetch_mirror_matches_fetch_mode():
    """The host mirror drives the plane to exactly what the fetch mode
    does: the same pruning, the same DAG, the same commits."""
    rng_a = np.random.default_rng(11)
    rng_b = np.random.default_rng(11)
    kw = dict(byzantine=BYZ, invalid_rate=0.5, seed=3)
    fast, slow = make_secure(True, **kw), make_secure(False, **kw)
    for _ in range(2 * W):
        fast.step(pnc_ops(rng_a))
        slow.step(pnc_ops(rng_b))
    assert fast.plane.pruned_blocks() == slow.plane.pruned_blocks()
    assert fast.plane.verified_bad == slow.plane.verified_bad > 0
    for f in fast.kv.dag:
        np.testing.assert_array_equal(fast.kv.dag[f].numpy(),
                                      slow.kv.dag[f].numpy(), err_msg=f)
    np.testing.assert_array_equal(fast.kv.query_stable("get").numpy(),
                                  slow.kv.query_stable("get").numpy())
    assert fast.kv.ordered_commits(0) == slow.kv.ordered_commits(0)

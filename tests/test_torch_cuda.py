"""The hand kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports
nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is bit-equal (int32; tolerance exactly 0).
"""
import numpy as np
import pytest
import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.models.base import OP_FIELDS
from janus_tpu_torch.runtime import engine, store

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda_device():
    """The card; decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


def _rand(rng, shape, lo=-(2**31), hi=2**31 - 1):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,w,b", [(5, 7, 5, 333), (4, 64, 16, 1024)])
def test_pnc_apply_kernel_matches_plain(cuda_device, r, k, w, b):
    """Duplicates, no-ops, keys/writers in [-size, 2*size), amounts near
    INT32_MAX (wraparound)."""
    rng = np.random.default_rng(7)
    state = {f: torch.from_numpy(_rand(rng, (r, k, w), lo=INT32_MAX - 1000))
             .to(cuda_device) for f in "pn"}
    ops = {
        "op": rng.integers(0, 4, (r, b)),
        "key": rng.integers(-k, 2 * k, (r, b)),
        "a0": rng.integers(INT32_MAX - 50, INT32_MAX, (r, b)),
        "a1": np.zeros((r, b)), "a2": np.zeros((r, b)),
        "writer": rng.integers(-w, 2 * w, (r, b)),
    }
    dops = workloads.ops_to_device(ops, cuda_device)
    ref = {f: v.clone() for f, v in state.items()}
    before = kernels.pnc_apply.launches
    kernels.pnc_apply(state["p"], state["n"], dops)
    kernels.pnc_apply_plain(ref["p"], ref["n"], dops)
    torch.cuda.synchronize()
    assert kernels.pnc_apply.launches == before + 1
    for f in "pn":
        assert torch.equal(state[f], ref[f])


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,w", [(5, 7, 9), (4, 16, 8), (1, 3, 3)])
def test_replica_join_kernel_matches_plain(cuda_device, r, k, w):
    """Odd R, a row length that is not a multiple of four (the scalar
    path) and one that is (the 16-byte vector path)."""
    rng = np.random.default_rng(r)
    st = {f: torch.from_numpy(_rand(rng, (r, k, w))).to(cuda_device) for f in "pn"}
    ref = {f: v.clone() for f, v in st.items()}
    before = kernels.replica_join.launches
    kernels.replica_join(st["p"], st["n"])
    kernels.replica_join_plain(ref["p"], ref["n"])
    torch.cuda.synchronize()
    assert kernels.replica_join.launches == before + 1
    for f in "pn":
        assert torch.equal(st[f], ref[f])


@pytest.mark.cuda
def test_tick_on_card_matches_tick_on_cpu(cuda_device):
    """The engine tick through both kernels equals the CPU tick (plain
    versions) over a few ticks."""
    rng = np.random.default_rng(3)
    r, k, b = 6, 40, 64
    batches = [workloads.pnc_uniform(rng, r, k, b) for _ in range(3)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        st = store.replicated_init(pncounter.SPEC, r, device=dev, num_keys=k,
                                   num_writers=r)
        tick = engine.make_tick(pncounter.SPEC, device=dev)
        for ops in batches:
            st = tick(st, workloads.ops_to_device(ops, dev))
        out[dev.type] = {f: v.cpu() for f, v in st.items()}
    for f in "pn":
        assert torch.equal(out["cuda"][f], out["cpu"][f])


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices(cuda_device):
    p = torch.zeros((2, 3, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.replica_join(p, p.cpu())
    ops = {f: torch.zeros((2, 5), dtype=torch.int32) for f in
           ("op", "key", "a0", "writer")}
    with pytest.raises(ValueError):
        kernels.pnc_apply(p, p.clone(), ops)
    # a field with fewer columns than ``op`` would be read past its end
    ops = {f: v.to(cuda_device) for f, v in ops.items()}
    ops["key"] = ops["key"][:, :4].contiguous()
    with pytest.raises(ValueError, match="'key'"):
        kernels.pnc_apply(p, p.clone(), ops)


@pytest.mark.cuda
def test_safekv_on_card_matches_safekv_on_cpu(cuda_device):
    """SafeKV for the PN-Counter (submit and delta-apply through
    ``pnc_apply``; DAG round, causal closure and commit through
    ``dag_round``, ``causal_closure`` and ``tusk_commit``) at N=4, window 8, 64-op blocks, 16 keys, with node 3
    crashed for rounds 5-9: every device tensor and the packed output
    bit-equal, round by round, between the card and the CPU."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.runtime import safecrdt

    n, w, b, k = 4, 8, 64, 16
    rng = np.random.default_rng(12)
    kvs = {dev.type: safecrdt.SafeKV(DagConfig(n, w), pncounter.SPEC,
                                     ops_per_block=b, device=dev,
                                     num_keys=k, num_writers=n)
           for dev in (cuda_device, torch.device("cpu"))}
    before = kernels.launches()
    for t in range(20):
        ops = workloads.pnc_uniform(rng, n, k, b)
        safe = rng.random((n, b)) < 0.5
        active = np.array([True] * 3 + [not 5 <= t < 10])
        packed = {}
        for name, kv in kvs.items():
            packed[name], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, kv.device), safe, active=active)
            kv.step_absorb(packed[name], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"])
        st = {name: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for name, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
    grew = {k: v - before[k] for k, v in kernels.launches().items()}
    assert grew["pnc_apply"] == 3 * 20
    # the card's rounds ran through the consensus kernels, once per round
    for name in ("dag_round", "causal_closure", "tusk_commit"):
        assert grew[name] == 20, (name, grew)
    assert kvs["cuda"].stats == kvs["cpu"].stats
    assert kvs["cuda"].stats["state_transfers"] > 0


def _assert_trees_equal(a, b, where):
    assert a.keys() == b.keys(), where
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key], f"{where}.{key}")
        else:
            assert a[key].dtype == b[key].dtype, (where, key)
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{where}.{key}")


def _consensus_inputs(dev, n, w, seed):
    """Random states (``workloads.consensus_state``) on ``dev``: every
    third one wraps int32; masks from ``workloads.round_masks``."""
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        d, c, applied = workloads.consensus_state(rng, n, w, wrap=i % 3 == 2)
        masks = workloads.round_masks(rng, n, w)
        to = (lambda tree: {f: torch.as_tensor(v, device=dev)
                            for f, v in tree.items()})
        out.append((DagConfig(n, w), to(d), to(c),
                    torch.as_tensor(applied, device=dev),
                    [torch.as_tensor(m, device=dev) for m in masks]))
    return out


def _assert_outputs_equal(got, ref):
    if isinstance(got, dict):
        assert got.keys() == ref.keys()
        got, ref = list(got.values()), [ref[k] for k in got]
    elif isinstance(got, torch.Tensor):
        got, ref = [got], [ref]
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(4, 8), (16, 8)])
def test_tusk_commit_kernel_matches_plain(cuda_device, n, w):
    """steps 2 and W//2, seeds 0 and 1; at least one state commits."""
    committed = 0
    for cfg, d, c, _, _ in _consensus_inputs(cuda_device, n, w, seed=n):
        for steps in (2, w // 2):
            for seed in (0, 1):
                before = kernels.tusk_commit.launches
                got = kernels.tusk_commit(cfg, d, c, seed, steps)
                ref = kernels.tusk_commit_plain(cfg, d, c, seed, steps)
                torch.cuda.synchronize()
                assert kernels.tusk_commit.launches == before + 1
                _assert_outputs_equal(got, ref)
                committed += int((got[4] != c["commit_counter"]).any())
    assert committed > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(4, 8), (16, 8)])
def test_causal_closure_kernel_matches_plain(cuda_device, n, w):
    for cfg, d, _, applied, _ in _consensus_inputs(cuda_device, n, w, seed=n):
        before = kernels.causal_closure.launches
        got = kernels.causal_closure(cfg, d, applied)
        ref = kernels.causal_closure_plain(cfg, d, applied)
        torch.cuda.synchronize()
        assert kernels.causal_closure.launches == before + 1
        _assert_outputs_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(4, 8), (16, 8)])
def test_dag_round_kernel_matches_plain(cuda_device, n, w):
    """Every combination of the three optional masks."""
    for cfg, d, _, _, masks in _consensus_inputs(cuda_device, n, w, seed=n):
        for keep in range(8):
            sel = [m if keep >> j & 1 else None for j, m in enumerate(masks)]
            before = kernels.dag_round.launches
            got = kernels.dag_round(cfg, d, *sel)
            ref = kernels.dag_round_plain(cfg, d, *sel)
            torch.cuda.synchronize()
            assert kernels.dag_round.launches == before + 1
            _assert_outputs_equal(got, ref)


@pytest.mark.cuda
def test_consensus_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """Mixed devices, a strided tensor, a wrong dtype and N > 64 raise
    ValueError before anything launches."""
    from janus_tpu_torch.consensus import DagConfig, dag, tusk

    def calls(cfg, d, c, applied):
        return (lambda: kernels.tusk_commit(cfg, d, c, 0, 2),
                lambda: kernels.causal_closure(cfg, d, applied),
                lambda: kernels.dag_round(cfg, d))

    [(cfg, d, c, applied, _)] = _consensus_inputs(cuda_device, 4, 8, 1)[:1]
    before = kernels.launches()
    bad = []
    mixed = dict(d, cert_seen=d["cert_seen"].cpu())
    bad.append(calls(cfg, mixed, c, applied))
    strided = dict(d, edges=d["edges"].transpose(1, 2))
    bad.append(calls(cfg, strided, c, applied))
    wrong = dict(d, node_round=d["node_round"].long(),
                 edges=d["edges"].to(torch.uint8))
    bad.append(calls(cfg, wrong, dict(c, eval_wave=c["eval_wave"].long()),
                     applied.to(torch.uint8)))
    for fns in bad:
        for fn in fns:
            with pytest.raises(ValueError):
                fn()
    cfg65 = DagConfig(65, 4)
    d65, c65 = dag.init(cfg65, cuda_device), tusk.init_commit(cfg65, cuda_device)
    for fn in calls(cfg65, d65, c65, torch.zeros((65, 4, 65), dtype=torch.bool,
                                                 device=cuda_device)):
        with pytest.raises(ValueError, match="64"):
            fn()
    assert kernels.launches() == before


# -- the OR-Set kernels ------------------------------------------------------

ORSET_FIELDS = ("tag_rep", "tag_ctr", "elem", "removed", "valid")


def _on(tree, dev):
    return {f: torch.as_tensor(np.asarray(v), device=dev) for f, v in tree.items()}


def _slots(rng, shape, c, dev, **kw):
    return _on(workloads.orset_slots(rng, shape, c, **kw), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,ca,cb,cap,canonical", [
    ((3, 5), 6, 6, 6, False), ((7,), 8, 8, 8, True), ((2, 4), 5, 3, 4, False),
    ((4,), 3, 2, 8, True), ((2, 50), 256, 256, 256, True)])
def test_slot_union_kernel_matches_plain(cuda_device, lead, ca, cb, cap,
                                         canonical):
    """Non-canonical rows with duplicate tags inside one input, full rows
    (overflow), unequal widths, padding, the path's 256-slot rows; and the
    in-place form writing one union into several output replicas."""
    rng = np.random.default_rng(ca + cb + cap)
    a = _slots(rng, lead, ca, cuda_device, canonical=canonical, dup_rows=0.3)
    b = _slots(rng, lead, cb, cuda_device, canonical=canonical, dup_rows=0.3)
    before = kernels.slot_union.launches
    got, ovf = kernels.slot_union(a, b, cap)
    ref, rovf = kernels.slot_union_plain(a, b, cap)
    out = {f: torch.zeros((3,) + lead + (cap,), dtype=got[f].dtype,
                          device=cuda_device) for f in ORSET_FIELDS}
    kernels.slot_union(a, b, cap, out=out)
    torch.cuda.synchronize()
    assert kernels.slot_union.launches == before + 2
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(ovf, rovf)
    for f in ORSET_FIELDS:
        assert torch.equal(out[f], ref[f].expand_as(out[f]))


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,c,b,r_cap,canonical", [
    (3, 5, 6, 24, 3, True), (2, 4, 8, 32, 8, False), (4, 3, 4, 16, 6, True),
    (4, 100, 64, 8192, 4, True), (1, 7, 8, 16384, 2, True)])
def test_orset_capture_kernel_matches_plain(cuda_device, v, k, c, b, r_cap,
                                            canonical):
    """Keys in [-K, 2K), SENTINEL adds, a tag carried twice, r_cap > C;
    the consensus path's shape; and a batch too wide for shared memory."""
    rng = np.random.default_rng(b + c)
    st = _slots(rng, (v, k), c, cuda_device, canonical=canonical, full_rows=0.4)
    ops = workloads.orset_mixed_ops(rng, (v, b), k, c)
    ops["a1"][:, 3], ops["a2"][:, 3] = ops["a1"][:, 1], ops["a2"][:, 1]
    ops = _on(ops, cuda_device)
    before = kernels.orset_capture.launches
    got = kernels.orset_capture(st, ops, r_cap)
    ref = kernels.orset_capture_plain(st, ops, r_cap)
    torch.cuda.synchronize()
    assert kernels.orset_capture.launches == before + 1
    _assert_outputs_equal(list(got), list(ref))
    assert bool((ref[0] != INT32_MAX).any())


def _captured_ops(rng, st, v, b, k, c, r_cap, dev, hot=False):
    ops = workloads.orset_mixed_ops(rng, (v, b), k, c)
    if hot:
        ops["key"][:] = 0
    cap = kernels.orset_capture_plain(st, _on(ops, dev), r_cap)
    ops.update({f: x.cpu().numpy() for f, x in
                zip(("rm_rep", "rm_ctr", "rm_elem"), cap)})
    return _on(workloads.with_capture_hazards(rng, ops), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,c,b,r_cap,canonical,hot", [
    (3, 5, 6, 24, 3, True, False), (2, 4, 8, 32, 8, False, False),
    (4, 100, 64, 8192, 4, True, False), (2, 3, 64, 8192, 4, True, True)])
def test_orset_replay_kernel_matches_plain(cuda_device, v, k, c, b, r_cap,
                                           canonical, hot):
    """Hazard lanes, negative keys (their drops), a tag folded from four
    copies, full rows (drops); the path's shape; one hot key whose bucket
    is sorted in global memory."""
    rng = np.random.default_rng(100 + b + c)
    st = _slots(rng, (v, k), c, cuda_device, canonical=canonical, full_rows=0.4)
    ops = _captured_ops(rng, st, v, b, k, c, r_cap, cuda_device, hot)
    before = kernels.orset_replay.launches
    got, drop = kernels.orset_replay(st, ops)
    ref, rdrop = kernels.orset_replay_plain(st, ops)
    torch.cuda.synchronize()
    assert kernels.orset_replay.launches == before + 1
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(drop, rdrop)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c,b,canonical", [
    (3, 5, 6, 24, False), (2, 4, 8, 32, True), (4, 2, 4, 32, True),
    (8, 500, 256, 64, True)])
def test_orset_apply_kernel_matches_plain(cuda_device, r, k, c, b, canonical):
    """Keys in [-K, 2K), SENTINEL adds, folds, evictions from full rows
    (counted drops), non-canonical rows; the store path's 256-slot rows."""
    rng = np.random.default_rng(200 + b + c)
    st = _slots(rng, (r, k), c, cuda_device, canonical=canonical, full_rows=0.5)
    ops = _on(workloads.orset_mixed_ops(rng, (r, b), k, c), cuda_device)
    ref = {f: x.clone() for f, x in st.items()}
    before = kernels.orset_apply.launches
    drop = kernels.orset_apply(st, ops)
    rdrop = kernels.orset_apply_plain(ref, ops)
    torch.cuda.synchronize()
    assert kernels.orset_apply.launches == before + 1
    _assert_outputs_equal(st, ref)
    _assert_outputs_equal(drop, rdrop)


@pytest.mark.cuda
def test_orset_tick_on_card_matches_tick_on_cpu(cuda_device):
    """The anti-entropy tick (orset_apply, then slot_union per level of the
    converge) at 6 replicas, 40 keys, 16 slots, 32 ops, over 4 ticks."""
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.utils.ids import TagMinter

    r, k, c, b = 6, 40, 16, 32
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        rng = np.random.default_rng(4)
        minters = [TagMinter(i) for i in range(r)]
        st = store.replicated_init(orset.SPEC, r, device=dev, num_keys=k,
                                   capacity=c, rm_capacity=4)
        tick = engine.make_tick(orset.SPEC, device=dev)
        for t in range(4):
            ops = workloads.orset_hot_window(rng, minters, k, b, t, hot=8)
            st = tick(st, workloads.ops_to_device(ops, dev))
        out[dev.type] = {f: x.cpu() for f, x in st.items()}
    _assert_outputs_equal(out["cuda"], out["cpu"])


@pytest.mark.cuda
def test_orset_safekv_on_card_matches_safekv_on_cpu(cuda_device):
    """SafeKV for the OR-Set (submit through orset_capture and orset_replay,
    delta applies through orset_replay, compaction at GC advances) at N=4,
    window 8, 64-op blocks, 12 keys, node 3 crashed for rounds 5-9: every
    device tensor and the packed output bit-equal, round by round."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime import safecrdt
    from janus_tpu_torch.utils.ids import TagMinter

    n, w, b, k = 4, 8, 64, 12
    rng = np.random.default_rng(13)
    minters = [TagMinter(i) for i in range(n)]
    kvs = {dev.type: safecrdt.SafeKV(DagConfig(n, w), orset.SPEC,
                                     ops_per_block=b, device=dev,
                                     apply_budget=8, num_keys=k, capacity=16,
                                     rm_capacity=4)
           for dev in (cuda_device, torch.device("cpu"))}
    before = kernels.launches()
    for t in range(20):
        ops = workloads.orset_add_remove(rng, minters, k, b, num_elems=8)
        active = np.array([True] * 3 + [not 5 <= t < 10])
        packed = {}
        for name, kv in kvs.items():
            packed[name], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, kv.device), active=active)
            kv.step_absorb(packed[name], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"])
        st = {name: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for name, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
    grew = {name: x - before[name] for name, x in kernels.launches().items()}
    assert grew["orset_capture"] == 20
    assert grew["orset_replay"] == 3 * 20
    assert kvs["cuda"].stats == kvs["cpu"].stats
    assert kvs["cuda"].stats["compactions"] > 0


@pytest.mark.cuda
def test_orset_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(0)
    st = _slots(rng, (2, 3), 4, cuda_device)
    ops = _on(workloads.orset_mixed_ops(rng, (2, 8), 3, 4), cuda_device)
    before = kernels.launches()
    with pytest.raises(ValueError, match="32"):
        kernels.orset_capture(st, ops, 33)
    with pytest.raises(ValueError):
        kernels.orset_apply(dict(st, elem=st["elem"].cpu()), ops)
    with pytest.raises(ValueError):
        kernels.slot_union(st, dict(st, removed=st["removed"].to(torch.uint8)))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.slot_union(*(_slots(rng, (1,), 6000, cuda_device)
                             for _ in range(2)))
    assert kernels.launches() == before


def _dirty_mask(rng, r, k, p, dev, hot=None):
    """bool[r, k]: each bit set with probability p, or exactly the keys
    ``hot`` set in replica 0."""
    m = rng.random((r, k)) < p
    if hot is not None:
        m[:] = False
        m[0, hot] = True
    return torch.from_numpy(m).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,b", [(64, 500, 64), (3, 7, 33), (1, 5000, 4097)])
def test_dirty_rows_kernel_matches_plain(cuda_device, r, k, b):
    """Keys in [-K, 2K) and no-ops, into a fresh mask and ORed into a
    running one."""
    rng = np.random.default_rng(r + k)
    op = torch.from_numpy(rng.integers(0, 3, (r, b)).astype(np.int32)).to(cuda_device)
    key = torch.from_numpy(rng.integers(-k, 2 * k, (r, b)).astype(np.int32)).to(cuda_device)
    running = _dirty_mask(rng, r, k, 0.05, cuda_device)
    before = kernels.dirty_rows.launches
    fresh = kernels.dirty_rows(op, key, k)
    mine = kernels.dirty_rows(op, key, k, out=running.clone())
    ref_fresh = kernels.dirty_rows_plain(op, key, k)
    ref = kernels.dirty_rows_plain(op, key, k, out=running.clone())
    torch.cuda.synchronize()
    assert kernels.dirty_rows.launches == before + 2
    assert torch.equal(fresh, ref_fresh) and torch.equal(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,case", [
    (64, 500, "random"), (64, 500, "zero"), (64, 500, "all"),
    (5, 3000, "random"), (1, 37, "random"), (3, 500, "budget"),
    (3, 500, "budget+1")])
def test_delta_select_kernel_matches_plain(cuda_device, r, k, case):
    """Random masks (odd R, R=1, K over one block's 1024 threads), none
    dirty, all dirty, a count exactly at the budget and one over it; with
    the mask consumed and the running sums added."""
    rng = np.random.default_rng(k + r)
    budget = 64
    if case == "zero":
        mask = _dirty_mask(rng, r, k, 0.0, cuda_device)
    elif case == "all":
        mask = _dirty_mask(rng, r, k, 1.0, cuda_device)
    elif case.startswith("budget"):
        n = budget + (case == "budget+1")
        mask = _dirty_mask(rng, r, k, 0, cuda_device,
                           hot=rng.choice(k, n, replace=False))
    else:
        mask = _dirty_mask(rng, r, k, 0.01, cuda_device)
    acc = [torch.zeros((), dtype=torch.int32, device=cuda_device) for _ in range(4)]
    d_mine, d_ref = mask.clone(), mask.clone()
    before = kernels.delta_select.launches
    mine = kernels.delta_select(d_mine, budget, clear=True, acc_count=acc[0],
                                acc_overflow=acc[1])
    ref = kernels.delta_select_plain(d_ref, budget, clear=True,
                                     acc_count=acc[2], acc_overflow=acc[3])
    torch.cuda.synchronize()
    assert kernels.delta_select.launches == before + 1
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(acc[0], acc[2]) and torch.equal(acc[1], acc[3])
    assert not d_mine.any()
    if case.startswith("budget"):
        assert bool(mine.overflowed) == (case == "budget+1")


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,w,n_rows", [
    (64, 500, 64, 32), (64, 500, 64, 500), (5, 9, 7, 4), (1, 6, 4, 6),
    (3, 40, 3, 0)])
def test_replica_join_rows_kernel_matches_plain(cuda_device, r, k, w, n_rows):
    """Listed rows only (the rest untouched), all K rows, odd R, R=1, the
    scalar and the vector path, and nothing to join."""
    rng = np.random.default_rng(r * k)
    st = {f: torch.from_numpy(_rand(rng, (r, k, w))).to(cuda_device) for f in "pn"}
    rows = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(cuda_device)
    n = torch.tensor(n_rows, dtype=torch.int32, device=cuda_device)
    ref = {f: v.clone() for f, v in st.items()}
    before = kernels.replica_join_rows.launches
    kernels.replica_join_rows(st["p"], st["n"], rows, n)
    kernels.replica_join_rows_plain(ref["p"], ref["n"], rows, n)
    torch.cuda.synchronize()
    assert kernels.replica_join_rows.launches == before + 1
    for f in "pn":
        assert torch.equal(st[f], ref[f])


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c,n_rows", [
    (8, 40, 16, 5), (5, 40, 16, 40), (2, 30, 8, 7), (3, 9, 6, 9), (1, 4, 4, 4),
    (64, 50, 256, 20)])
def test_join_replica_rows_on_card_matches_plain(cuda_device, r, k, c, n_rows):
    """The OR-Set's row-list converge (``slot_union_rows`` per level of the
    halving tree) against the same tree of plain versions, on random
    non-canonical rows: every R from 1 (no launch) through odd counts to
    R=2 (level 1 writes in place) and 64."""
    from janus_tpu_torch.models import orset

    rng = np.random.default_rng(r + k + c)
    st = _slots(rng, (r, k), c, cuda_device, canonical=False, dup_rows=0.3)
    st["_rm_cap"] = torch.zeros((r, 4, 0), dtype=torch.int32, device=cuda_device)
    rows = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(cuda_device)
    n = torch.tensor(n_rows, dtype=torch.int32, device=cuda_device)
    ref = {f: x.clone() for f, x in st.items()}
    before = kernels.slot_union_rows.launches
    orset.join_replica_rows(st, rows, n)
    real = kernels.slot_union_rows
    kernels.slot_union_rows = kernels.slot_union_rows_plain
    try:
        orset.join_replica_rows(ref, rows, n)
    finally:
        kernels.slot_union_rows = real
    torch.cuda.synchronize()
    assert kernels.slot_union_rows.launches == before + int(np.ceil(np.log2(r)))
    _assert_outputs_equal(st, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [64, 16])
def test_store_fused_tick_on_card_matches_cpu(cuda_device, budget):
    """The two-type store at 8 replicas, 200 keys, B=32, hot window 32:
    delta fused ticks on the card equal the same ticks on the CPU, with
    equal accumulators; budget 16 overflows."""
    from janus_tpu_torch.utils.ids import TagMinter

    types = {"pnc": dict(num_keys=200, num_writers=8),
             "orset": dict(num_keys=200, capacity=32, rm_capacity=4)}
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        rng = np.random.default_rng(8)
        minters = [TagMinter(i) for i in range(8)]
        st = store.Store(8, types, dirty_budget=budget, device=dev)
        for t in range(4):
            ops = workloads.store_delta_tick(rng, minters, 200, 32, t, 32)
            st.fused_tick({tc: workloads.ops_to_device(o, dev)
                           for tc, o in ops.items()})
        out[dev.type] = ({tc: {f: x.cpu() for f, x in s.items()}
                          for tc, s in st.states.items()},
                         {k: int(v) for k, v in st._fused_acc.items()})
    for tc in types:
        _assert_outputs_equal(out["cuda"][0][tc], out["cpu"][0][tc])
    assert out["cuda"][1] == out["cpu"][1]
    assert (out["cuda"][1]["overflow_orset"] > 0) == (budget == 16)


def _rga_rows(rng, shape, c, dev, **kw):
    return _on(workloads.rga_slots(rng, shape, c, **kw), dev)


def _rga_state(rng, r, k, c, dev, depth=8, **kw):
    st = _rga_rows(rng, (r, k), c, dev, **kw)
    st["ctr_floor"] = torch.as_tensor(
        rng.integers(-2, c + 2, (r, k)).astype(np.int32), device=dev)
    st["_depth"] = torch.zeros((r, depth, 0), dtype=torch.int32, device=dev)
    return st


def _clone(tree):
    return {f: x.clone() for f, x in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("lead,ca,cb,cap,canonical", [
    ((3, 5), 6, 6, 6, False), ((7,), 8, 8, 8, True), ((2, 4), 5, 3, 4, False),
    ((4,), 3, 2, 8, True), ((2, 20), 1024, 1024, 1024, True),
    ((3, 4), 300, 200, 256, False)])
def test_rga_union_kernel_matches_plain(cuda_device, lead, ca, cb, cap,
                                        canonical):
    """The RGA instantiation of slot_union.cu: random rows (full ones,
    negative ids, repeated ids in non-canonical rows), half of b's ids
    copied from a; fresh outputs and the broadcast ``out`` form."""
    rng = np.random.default_rng(ca + cb + cap)
    a = workloads.rga_slots(rng, lead, ca, canonical=canonical, dup_rows=0.4,
                            full_rows=0.5, negative=0.1)
    b = workloads.rga_slots(rng, lead, cb, canonical=canonical, dup_rows=0.4,
                            full_rows=0.5, negative=0.1)
    m = min(ca, cb)
    take = rng.random(lead + (m,)) < 0.5
    for f in ("id_ctr", "id_rep", "valid"):
        b[f][..., :m] = np.where(take, a[f][..., :m], b[f][..., :m])
    a, b = _on(a, cuda_device), _on(b, cuda_device)
    before = kernels.rga_union.launches
    got, ovf = kernels.rga_union(a, b, cap)
    ref, ref_ovf = kernels.rga_union_plain(a, b, cap)
    out = {f: torch.zeros((2,) + lead + (cap,), dtype=x.dtype,
                          device=cuda_device) for f, x in got.items()}
    kernels.rga_union(a, b, cap, out=out)
    torch.cuda.synchronize()
    assert kernels.rga_union.launches == before + 2
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(ovf, ref_ovf)
    for f in got:
        assert torch.equal(out[f], ref[f].expand_as(out[f]))


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c,b,captured,canonical", [
    (3, 5, 8, 40, False, True), (4, 3, 6, 300, True, False),
    (8, 128, 1024, 32, False, True), (2, 7, 300, 64, True, True),
    (5, 2, 4, 24, False, False)])
def test_rga_apply_kernel_matches_plain(cuda_device, r, k, c, b, captured,
                                        canonical):
    """Uncaptured and eff_ctr applies with keys in [-K, 2K), full rows,
    deletes before inserts, re-inserts, negative and SENTINEL ids; B past
    one tile of 256 lanes; C past one slot per thread."""
    rng = np.random.default_rng(r * k + c + b)
    st = _rga_state(rng, r, k, c, cuda_device, canonical=canonical,
                    dup_rows=0.3, full_rows=0.4, negative=0.1)
    ops = _on(workloads.rga_mixed_ops(rng, (r, b), k, c, captured=captured),
              cuda_device)
    ref = _clone(st)
    before = kernels.rga_apply.launches
    drop = kernels.rga_apply(st, ops)
    ref_drop = kernels.rga_apply_plain(ref, ops)
    torch.cuda.synchronize()
    assert kernels.rga_apply.launches == before + 1
    _assert_outputs_equal(st, ref)
    _assert_outputs_equal(drop, ref_drop)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,c,protect,canonical", [
    ((3, 5), 12, False, True), ((2, 4), 9, True, False),
    ((4, 64), 1024, False, True), ((3, 7), 300, True, False)])
def test_rga_compact_kernel_matches_plain(cuda_device, lead, c, protect,
                                          canonical):
    """Compaction of random trees (dead interior nodes, dangling and
    cyclic parents, repeated ids, invalid slots mid-row), with and without
    a protect mask; fresh outputs and in place."""
    rng = np.random.default_rng(c + len(lead))
    rows = _rga_rows(rng, lead, c, cuda_device, canonical=canonical,
                     dup_rows=0.4, dead=0.6, negative=0.1)
    prot = (torch.as_tensor(rng.random(lead + (c,)) < 0.2, device=cuda_device)
            if protect else None)
    before = kernels.rga_compact.launches
    got = kernels.rga_compact(rows, prot)
    ref = kernels.rga_compact_plain(rows, prot)
    inplace = _clone(rows)
    kernels.rga_compact(inplace, prot, out=inplace)
    torch.cuda.synchronize()
    assert kernels.rga_compact.launches == before + 2
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(inplace, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,depth,canonical", [
    (6, 16, 4, True), (5, 12, 3, False), (8, 1024, 8, True),
    (4, 300, 8, False), (3, 8, 1, False), (2, 64, 32, True)])
def test_rga_order_kernel_matches_plain(cuda_device, n, c, depth, canonical):
    """The path-key linearization on random deep trees: chains past
    ``depth`` (overflow), dangling and cyclic parents, repeated ids,
    negative ids, invalid slots mid-row."""
    rng = np.random.default_rng(n + c + depth)
    rows = _rga_rows(rng, (n,), c, cuda_device, canonical=canonical,
                     dup_rows=0.6, chain=0.6, dangling=0.1, negative=0.1,
                     full_rows=0.5)
    before = kernels.rga_order.launches
    got = kernels.rga_order(rows, depth)
    ref = kernels.rga_order_plain(rows, depth)
    torch.cuda.synchronize()
    assert kernels.rga_order.launches == before + 1
    for g, w in zip(got, ref, strict=True):
        _assert_outputs_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n_rows", [(8, 3), (5, 6), (2, 2), (1, 4)])
def test_rga_join_replica_rows_on_card_matches_plain(cuda_device, r, n_rows):
    """The RGA's row-list converge (``rga_union_rows`` per level and
    ``replica_join_rows`` on ``ctr_floor``) against the same tree of plain
    versions."""
    from janus_tpu_torch.models import rga

    rng = np.random.default_rng(r + n_rows)
    st = _rga_state(rng, r, 6, 16, cuda_device, canonical=False, dup_rows=0.3)
    rows = torch.from_numpy(rng.permutation(6).astype(np.int32)).to(cuda_device)
    n = torch.tensor(n_rows, dtype=torch.int32, device=cuda_device)
    ref = _clone(st)
    before = kernels.rga_union_rows.launches
    rga.join_replica_rows(st, rows, n)
    real = (kernels.rga_union_rows, kernels.replica_join_rows)
    kernels.rga_union_rows = kernels.rga_union_rows_plain
    kernels.replica_join_rows = kernels.replica_join_rows_plain
    try:
        rga.join_replica_rows(ref, rows, n)
    finally:
        kernels.rga_union_rows, kernels.replica_join_rows = real
    torch.cuda.synchronize()
    assert kernels.rga_union_rows.launches == before + int(np.ceil(np.log2(r)))
    _assert_outputs_equal(st, ref)


@pytest.mark.cuda
def test_rga_tick_on_card_matches_tick_on_cpu(cuda_device):
    """Harness preset ``rga`` shrunk to R=16, K=8, L=4 (capacity 64), 8
    ticks with compaction every 4, on the card and on the CPU: bit-equal
    after every tick, text of document 0 included."""
    from janus_tpu_torch.models import rga

    R, K, L, lag, every = 16, 8, 4, 2, 4
    cap = R * L // K * (lag + every + 2)
    sts, ticks = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        sts[dev.type] = store.replicated_init(rga.SPEC, R, device=dev,
                                              num_keys=K, capacity=cap,
                                              max_depth=8)
        ticks[dev.type] = engine.make_tick(rga.SPEC, device=dev)
    rngs = {d: np.random.default_rng(0) for d in sts}
    for t in range(8):
        for d in sts:
            ops = workloads.ops_to_device(
                workloads.rga_text_replay(rngs[d], R, K, L, lag, t), d)
            ticks[d](sts[d], ops)
            if t % every == every - 1:
                rga.compact(sts[d])
        _assert_trees_equal({f: x.cpu().numpy() for f, x in sts["cuda"].items()},
                            {f: x.numpy() for f, x in sts["cpu"].items()},
                            f"tick {t}")
    text = {d: rga.text({f: x[0] for f, x in st.items()}, 0)
            for d, st in sts.items()}
    for f in text["cpu"]:
        assert torch.equal(text["cuda"][f].cpu(), text["cpu"][f])


@pytest.mark.cuda
def test_rga_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(0)
    st = _rga_state(rng, 2, 3, 4, cuda_device)
    ops = _on(workloads.rga_mixed_ops(rng, (2, 8), 3, 4), cuda_device)
    before = kernels.launches()
    with pytest.raises(ValueError):
        kernels.rga_apply(dict(st, chr=st["chr"].cpu()), ops)
    with pytest.raises(ValueError):
        kernels.rga_union(st, dict(st, dead=st["dead"].to(torch.uint8)))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.rga_union(*(_rga_rows(rng, (1,), 4000, cuda_device)
                            for _ in range(2)))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.rga_order(_rga_rows(rng, (1,), 4096, cuda_device), 32)
    with pytest.raises(ValueError):
        kernels.rga_order({f: x[0] for f, x in st.items()}, 0)
    assert kernels.launches() == before


# -- the rest of the SafeKV round: submit, block selection, state transfer,
# the GC frontier ------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _same(a, b, where="out"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _kernel_vs_plain(fn, plain, args):
    """The wrapper on the card and its plain version on clones of the same
    inputs: outputs and in-place updates bit-equal."""
    mine, ref = _clone(args), _clone(args)
    out = fn(*mine)
    want = plain(*ref)
    torch.cuda.synchronize()
    _same((mine, out), (ref, want))
    return out


def _ring(rng, n, w, b, r, dev):
    ring = {f: torch.as_tensor(_rand(rng, (w, n, b), -5, 50), device=dev)
            for f in OP_FIELDS}
    if r:
        ring.update({f: torch.as_tensor(_rand(rng, (w, n, b, r)), device=dev)
                     for f in ("rm_rep", "rm_ctr", "rm_elem")})
    return ring


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(4, 8), (16, 8), (64, 8)])
def test_safekv_submit_and_board_match_plain(cuda_device, n, w):
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(n + w)
    cfg = DagConfig(n, w)
    dev = cuda_device
    seen = np.zeros(2, int)
    for i in range(6):
        d, _, _ = workloads.consensus_state(rng, n, w, wrap=i % 3 == 2)
        dag = {f: torch.as_tensor(v, device=dev) for f, v in d.items()}
        b, r = (1, 37, 64)[i % 3], (0, 4)[i % 2]
        filled = torch.as_tensor(rng.random((w, n)) < 0.3, device=dev)
        active = None if i % 2 else torch.as_tensor(rng.random(n) < 0.8,
                                                    device=dev)
        ops = {f: torch.as_tensor(_rand(rng, (n, b)), device=dev)
               for f in OP_FIELDS}
        acc_ops, accepted, pre = _kernel_vs_plain(
            kernels.safekv_submit, kernels.safekv_submit_plain,
            (cfg, dag, filled, ops, active))
        seen += [int(accepted.sum()), int((~accepted).sum())]
        ring = _ring(rng, n, w, b, r, dev)
        captured = {f: acc_ops[f] if f in acc_ops else
                    torch.as_tensor(_rand(rng, x.shape[1:]), device=dev)
                    for f, x in ring.items()}
        for rounds in (pre, torch.as_tensor(_rand(rng, (n,), -3 * w, 3 * w),
                                        device=dev)):
            applied = torch.as_tensor(rng.random((n, w, n)) < 0.3, device=dev)
            _kernel_vs_plain(kernels.safekv_board, kernels.safekv_board_plain,
                             (cfg, ring, filled, applied, captured, accepted,
                              rounds))
    assert seen.min() > 0  # views accepted and views rejected


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(4, 8), (64, 8), (64, 16)])
def test_block_select_matches_plain(cuda_device, n, w):
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(3 * n + w)
    cfg = DagConfig(n, w)
    dev = cuda_device
    spilled = 0
    for i in range(4):
        d, _, _ = workloads.consensus_state(rng, n, w, wrap=i % 2 == 1)
        sr = torch.as_tensor(d["slot_round"], device=dev)
        base = torch.as_tensor(d["base_round"], device=dev)
        for p, budget in ((0.2, 4 * n), (0.9, max(1, n // 2)),
                          (0.9, 3 * w * n), (0.5, 1)):
            ready = torch.as_tensor(rng.random((n, w, n)) < p, device=dev)
            applied = torch.as_tensor(rng.random((n, w, n)) < 0.2, device=dev)
            seq = None if budget % 2 else torch.as_tensor(
                _rand(rng, (n, w, n), 0, 2**31 // (w * n) + 50), device=dev)
            spilled += int((ready & ~applied).sum(dim=(1, 2)).max()) > budget
            _kernel_vs_plain(kernels.block_select, kernels.block_select_plain,
                             (cfg, _ring(rng, n, w, 3, i % 2 * 4, dev), ready,
                              applied, budget, sr, base, seq))
    assert spilled > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 7, 64])
def test_state_transfer_matches_plain(cuda_device, n):
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(n)
    w = 8
    cfg = DagConfig(n, w)
    dev = cuda_device
    moved = 0
    for i in range(6):
        lw = np.where(rng.random(n) < 0.25, rng.integers(-1, 4, n),
                      rng.integers(8, 11, n)).astype(np.int32)
        lw = torch.as_tensor(lw, device=dev)
        nr = torch.as_tensor(_rand(rng, (n,), -2, 6), device=dev)
        base = torch.as_tensor(np.int32(rng.integers(0, 3)), device=dev)
        force = torch.as_tensor(rng.random(n) < 0.2, device=dev)
        if i % 2:
            force[int(torch.argmax(lw))] = True  # the donor itself
        leaves = [torch.as_tensor(_rand(rng, (n, 3, 5)), device=dev),
                  torch.as_tensor(rng.random((n, w, n)) < 0.5, device=dev),
                  nr, lw, torch.zeros((n, 3, 0), dtype=torch.int32, device=dev),
                  torch.as_tensor(rng.random(n) < 0.5, device=dev)]
        need, donor = _kernel_vs_plain(
            kernels.state_transfer, kernels.state_transfer_plain,
            (cfg, leaves, nr, base, lw, force))
        moved += int(need.sum()) - int(need[int(donor)])
    assert moved > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,logs", [(4, 8, True), (4, 8, False),
                                      (64, 8, True), (64, 16, False)])
def test_gc_frontier_matches_plain(cuda_device, n, w, logs):
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(n * w + logs)
    cfg = DagConfig(n, w)
    dev = cuda_device
    advanced = 0
    for i in range(8):
        dag, com, before, pa, sa, bf = (
            {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
            if isinstance(x, dict) else torch.as_tensor(x, device=dev)
            for x in workloads.gc_state(rng, n, w, wrap=i % 4 == 3))
        drops = (torch.as_tensor(_rand(rng, (n,)), device=dev),
                 None if i % 2 else torch.as_tensor(_rand(rng, (n,)),
                                                    device=dev))
        lost, dead, _ = _kernel_vs_plain(
            kernels.gc_frontier, kernels.gc_frontier_plain,
            (cfg, dag, com, before, pa, sa, bf,
             torch.as_tensor(_rand(rng, (n,), -9, 99), device=dev),
             torch.as_tensor(rng.random(n) < 0.7, device=dev),
             torch.as_tensor(rng.random(n) < 0.2, device=dev),
             torch.as_tensor(np.int32(rng.integers(0, n)), device=dev),
             drops, logs))
        advanced += int(dead.sum()) >= 2
        _kernel_vs_plain(kernels.gc_clear_ring, kernels.gc_clear_ring_plain,
                         (cfg, _ring(rng, n, w, 5, 4, dev), dead))
    assert advanced > 0


@pytest.mark.cuda
def test_mixed_safekv_on_card_matches_cpu_at_64_nodes(cuda_device):
    """Both types at 64 nodes (harness preset mixed's cluster, few keys),
    node 63 crashed for rounds 2-5: the packed output and every device
    tensor bit-equal between the card and the CPU, round by round."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime import safecrdt
    from janus_tpu_torch.utils.ids import TagMinter

    n, w, b, k = 64, 8, 8, 12
    rng = np.random.default_rng(64)
    minters = [TagMinter(i) for i in range(n)]

    def make(dev):
        return [safecrdt.SafeKV(DagConfig(n, w), pncounter.SPEC,
                                ops_per_block=b, device=dev, num_keys=k,
                                num_writers=n),
                safecrdt.SafeKV(DagConfig(n, w), orset.SPEC, ops_per_block=b,
                                device=dev, num_keys=k, collect_logs=False,
                                apply_budget=n + n // 4, capacity=8,
                                rm_capacity=2)]

    kvs = {"cuda": make(cuda_device), "cpu": make(torch.device("cpu"))}
    for t in range(10):
        active = np.ones(n, bool)
        active[n - 1] = not 2 <= t < 6
        batches = [workloads.pnc_uniform(rng, n, k, b),
                   workloads.orset_add_remove(rng, minters, k, b)]
        for j, ops in enumerate(batches):
            packed = {}
            for name, pair in kvs.items():
                kv = pair[j]
                packed[name], meta = kv.step_dispatch(
                    workloads.ops_to_device(ops, kv.device), active=active)
                kv.step_absorb(packed[name], meta)
            assert torch.equal(packed["cuda"].cpu(), packed["cpu"]), (t, j)
            st = {name: convert.tree_to_numpy(
                {f: getattr(pair[j], f) for f in safecrdt.DEVICE_FIELDS})
                for name, pair in kvs.items()}
            _assert_trees_equal(st["cuda"], st["cpu"], f"round {t} type {j}")
    assert kvs["cuda"][0].stats == kvs["cpu"][0].stats
    assert kvs["cuda"][0].stats["gc_advances"] > 0

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


# dag_round's geometries: the main path's N (4, 16, 64), a node count that
# is no multiple of 16 (rows across words), and the widest windows at 64
# nodes
DAG_ROUND_SHAPES = [(4, 8), (16, 8), (33, 5), (64, 16), (64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", DAG_ROUND_SHAPES)
def test_dag_round_kernel_matches_plain(cuda_device, n, w):
    """Every combination of the three optional masks; every third state
    wraps int32."""
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
@pytest.mark.parametrize("n,w", DAG_ROUND_SHAPES + [(7, 6)])
def test_dag_round_split_mode_matches_plain(cuda_device, n, w):
    """The split instantiation (``owned`` given) under every combination
    of the three optional masks; every third state wraps int32."""
    rng = np.random.default_rng(n + w)
    for cfg, d, _, _, masks in _consensus_inputs(cuda_device, n, w, seed=n):
        owned = torch.as_tensor(rng.random(n) < 0.5, device=cuda_device)
        for keep in range(8):
            sel = [m if keep >> j & 1 else None for j, m in enumerate(masks)]
            before = kernels.dag_round.launches
            got = kernels.dag_round(cfg, d, *sel, owned=owned)
            ref = kernels.dag_round_plain(cfg, d, *sel, owned=owned)
            torch.cuda.synchronize()
            assert kernels.dag_round.launches == before + 1
            _assert_outputs_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(16, 8), (64, 8)])
def test_dag_round_chained_rounds_match_plain(cuda_device, n, w):
    """Rounds chained on the kernel's own outputs (views of one buffer a
    call), node n - 1 crashed in the middle rounds, held to the plain
    version's chain round by round; one CUDA kernel a call (a captured
    graph's kernel nodes)."""
    import chip_smoke
    from janus_tpu_torch.consensus import dag as dagmod

    cfg = dagmod.DagConfig(n, w)
    got = dagmod.init(cfg, device=cuda_device)
    ref = {f: x.clone() for f, x in got.items()}
    for t in range(3 * w):
        active = torch.ones(n, dtype=torch.bool, device=cuda_device)
        active[n - 1] = not 2 <= t < w
        got = kernels.dag_round(cfg, got, active)
        ref = kernels.dag_round_plain(cfg, ref, active)
        torch.cuda.synchronize()
        _assert_outputs_equal(got, ref)
    assert int(got["node_round"].max()) > 0
    assert chip_smoke.graph_kernels(
        lambda: kernels.dag_round(cfg, got, active)) == 1


def _ingest_case(dev, rng, n, w, payload):
    """A random DAG state and wire batch on ``dev``, packed as
    ``dag.ingest_batch`` packs it, with a ring of pnc's six fields and,
    for ``payload == "orset"``, three capture lanes of width 4."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.kernels.dag_ingest import pack

    b = 5
    d, _, _ = workloads.consensus_state(rng, n, w)
    for f in ("block_exists", "cert_exists", "edges", "acks"):
        d[f] = d[f] & (rng.random(d[f].shape) < 0.35)
    widths = [1] * 6 + ([4] * 3 if payload == "orset" else [])
    ring = tuple(torch.as_tensor(_rand(rng, (w, n, b, k) if k > 1 else (w, n, b)),
                                 device=dev) for k in widths)
    filled = torch.as_tensor(rng.random((w, n)) < 0.3, device=dev)
    blocks, sigs, certs, seen = workloads.wire_batch(
        rng, n, d["slot_round"], payload=b * sum(widths) if payload else 0)
    uniq, pays, keys = [], [], set()
    for blk in blocks:  # ingest_batch's first-copy-wins dedupe
        if (blk[0], blk[1]) not in keys:
            keys.add((blk[0], blk[1]))
            if len(blk) > 3:
                pays.append((len(uniq), blk[3]))
            uniq.append(blk)
    flat, counts = pack(n, uniq, sigs, certs, seen, pays)
    state = {f: torch.as_tensor(v, device=dev) for f, v in d.items()}
    return (DagConfig(n, w), state, torch.as_tensor(flat, device=dev), counts,
            (ring, filled))


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,payload", [(4, 8, "pnc"), (7, 6, None),
                                         (16, 8, "orset"), (64, 8, "pnc"),
                                         (33, 5, None)])
def test_dag_ingest_kernel_matches_plain(cuda_device, n, w, payload):
    """Stale and ahead-of-window rounds, re-sends with other edges, node
    ids out of range, empty and mixed seen_by, payload rows."""
    rng = np.random.default_rng(n * 10 + w)
    for _ in range(6):
        cfg, state, msgs, counts, ring = _ingest_case(cuda_device, rng, n, w,
                                                      payload)
        mine = ({f: v.clone() for f, v in state.items()},
                (tuple(x.clone() for x in ring[0]), ring[1].clone()))
        ref = ({f: v.clone() for f, v in state.items()},
               (tuple(x.clone() for x in ring[0]), ring[1].clone()))
        before = kernels.dag_ingest.launches
        kernels.dag_ingest(cfg, mine[0], msgs, counts, mine[1])
        kernels.dag_ingest_plain(cfg, ref[0], msgs, counts, ref[1])
        torch.cuda.synchronize()
        assert kernels.dag_ingest.launches == before + 1
        _assert_outputs_equal(mine[0], ref[0])
        _assert_outputs_equal(list(mine[1][0]) + [mine[1][1]],
                              list(ref[1][0]) + [ref[1][1]])


@pytest.mark.cuda
def test_split_node_runs_on_the_card(cuda_device):
    """Two SplitNodes on the card over in-memory pipes: a PN-Counter op at
    one process reads back from the other's stable state, and the step's
    ingest and round are card launches."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.net.splitnode import SplitNode

    n, w, b = 4, 8, 2
    boxes = [[], []]
    nodes = [SplitNode(DagConfig(n, w), pncounter.SPEC, b, own,
                       send=boxes[1 - i].append, num_keys=4, num_writers=n)
             for i, own in enumerate(([1, 1, 0, 0], [0, 0, 1, 1]))]
    ops = {f: np.zeros((n, b), np.int32) for f in OP_FIELDS}
    ops["op"][:2] = pncounter.OP_INC
    ops["a0"][:] = 5
    ops["writer"][:] = np.arange(n)[:, None]
    before = kernels.launches()
    for node in nodes:
        node.start()
    boarded = False
    for _ in range(30):
        for i, node in enumerate(nodes):
            for data in boxes[i]:
                node.receive(data)
            boxes[i].clear()
            info = node.step(ops if i == 0 and not boarded else None)
            if i == 0 and info is not None:
                boarded = boarded or bool(info["accepted"][:2].all())
    assert boarded
    got = nodes[1].query_stable("get")[2:, 0].cpu().tolist()
    assert got == [2 * b * 5] * 2
    after = kernels.launches()
    assert after["dag_ingest"] > before["dag_ingest"]
    assert after["dag_round"] > before["dag_round"]
    assert all(node.stats["verified_bad"] == 0 for node in nodes)


@pytest.mark.cuda
def test_split_endpoints_run_on_the_card(cuda_device):
    """Two DAG-plane endpoints on the card: each step is one dag_ingest
    (when the inbox holds messages) and one dag_round launch, and both
    sides commit the same order."""
    from janus_tpu_torch.consensus import (DagConfig, commit_view,
                                           init_commit, ordered_blocks)
    from janus_tpu_torch.net.dagplane import SplitClusterEndpoint

    cfg = DagConfig(4, 8)
    boxes = [[], []]
    ends = [SplitClusterEndpoint(cfg, np.arange(4) // 2 == i,
                                 send=boxes[1 - i].append)
            for i in range(2)]
    before = kernels.launches()
    fed = 0  # steps whose inbox held messages
    for _ in range(20):
        for i, end in enumerate(ends):
            fed += bool(boxes[i])
            for data in boxes[i]:
                end.receive(data)
            boxes[i].clear()
            end.step()
    after = kernels.launches()
    assert after["dag_round"] - before["dag_round"] == 40
    assert after["dag_ingest"] - before["dag_ingest"] == fed > 20
    assert min(end.node_rounds().min() for end in ends) == 7
    orders = [ordered_blocks(cfg, commit_view(cfg, end.state,
                                              init_commit(cfg)), 2 * i)
              for i, end in enumerate(ends)]
    common = min(len(o) for o in orders)
    assert common > 0 and orders[0][:common] == orders[1][:common]


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
@pytest.mark.parametrize("geo", [(2, 64, 64, 2048, 4), (3, 7, 8, 300, 1),
                                 (2, 5, 16, 400, 32), (2, 20, 256, 1024, 8)],
                         ids=lambda g: "V{}K{}C{}B{}r{}".format(*g))
@pytest.mark.parametrize("case", workloads.ORSET_REPLAY_CASES)
def test_orset_replay_cases_match_plain(cuda_device, case, geo):
    """The replay's edge cases (``workloads.orset_replay_case``): a hot key
    past its bucket (gathered again into the spill), rows whose state does
    not ascend, a tag four times, the INT32_MAX tag, every record on
    negative keys, keys past the rows, rows filled exactly to C and one
    past it; capture widths 1 and 32."""
    v, k, c, b, r_cap = geo
    rng = np.random.default_rng(
        workloads.ORSET_REPLAY_CASES.index(case) * 7 + c)
    st, ops = (_on(x, cuda_device) for x in workloads.orset_replay_case(
        rng, case, (v, b), k, c, r_cap))
    before = kernels.orset_replay.launches
    got, drop = kernels.orset_replay(st, ops)
    ref, rdrop = kernels.orset_replay_plain(st, ops)
    torch.cuda.synchronize()
    assert kernels.orset_replay.launches == before + 1
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(drop, rdrop)
    if case == "exact_fill":
        assert int(rdrop.sum()) > 0


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


# (R, K, C, B): 64-slot rows on the 16-byte path (G 8) with a hot row past
# its bucket (walked at 2 slots a thread), path B's shape, a hot row past
# its bucket at C 256, and C 512 (S 16) with one; every case at each
ORSET_APPLY_GEOS = [(16, 50, 64, 300), (8, 500, 256, 64), (2, 20, 256, 400),
                    (4, 40, 512, 200)]
# rows past the warp walk (the block walk, off the main paths): three cases
ORSET_APPLY_GRID = [
    (case, geo) for geo in ORSET_APPLY_GEOS
    for case in workloads.ORSET_APPLY_CASES] + [
    (case, (2, 6, 600, 40)) for case in ("mixed", "hot_row", "int32_max")]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,geo", ORSET_APPLY_GRID,
    ids=["{}-R{}K{}C{}B{}".format(c, *g) for c, g in ORSET_APPLY_GRID])
def test_orset_apply_walk_cases_match_plain(cuda_device, case, geo):
    """The walk's edge cases (``workloads.orset_apply_case``): a hot row
    past its bucket, NOOP lanes canonicalising non-canonical rows,
    non-canonical rows no lane gathers (byte for byte), out-of-range keys
    on full clamped rows (drops, no write), the INT32_MAX tag, rows filled
    exactly to C and one add past it; at C 64 to 600."""
    r, k, c, b = geo
    rng = np.random.default_rng(31 * workloads.ORSET_APPLY_CASES.index(case)
                                + ORSET_APPLY_GRID.index((case, geo)))
    st, ops = workloads.orset_apply_case(rng, case, (r, b), k, c)
    st, ops = _on(st, cuda_device), _on(ops, cuda_device)
    ref, before_st = _clone(st), _clone(st)
    before = kernels.orset_apply.launches
    drop = kernels.orset_apply(st, ops)
    ref_drop = kernels.orset_apply_plain(ref, ops)
    torch.cuda.synchronize()
    assert kernels.orset_apply.launches == before + 1
    _assert_outputs_equal(st, ref)
    _assert_outputs_equal(drop, ref_drop)
    if case == "out_of_range_full":
        _assert_outputs_equal(st, before_st)
    if case == "untouched":
        half = max(k // 2, 1)
        _assert_outputs_equal({f: x[:, half:] for f, x in st.items()},
                              {f: x[:, half:] for f, x in before_st.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("r_cap", [1, 8])
@pytest.mark.parametrize("case", ["mixed", "out_of_range_full", "int32_max",
                                  "noop_noncanonical"])
def test_orset_apply_captured_cases_match_plain(cuda_device, case, r_cap):
    """The captured mode (the block walk over the listed groups) at one
    lane a replica and at four, on the walk's edge cases."""
    for r, k, c, b in ((12, 6, 8, 1), (64, 50, 256, 1), (5, 4, 8, 4)):
        rng = np.random.default_rng(r_cap + c + b)
        st, ops = workloads.orset_apply_case(rng, case, (r, b), k, c,
                                             r_cap=r_cap)
        st, ops = _on(st, cuda_device), _on(ops, cuda_device)
        ref = _clone(st)
        drop = kernels.orset_apply(st, ops)
        ref_drop = kernels.orset_apply_plain(ref, ops)
        torch.cuda.synchronize()
        _assert_outputs_equal(st, ref)
        _assert_outputs_equal(drop, ref_drop)


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
        kernels.slot_union(*(_slots(rng, (1,), 7000, cuda_device)
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
@pytest.mark.parametrize("c", [16, 300, 1024])
@pytest.mark.parametrize("case", workloads.RGA_COMPACT_CASES)
def test_rga_compact_edge_cases_match_plain(cuda_device, case, c):
    """The compaction's edge cases of ``workloads.rga_compact_case``
    (sorted rows searched, rows with a descent or a hole sorted; duplicate,
    SENTINEL, self and absent parents; dead chains) at 64 rows, with and
    without protect, fresh and in place."""
    rng = np.random.default_rng(c + len(case))
    rows, prot = workloads.rga_compact_case(rng, case, (64,), c)
    rows = _on(rows, cuda_device)
    prot = torch.as_tensor(prot, device=cuda_device)
    before = kernels.rga_compact.launches
    for p in (None, prot):
        got = kernels.rga_compact(rows, p)
        ref = kernels.rga_compact_plain(rows, p)
        inplace = _clone(rows)
        kernels.rga_compact(inplace, p, out=inplace)
        torch.cuda.synchronize()
        _assert_outputs_equal(got, ref)
        _assert_outputs_equal(inplace, ref)
    assert kernels.rga_compact.launches == before + 4
    empty = {f: x[:0] for f, x in rows.items()}
    _assert_outputs_equal(kernels.rga_compact(empty, prot[:0]), empty)


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
    with pytest.raises(ValueError, match="shared memory"):  # > 9,128 records
        kernels.rga_union(*(_rga_rows(rng, (1,), 4600, cuda_device)
                            for _ in range(2)))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.rga_order(_rga_rows(rng, (1,), 4096, cuda_device), 32)
    with pytest.raises(ValueError):
        kernels.rga_order({f: x[0] for f, x in st.items()}, 0)
    assert kernels.launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", workloads.RGA_UNION_CASES)
def test_rga_union_merge_matches_plain(cuda_device, case):
    """The merge of sorted rows (the RGA instantiation of slot_union.cu)
    on every edge case of ``workloads.rga_union_case`` at C = 1,024:
    fresh outputs at a capacity below, at and above one row's, ``out`` of
    two planes, ``out`` aliasing ``a``, and rows of unequal widths."""
    rng = np.random.default_rng(len(case))
    c = 1024
    a, b = (_on(x, cuda_device) for x in
            workloads.rga_union_case(rng, case, (48,), c))
    before = kernels.rga_union.launches
    for cap in (600, c, 2500):
        got, ovf = kernels.rga_union(a, b, cap)
        ref, ref_ovf = kernels.rga_union_plain(a, b, cap)
        _assert_outputs_equal(got, ref)
        _assert_outputs_equal(ovf, ref_ovf)
    ref, ref_ovf = kernels.rga_union_plain(a, b, c)
    out = {f: torch.full((2, 48, c), 7, dtype=x.dtype, device=cuda_device)
           for f, x in a.items()}
    _, ovf = kernels.rga_union(a, b, c, out=out)
    for f in ref:
        assert torch.equal(out[f], ref[f].expand_as(out[f])), f
    _assert_outputs_equal(ovf, ref_ovf)
    alias = _clone(a)
    kernels.rga_union(alias, b, c, out={f: x.unsqueeze(0)
                                        for f, x in alias.items()})
    _assert_outputs_equal(alias, ref)
    narrow = {f: x[:, :300].contiguous() for f, x in b.items()}
    got, ovf = kernels.rga_union(a, narrow, 700)
    ref, ref_ovf = kernels.rga_union_plain(a, narrow, 700)
    torch.cuda.synchronize()
    assert kernels.rga_union.launches == before + 6
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(ovf, ref_ovf)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("case", workloads.RGA_UNION_CASES)
def test_rga_union_rows_merge_matches_plain(cuda_device, case, r):
    """The row-list mode of the merge on the edge cases at C = 1,024, K =
    16 document rows of r replicas, with 0, 1 and K rows listed: the
    converge's row-list tree through the kernel against the same tree of
    plain versions."""
    from janus_tpu_torch.models import rga

    rng = np.random.default_rng(len(case) + r)
    k, c = 16, 1024
    a, b = workloads.rga_union_case(rng, case, (k,), c)
    a2, _ = workloads.rga_union_case(rng, case, (k,), c)
    st = _on({f: np.stack([x[f] for x in (a, b, a2)[:r]]) for f in rga.FIELDS},
             cuda_device)
    st["ctr_floor"] = torch.zeros((r, k), dtype=torch.int32, device=cuda_device)
    st["_depth"] = torch.zeros((r, 8, 0), dtype=torch.int32, device=cuda_device)
    rows = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(cuda_device)
    for n_rows in (0, 1, k):
        n = torch.tensor(n_rows, dtype=torch.int32, device=cuda_device)
        mine, ref = _clone(st), _clone(st)
        before = kernels.rga_union_rows.launches
        rga.join_replica_rows(mine, rows, n)
        real = (kernels.rga_union_rows, kernels.replica_join_rows)
        kernels.rga_union_rows = kernels.rga_union_rows_plain
        kernels.replica_join_rows = kernels.replica_join_rows_plain
        try:
            rga.join_replica_rows(ref, rows, n)
        finally:
            kernels.rga_union_rows, kernels.replica_join_rows = real
        torch.cuda.synchronize()
        assert kernels.rga_union_rows.launches == before + (r - 1)
        _assert_outputs_equal(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [
    (4, 100, 64, 8192, 4), (2, 6, 16, 300, 4), (1, 5, 8, 257, 32),
    (3, 4, 24, 96, 1), (1, 7, 8, 16384, 2)],
    ids=lambda g: "V{}K{}C{}B{}r{}".format(*g))
@pytest.mark.parametrize("case", workloads.ORSET_CAPTURE_CASES)
def test_orset_capture_edge_cases_match_plain(cuda_device, case, geo):
    """The capture's edge cases (``workloads.orset_capture_case``: long
    walks of a hot key, buckets that need their sort, aliased keys, tags
    repeated between the row and the batch, non-canonical rows) at the
    consensus path's shape, at B past and not a multiple of one tile, at
    r_cap 1 and 32 (> C), and at B = 16,384 in one view."""
    v, k, c, b, r_cap = geo
    rng = np.random.default_rng(len(case) + b)
    st, ops = (_on(x, cuda_device) for x in
               workloads.orset_capture_case(rng, case, (v, b), k, c))
    before = kernels.orset_capture.launches
    got = kernels.orset_capture(st, ops, r_cap)
    ref = kernels.orset_capture_plain(st, ops, r_cap)
    torch.cuda.synchronize()
    assert kernels.orset_capture.launches == before + 1
    _assert_outputs_equal(list(got), list(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("case", workloads.ORSET_UNION_CASES)
def test_orset_union_merge_matches_plain(cuda_device, case):
    """The warp merge of sorted rows (the OR-Set instantiation of
    slot_union.cu) on every edge case of ``workloads.orset_union_case`` at
    the store's C = 256: fresh outputs at a capacity below, at and above
    one row's, ``out`` of two planes (the broadcast's block merge),
    ``out`` aliasing ``a``, and rows of unequal widths."""
    rng = np.random.default_rng(len(case))
    c = 256
    a, b = (_on(x, cuda_device) for x in
            workloads.orset_union_case(rng, case, (48,), c))
    before = kernels.slot_union.launches
    for cap in (150, c, 600):
        got, ovf = kernels.slot_union(a, b, cap)
        ref, ref_ovf = kernels.slot_union_plain(a, b, cap)
        _assert_outputs_equal(got, ref)
        _assert_outputs_equal(ovf, ref_ovf)
    ref, ref_ovf = kernels.slot_union_plain(a, b, c)
    out = {f: torch.full((2, 48, c), 7, dtype=x.dtype, device=cuda_device)
           for f, x in a.items()}
    _, ovf = kernels.slot_union(a, b, c, out=out)
    for f in ref:
        assert torch.equal(out[f], ref[f].expand_as(out[f])), f
    _assert_outputs_equal(ovf, ref_ovf)
    alias = _clone(a)
    kernels.slot_union(alias, b, c, out={f: x.unsqueeze(0)
                                         for f, x in alias.items()})
    _assert_outputs_equal(alias, ref)
    narrow = {f: x[:, :100].contiguous() for f, x in b.items()}
    got, ovf = kernels.slot_union(a, narrow, 300)
    ref, ref_ovf = kernels.slot_union_plain(a, narrow, 300)
    torch.cuda.synchronize()
    assert kernels.slot_union.launches == before + 6
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(ovf, ref_ovf)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 5])
@pytest.mark.parametrize("case", workloads.ORSET_UNION_CASES)
def test_orset_union_rows_merge_matches_plain(cuda_device, case, r):
    """The row-list mode of the warp merge on the edge cases at C = 256,
    K = 16 key rows of r replicas, with 0, 1 and K rows listed: the
    converge's row-list tree through the kernel against the same tree of
    plain versions (r = 2: one level that writes the rows it read; r = 3
    and 5: scratch levels, then the broadcast into every replica)."""
    from janus_tpu_torch.models import orset

    rng = np.random.default_rng(len(case) + r)
    k, c = 16, 256
    draws = [workloads.orset_union_case(rng, case, (k,), c)
             for _ in range((r + 1) // 2)]
    rows_of = [x for pair in draws for x in pair][:r]
    st = _on({f: np.stack([x[f] for x in rows_of]) for f in ORSET_FIELDS},
             cuda_device)
    st["_rm_cap"] = torch.zeros((r, 4, 0), dtype=torch.int32,
                                device=cuda_device)
    rows = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(cuda_device)
    for n_rows in (0, 1, k):
        n = torch.tensor(n_rows, dtype=torch.int32, device=cuda_device)
        mine, ref = _clone(st), _clone(st)
        before = kernels.slot_union_rows.launches
        orset.join_replica_rows(mine, rows, n)
        real = kernels.slot_union_rows
        kernels.slot_union_rows = kernels.slot_union_rows_plain
        try:
            orset.join_replica_rows(ref, rows, n)
        finally:
            kernels.slot_union_rows = real
        torch.cuda.synchronize()
        assert kernels.slot_union_rows.launches == before + (r - 1).bit_length()
        _assert_outputs_equal(mine, ref)

@pytest.mark.cuda
def test_dirty_rows_lean_path_refuses_what_it_did(cuda_device):
    """The lean launch path raises on every malformed operand: a wrong
    dtype, a strided tensor, a shape mismatch, tensors on two devices;
    and launches nothing for them."""
    rng = np.random.default_rng(5)
    r, k, b = 4, 50, 33
    op = torch.from_numpy(rng.integers(0, 3, (r, b)).astype(np.int32)).to(cuda_device)
    key = torch.from_numpy(rng.integers(-k, 2 * k, (r, b)).astype(np.int32)).to(cuda_device)
    out = torch.zeros((r, k), dtype=torch.bool, device=cuda_device)
    before = kernels.dirty_rows.launches
    bad = [((op.long(), key, k), {}, "int32"),
           ((op, key.to(torch.int16), k), {}, "int32"),
           ((op, key, k), {"out": out.to(torch.uint8)}, "bool"),
           ((op, torch.cat([key, key], 1)[:, ::2], k), {}, "strided"),
           ((op, key, k), {"out": torch.zeros((k, r), dtype=torch.bool,
                                              device=cuda_device).t()},
            "strided"),
           ((op, key[:, :-1].contiguous(), k), {}, "shape"),
           ((op, key, k + 1), {"out": out}, "shape"),
           ((op[:2], key, k), {}, "shape"),
           ((op, key.cpu(), k), {}, "one CUDA device"),
           ((op.cpu(), key.cpu(), k), {"out": out}, "one CUDA device")]
    for args, kw, what in bad:
        with pytest.raises(ValueError, match="dirty_rows"):
            kernels.dirty_rows(*args, **kw)
    assert kernels.dirty_rows.launches == before
    # well-formed operands, the hazard keys in [-K, 2K): equal to plain
    mine = kernels.dirty_rows(op, key, k, out=out.clone())
    ref = kernels.dirty_rows_plain(op, key, k, out=out.clone())
    torch.cuda.synchronize()
    assert kernels.dirty_rows.launches == before + 1
    assert torch.equal(mine, ref)


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
@pytest.mark.parametrize("n,w,budget,b,width,nfields,seq", [
    (64, 16, 1024, 3, 0, 6, "none"),      # W*N = 1,024, A = W*N
    (64, 16, 1, 3, 0, 6, "wrap"),         # A = 1, commit keys that wrap
    (4, 8, 32, 5, 3, 9, "none"),          # rows of 20 and 60 bytes
    (7, 6, 9, 3, 1, 16, "wrap"),          # 16 fields
    (16, 8, 40, 4097, 2, 7, "plain"),     # rows of several gather slices
])
def test_block_select_edges_match_plain(cuda_device, n, w, budget, b, width,
                                        nfields, seq):
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(n + w + budget + nfields)
    cfg = DagConfig(n, w)
    dev = cuda_device
    d, _, _ = workloads.consensus_state(rng, n, w, wrap=True)
    sr = torch.as_tensor(d["slot_round"], device=dev)
    base = torch.as_tensor(d["base_round"], device=dev)
    tail = (b, width) if width else (b,)
    ring = {"op": torch.as_tensor(_rand(rng, (w, n, b), -5, 50), device=dev)}
    for i in range(nfields - 1):
        ring[f"f{i}"] = torch.as_tensor(_rand(rng, (w, n) + tail), device=dev)
    for _ in range(3):
        ready = torch.as_tensor(rng.random((n, w, n)) < 0.7, device=dev)
        applied = torch.as_tensor(rng.random((n, w, n)) < 0.2, device=dev)
        keys = None
        if seq != "none":
            hi = 2**31 // (w * n) + (50 if seq == "wrap" else -1)
            keys = torch.as_tensor(_rand(rng, (n, w, n), 0, hi), device=dev)
        before = kernels.block_select.launches
        _kernel_vs_plain(kernels.block_select, kernels.block_select_plain,
                         (cfg, ring, ready, applied, budget, sr, base, keys))
        assert kernels.block_select.launches == before + 1


@pytest.mark.cuda
def test_block_select_ring_replaced_and_outputs_apart(cuda_device):
    """The wrapper's cached ring table follows a ring replaced by
    ``ring_resize`` (as ``SafeKV.resize_block`` replaces it) and one
    allocated where a freed ring lay; and the outputs, views of one
    buffer, are apart: a write into one field leaves the others as they
    were."""
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(5)
    n, w, b = 4, 8, 6
    cfg = DagConfig(n, w)
    dev = cuda_device
    d, _, _ = workloads.consensus_state(rng, n, w, wrap=False)
    sr = torch.as_tensor(d["slot_round"], device=dev)
    base = torch.as_tensor(d["base_round"], device=dev)

    def inputs():
        return (torch.as_tensor(rng.random((n, w, n)) < 0.8, device=dev),
                torch.as_tensor(rng.random((n, w, n)) < 0.1, device=dev))

    ring = _ring(rng, n, w, b, 4, dev)
    for step in range(4):
        ready, applied = inputs()
        _kernel_vs_plain(kernels.block_select, kernels.block_select_plain,
                         (cfg, ring, ready, applied, 9, sr, base, None))
        if step == 0:  # shrunk, then grown back, as resize_block does
            ring, _ = kernels.ring_resize(ring, 3)
        elif step == 1:
            ring, _ = kernels.ring_resize(ring, 7)
        elif step == 2:  # freed, and a ring of the same shape in its place
            shape = {f: x.shape for f, x in ring.items()}
            del ring
            ring = {f: torch.as_tensor(_rand(rng, tuple(s)), device=dev)
                    for f, s in shape.items()}
    ready, applied = inputs()
    batch, idx, chosen = kernels.block_select(cfg, ring, ready, applied, 9,
                                              sr, base, None)
    want = (_clone(batch), idx.clone(), chosen.clone())
    batch["key"].fill_(-7)
    batch["op"][:, -1] = 99
    torch.cuda.synchronize()
    for f in batch:
        if f not in ("key", "op"):
            assert torch.equal(batch[f], want[0][f])
    assert torch.equal(batch["op"][:, :-1], want[0]["op"][:, :-1])
    assert torch.equal(idx, want[1]) and torch.equal(chosen, want[2])


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
                                      (64, 8, True), (64, 16, False),
                                      (16, 8, True), (16, 8, False),
                                      (16, 32, True), (16, 32, False),
                                      (64, 32, True), (64, 32, False)])
def test_gc_frontier_matches_plain(cuda_device, n, w, logs):
    """The GC with the ring cleared in the same call (its second
    kernel), on rings of 4-byte and 16-byte rows with and without
    extras and on a ring of no fields, at states whose frontier advances
    by one slot or several, at the card's W 32 limit too."""
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
        pre = torch.as_tensor(_rand(rng, (n,), -9, 99), device=dev)
        acc = torch.as_tensor(rng.random(n) < 0.7, device=dev)
        moved = torch.as_tensor(rng.random(n) < 0.2, device=dev)
        donor = torch.as_tensor(np.int32(rng.integers(0, n)), device=dev)
        ring = ({} if i == 7 else
                _ring(rng, n, w, (37, 64, 5)[i % 3], (0, 4)[i % 2], dev))
        count = kernels.gc_frontier.launches
        _, dead, _ = _kernel_vs_plain(
            kernels.gc_frontier, kernels.gc_round_plain,
            (cfg, dag, com, before, pa, sa, bf, pre, acc, moved, donor, drops,
             logs, ring))
        assert kernels.gc_frontier.launches == count + 1
        advanced += int(dead.sum()) >= 2
    assert advanced > 0


@pytest.mark.cuda
def test_safekv_submit_odd_views_and_replaced_ring(cuda_device):
    """The accept on batch fields that are views at odd int32 offsets of
    larger tensors (no field 16-byte aligned), at B not a multiple of 4,
    and the board into a ring the wrapper's cached table must follow:
    replaced by ``ring_resize`` (as ``SafeKV.resize_block`` replaces it)
    and reallocated where a freed ring lay; both bit-equal to the plain
    versions."""
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(20)
    n, w = 16, 8
    cfg = DagConfig(n, w)
    dev = cuda_device
    ring = _ring(rng, n, w, 37, 4, dev)
    for step in range(4):
        b = ring["op"].shape[2]
        d, _, _ = workloads.consensus_state(rng, n, w, wrap=step % 2 == 1)
        dag = {f: torch.as_tensor(v, device=dev) for f, v in d.items()}
        filled = torch.as_tensor(rng.random((w, n)) < 0.3, device=dev)
        ops = {}
        for k, f in enumerate(OP_FIELDS):
            whole = torch.as_tensor(_rand(rng, (n * b + 2 * k + 3,)),
                                    device=dev)
            ops[f] = whole[2 * k + 1:2 * k + 1 + n * b].view(n, b)
        acc_ops, accepted, pre = _kernel_vs_plain(
            kernels.safekv_submit, kernels.safekv_submit_plain,
            (cfg, dag, filled, ops, None))
        captured = {f: acc_ops[f] if f in acc_ops else
                    torch.as_tensor(_rand(rng, x.shape[1:]), device=dev)
                    for f, x in ring.items()}
        applied = torch.as_tensor(rng.random((n, w, n)) < 0.3, device=dev)
        _kernel_vs_plain(kernels.safekv_board, kernels.safekv_board_plain,
                         (cfg, ring, filled, applied, captured, accepted,
                          pre))
        # the board writes in place: the ring the wrapper wrote is this one
        want = _clone(ring)
        kernels.safekv_board_plain(cfg, want, filled.clone(), applied.clone(),
                                   captured, accepted, pre)
        kernels.safekv_board(cfg, ring, filled.clone(), applied.clone(),
                             captured, accepted, pre)
        torch.cuda.synchronize()
        _same(ring, want)
        if step == 0:  # shrunk to an odd B, then grown, as resize_block does
            ring, _ = kernels.ring_resize(ring, 29)
        elif step == 1:
            ring, _ = kernels.ring_resize(ring, 64)
        elif step == 2:  # freed, and a ring of the same shape in its place
            shape = {f: x.shape for f, x in ring.items()}
            del ring
            ring = {f: torch.as_tensor(_rand(rng, tuple(s)), device=dev)
                    for f, s in shape.items()}
    assert ring["op"].shape[2] == 64


@pytest.mark.cuda
def test_safekv_pairs_launch_at_most_two_kernels(cuda_device):
    """The kernel nodes of a CUDA graph captured from one call (the
    kernels line's ``max_cuda_launches`` check): the accept and the board
    one each, the GC with its ring clear two."""
    import chip_smoke
    from janus_tpu_torch.consensus import DagConfig

    rng = np.random.default_rng(21)
    n, w, b = 16, 8, 100
    cfg = DagConfig(n, w)
    dev = cuda_device
    d, _, _ = workloads.consensus_state(rng, n, w, wrap=False)
    dag = {f: torch.as_tensor(v, device=dev) for f, v in d.items()}
    filled = torch.as_tensor(rng.random((w, n)) < 0.3, device=dev)
    ops = {f: torch.as_tensor(_rand(rng, (n, b)), device=dev)
           for f in OP_FIELDS}
    acc_ops, accepted, pre = kernels.safekv_submit(cfg, dag, filled, ops)
    ring = _ring(rng, n, w, b, 0, dev)
    applied = torch.zeros((n, w, n), dtype=torch.bool, device=dev)
    assert chip_smoke.graph_kernels(
        lambda: kernels.safekv_submit(cfg, dag, filled, ops)) == 1
    assert chip_smoke.graph_kernels(lambda: kernels.safekv_board(
        cfg, ring, filled, applied, acc_ops, accepted, pre)) == 1
    gdag, com, before, pa, sa, bf = (
        {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
        if isinstance(x, dict) else torch.as_tensor(x, device=dev)
        for x in workloads.gc_state(rng, n, w))
    args = (cfg, gdag, com, before, pa, sa, bf, pre, accepted,
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev), (None, None), True)
    assert chip_smoke.graph_kernels(
        lambda: kernels.gc_frontier(*args, ops_buffer=ring)) == 2


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


# -- the GC fences and the RGA's single-op capture ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lead,c,n_ring,adds", [
    ((2, 4, 6), 8, 160, True), ((2, 16, 1000), 64, 655360, True),
    ((3, 5), 300, 40, False), ((2, 7), 5, 1, True)])
def test_orset_compact_matches_plain(cuda_device, lead, c, n_ring, adds):
    """The watermark over rings with and without a live add (one lane, and
    preset orset's 655,360), and the compaction behind it, with and
    without a protect mask, fresh and in place, on random rows (full and
    non-canonical ones, tombstoned tags at SENTINEL)."""
    rng = np.random.default_rng(c + n_ring)
    rows = _slots(rng, lead, c, cuda_device, canonical=False, full_rows=0.4)
    rows["tag_ctr"][..., 0] = torch.where(
        rows["valid"][..., 0], INT32_MAX, rows["tag_ctr"][..., 0])
    op = rng.integers(0, 4, n_ring) if adds else rng.integers(2, 4, n_ring)
    ring = {"op": torch.as_tensor(op.astype(np.int32), device=cuda_device),
            "a2": torch.as_tensor(_rand(rng, (n_ring,), 0, 2 * c),
                                  device=cuda_device)}
    before = kernels.orset_compact.launches
    wm = kernels.orset_watermark(ring["op"], ring["a2"])
    ref_wm = kernels.orset_watermark_plain(ring["op"], ring["a2"])
    prot = torch.as_tensor(rng.random(lead + (c,)) < 0.2, device=cuda_device)
    for w, p in ((wm, None), (None, prot), (wm, prot), (None, None)):
        got = kernels.orset_compact(rows, w, p)
        ref = kernels.orset_compact_plain(rows, w, p)
        inplace = _clone(rows)
        kernels.orset_compact(inplace, w, p, out=inplace)
        torch.cuda.synchronize()
        _assert_outputs_equal(got, ref)
        _assert_outputs_equal(inplace, ref)
    assert torch.equal(wm, ref_wm)
    assert (int(wm[0]) == INT32_MAX) == (not bool((ring["op"] == 1).any()))
    assert kernels.orset_compact.launches == before + 9


# the fence's cases: (rows, ring) of workloads.orset_slots keywords and a
# ring kind; and the state shapes at C 5 (a lane a slot), 64 (the main
# path's rows) and 300 (rows staged in shared memory)
FENCE_CASES = {
    "mixed": (dict(canonical=False, full_rows=0.4), "adds"),
    "nothing_drops": (dict(canonical=True, removed=0.0), "adds"),
    "all_drop": (dict(canonical=True, full_rows=1.0, removed=1.0),
                 "removes"),
    "empty_ring": (dict(canonical=False, full_rows=0.4), "empty"),
    "all_remove_ring": (dict(canonical=True, full_rows=0.5), "removes"),
}
FENCE_SHAPES = [((2, 7), 5), ((4, 100), 64), ((3, 5), 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FENCE_CASES))
@pytest.mark.parametrize("lead,c", FENCE_SHAPES)
def test_orset_compact_fences_matches_plain(cuda_device, case, lead, c):
    """One GC advance over two states (the fused call, in place, one
    count and two CUDA kernels) against the plain watermark and two plain
    compactions; and each state alone through the watermark and
    ``orset_compact``, fresh and in place (a fresh output gets every row,
    in place only changed rows are written)."""
    import chip_smoke

    rng = np.random.default_rng(c + len(case))
    kw, ring_kind = FENCE_CASES[case]
    states = tuple(_slots(rng, lead, c, cuda_device, **kw) for _ in range(2))
    n_ring = {"adds": 4 * c + 3, "removes": 4 * c + 3, "empty": 0}[ring_kind]
    op = (rng.integers(0, 4, n_ring) if ring_kind == "adds"
          else np.full(n_ring, 2))
    ring = (torch.as_tensor(op.astype(np.int32), device=cuda_device),
            torch.as_tensor(_rand(rng, (n_ring,), 0, 2 * c),
                            device=cuda_device))
    ref = kernels.orset_compact_fences_plain(_clone(states), *ring)
    before = kernels.orset_compact.launches
    got = kernels.orset_compact_fences(_clone(states), *ring)
    torch.cuda.synchronize()
    assert kernels.orset_compact.launches == before + 1
    for g, r in zip(got, ref, strict=True):
        _assert_outputs_equal(g, r)
    wm = kernels.orset_watermark(*ring)
    for st, r in zip(states, ref):
        _assert_outputs_equal(kernels.orset_compact(st, wm), r)
        inplace = _clone(st)
        kernels.orset_compact(inplace, wm, out=inplace)
        torch.cuda.synchronize()
        _assert_outputs_equal(inplace, r)
    assert kernels.orset_compact.launches == before + 6
    if case == "nothing_drops":  # canonical rows that keep every slot
        for st, r in zip(states, ref):
            _assert_outputs_equal(st, r)
    if case == "all_drop":
        assert not any(bool(r["valid"].any()) for r in ref)
    mine = _clone(states)
    assert chip_smoke.graph_kernels(
        lambda: kernels.orset_compact_fences(mine, *ring)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c,b,full", [
    (3, 5, 8, 40, 0.25), (4, 3, 6, 300, 1.0), (4, 128, 1024, 1024, 0.0),
    (5, 2, 4, 24, 0.5)])
def test_rga_capture_matches_plain(cuda_device, r, k, c, b, full):
    """The capture mode of rga_apply.cu against its plain version: each
    lane's minted counter (inserts into full rows included), the state,
    the drops; keys in [-K, 2K), every op code, one document hammered,
    Lamport floors at INT32_MAX (the mint wraps); and at the rga_consensus
    geometry's submit (4 views, 128 documents of 1,024 slots, 1,024
    lanes)."""
    rng = np.random.default_rng(r * b + c)
    st = _rga_state(rng, r, k, c, cuda_device, full_rows=full)
    st["ctr_floor"][:, ::2] = INT32_MAX
    ops = _on(workloads.rga_mixed_ops(rng, (r, b), k, c), cuda_device)
    ops["key"][:, : b // 4] = 1
    ref = _clone(st)
    before = kernels.rga_capture.launches
    eff, drop = kernels.rga_capture(st, ops)
    ref_eff, ref_drop = kernels.rga_capture_plain(ref, ops)
    torch.cuda.synchronize()
    assert kernels.rga_capture.launches == before + 1
    _assert_outputs_equal(eff, ref_eff)
    _assert_outputs_equal(drop, ref_drop)
    _assert_outputs_equal(st, ref)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _kernel_vs_host_plain(fn, plain, args):
    """The wrapper on the card and its plain version on host copies of the
    same inputs (a walk of thousands of small steps is quicker there):
    outputs and in-place updates bit-equal."""
    mine, ref = _clone(args), _host(args)
    out = fn(*mine)
    want = plain(*ref)
    torch.cuda.synchronize()
    _same((mine, out), (ref, want))
    return out


def _walk_case(case, mode, v, k, c, block, dev):
    rng = np.random.default_rng(17 + workloads.RGA_WALK_CASES.index(case))
    st, ops = workloads.rga_walk_case(rng, case, v, k, c, block)
    if mode != "captured":
        ops = {f: x for f, x in ops.items() if f != "eff_ctr"}
    return _on(st, dev), _on(ops, dev)


def _walk_vs_plain(mode, st, ops):
    fn = kernels.rga_capture if mode == "capture" else kernels.rga_apply
    plain = (kernels.rga_capture_plain if mode == "capture"
             else kernels.rga_apply_plain)
    before = fn.launches
    out = _kernel_vs_host_plain(fn, plain, (st, ops))
    assert fn.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case", workloads.RGA_WALK_CASES)
def test_rga_walk_cases_match_plain(cuda_device, case, mode):
    """The walk's edge cases (``workloads.rga_walk_case``) through
    rga_apply (uncaptured and captured) and rga_capture against their
    plain versions, bit-equal: 4 views of 32 rows of 256 slots, 16 blocks
    of 64 lanes a view, three quarters of them no-ops at key
    0 or at applied keys; negative floors behind in-range no-ops on full
    rows of negative counters; rows only no-ops touch; keys in [-K, 2K)
    with codes -1 to 5; a row of ~340 live lanes, past its bucket of 128,
    walked from the op fields."""
    st, ops = _walk_case(case, mode, 4, 32, 256, 64, cuda_device)
    _walk_vs_plain(mode, st, ops)


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True])
def test_rga_apply_at_replay_geometry_matches_plain(cuda_device, captured):
    """The rga preset's geometry, a slice of its replicas (buckets of 32
    lanes): 64 replicas of 128 documents of 1,024 slots, tick 3 of
    ``rga_text_replay`` (16 inserts and 16 deletes a replica, ids of
    earlier ticks, so deletes of absent ids land placeholders)."""
    r, k, c = 64, 128, 1024
    rng = np.random.default_rng(11)
    st = _rga_state(rng, r, k, c, cuda_device, full_rows=0.02)
    st.pop("_depth")
    ops = workloads.rga_text_replay(np.random.default_rng(0), r, k, 16, 2, 3)
    if captured:
        ops["eff_ctr"] = rng.integers(1, c, ops["op"].shape + (1,)).astype(
            np.int32)
    _walk_vs_plain("captured" if captured else "apply", st,
                   _on(ops, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("m,t,span", [(700, 90, 4), (0, 5, 4), (9, 0, 4),
                                       (524288, 65536, 1 << 20),
                                       (5000, 9000, 30)])
def test_mark_members_matches_plain(cuda_device, m, t, span):
    """Membership against the plain version: duplicates on both sides,
    masked queries, keys at SENTINEL and SENTINEL - 1, queries past one
    chunk, M = 0 and T = 0; and the rga_consensus fence's sizes."""
    rng = np.random.default_rng(m + t)

    def keys(n):
        k = _rand(rng, (2, n), -span, span)
        hot = rng.random((2, n)) < 0.05
        return np.where(hot, INT32_MAX - rng.integers(0, 2, (2, n)),
                        k).astype(np.int32)

    a, b = keys(m), keys(t)
    valid = rng.random(t) < 0.7
    dev = [torch.as_tensor(x, device=cuda_device) for x in (*a, *b, valid)]
    before = kernels.mark_members.launches
    got = kernels.mark_members(dev[:2], dev[2:4], dev[4])
    ref = kernels.mark_members_plain(dev[:2], dev[2:4], dev[4])
    torch.cuda.synchronize()
    _assert_outputs_equal(got, ref)
    assert kernels.mark_members.launches == before + (m > 0 and t > 0)


@pytest.mark.cuda
def test_rga_safekv_on_card_matches_cpu(cuda_device):
    """The RGA through SafeKV (the rga_consensus phase's churn at N=4,
    W=8, 4 documents of 64 slots, B=8): the packed output and every device
    tensor bit-equal between the card and the CPU, round by round, through
    GC advances and compactions."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime import safecrdt

    n, w, k, c, b = 4, 8, 4, 64, 8
    kvs = {d: safecrdt.SafeKV(DagConfig(n, w), rga.SPEC, ops_per_block=b,
                              device=d, num_keys=k, capacity=c, max_depth=8)
           for d in (cuda_device, torch.device("cpu"))}
    minted = {}
    for t in range(16):
        ops = workloads.rga_churn(n, b, k, t, minted)
        packed = {}
        for d, kv in kvs.items():
            packed[d.type], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, d))
            info = kv.step_absorb(packed[d.type], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"]), t
        st = {d.type: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for d, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
        ring = st["cpu"]["ops_buffer"]["eff_ctr"]
        minted[t] = np.stack([ring[s, v, : b // 2, 0]
                              for v, s in enumerate(info["slot"])])
    stats = kvs[cuda_device].stats
    assert stats == kvs[torch.device("cpu")].stats
    assert stats["compactions"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c,r_cap,b", [
    (5, 4, 8, 3, 1), (3, 6, 16, 16, 1), (4, 3, 4, 6, 4), (64, 50, 256, 8, 1)])
def test_orset_apply_captured_mode_matches_plain(cuda_device, r, k, c, r_cap,
                                                 b):
    """orset_apply's captured mode (JAX's one-lane captured scan) against
    its plain version: captured tags into full and non-canonical rows, a
    tag captured twice, SENTINEL lanes, keys in [-K, 2K)."""
    rng = np.random.default_rng(r + c + b)
    st = _slots(rng, (r, k), c, cuda_device, canonical=False, dup_rows=0.3,
                full_rows=0.5)
    ops = workloads.orset_mixed_ops(rng, (r, b), k, c)
    shape = (r, b, r_cap)
    ops["rm_rep"] = np.where(rng.random(shape) < 0.1, INT32_MAX,
                             rng.integers(0, 4, shape)).astype(np.int32)
    ops["rm_ctr"] = rng.integers(1, c + 2, shape).astype(np.int32)
    ops["rm_elem"] = rng.integers(0, 8, shape).astype(np.int32)
    if r_cap > 1:
        for f in ("rm_rep", "rm_ctr", "rm_elem"):
            ops[f][..., 1] = ops[f][..., 0]
    dops = _on(ops, cuda_device)
    ref = _clone(st)
    before = kernels.orset_apply.launches
    drop = kernels.orset_apply(st, dops)
    ref_drop = kernels.orset_apply_plain(ref, dops)
    torch.cuda.synchronize()
    assert kernels.orset_apply.launches == before + 1
    _assert_outputs_equal(st, ref)
    _assert_outputs_equal(drop, ref_drop)


@pytest.mark.cuda
def test_orset_safekv_one_op_blocks_on_card_matches_cpu(cuda_device):
    """The OR-Set through SafeKV with one-op blocks: each submit applies a
    one-lane captured batch at its origin (orset_apply's captured mode);
    the packed output and every device tensor bit-equal between the card
    and the CPU, round by round."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime import safecrdt
    from janus_tpu_torch.utils.ids import TagMinter

    n, w, k = 4, 8, 3
    rng = np.random.default_rng(11)
    minters = [TagMinter(i) for i in range(n)]
    kvs = {d: safecrdt.SafeKV(DagConfig(n, w), orset.SPEC, ops_per_block=1,
                              device=d, num_keys=k, capacity=8,
                              rm_capacity=3)
           for d in (cuda_device, torch.device("cpu"))}
    for t in range(16):
        ops = workloads.orset_add_remove(rng, minters, k, 1)
        packed = {}
        for d, kv in kvs.items():
            packed[d.type], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, d))
            kv.step_absorb(packed[d.type], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"]), t
        st = {d.type: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for d, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
    assert kvs[cuda_device].stats["compactions"] > 0


# -- the LWW-Set and the MVRegister -----------------------------------------

def _lww_rows(rng, shape, c, dev, **kw):
    return _on(workloads.lww_slots(rng, shape, c, **kw), dev)


def _mvr_rows(rng, shape, v, w, dev, **kw):
    return _on(workloads.mvr_slots(rng, shape, v, w, **kw), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,lead,ca,cb,canonical", [
    ("orset", (3, 5), 6, 6, False), ("orset", (2, 50), 256, 256, True),
    ("rga", (3, 5), 6, 6, False), ("rga", (2, 8), 1024, 1024, True)])
def test_slot_union_layouts_unchanged_by_the_lww_template(cuda_device, layout,
                                                          lead, ca, cb,
                                                          canonical):
    """The OR-Set's and the RGA's instantiations of slot_union.cu, after
    the key count and the flag became template parameters: the fresh and
    the in-place (broadcast) forms still bit-equal to their plain
    versions, overflow included."""
    rng = np.random.default_rng(ca + len(lead))
    if layout == "orset":
        make, fn, plain = _slots, kernels.slot_union, kernels.slot_union_plain
    else:
        make, fn, plain = _rga_rows, kernels.rga_union, kernels.rga_union_plain
    a = make(rng, lead, ca, cuda_device, canonical=canonical, full_rows=0.5)
    b = make(rng, lead, cb, cuda_device, canonical=canonical, full_rows=0.5)
    _kernel_vs_plain(fn, plain, (a, b, ca))
    out = {f: torch.empty((3,) + lead + (ca,), dtype=x.dtype,
                          device=cuda_device) for f, x in a.items()}
    mine, ref = _clone(out), _clone(out)
    _, o1 = fn(a, b, ca, out=mine)
    _, o2 = plain(a, b, ca, out=ref)
    torch.cuda.synchronize()
    _same((mine, o1), (ref, o2))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,ca,cb,cap,canonical", [
    ((3, 5), 6, 6, 6, False), ((7,), 8, 8, 8, True), ((2, 4), 5, 3, 4, False),
    ((4,), 3, 2, 8, True), ((2, 50), 256, 256, 256, True),
    ((16, 100), 64, 64, 64, False)])
def test_lww_union_matches_plain(cuda_device, lead, ca, cb, cap, canonical):
    """The LWW instantiation of slot_union.cu: one key, four payloads, no
    flag; duplicate elems within a non-canonical input, equal stamps,
    negative low words (unsigned order), full rows (overflow), unequal
    widths, and the in-place form writing into several replicas."""
    rng = np.random.default_rng(ca * 7 + cb)
    a = _lww_rows(rng, lead, ca, cuda_device, canonical=canonical,
                  dup_rows=0.3, full_rows=0.5, num_elems=ca + cb)
    b = _lww_rows(rng, lead, cb, cuda_device, canonical=canonical,
                  dup_rows=0.3, full_rows=0.5, num_elems=ca + cb)
    before = kernels.lww_union.launches
    out, ovf = _kernel_vs_plain(kernels.lww_union, kernels.lww_union_plain,
                                (a, b, cap))
    assert kernels.lww_union.launches == before + 1
    assert out["valid"].any() and (cap > max(ca, cb) or ovf.any())
    dst = {f: torch.empty((2,) + lead + (cap,), dtype=x.dtype,
                          device=cuda_device) for f, x in a.items()}
    mine, ref = _clone(dst), _clone(dst)
    _, o1 = kernels.lww_union(a, b, cap, out=mine)
    _, o2 = kernels.lww_union_plain(a, b, cap, out=ref)
    torch.cuda.synchronize()
    _same((mine, o1), (ref, o2))


def _rows_cases(rng, k, dev):
    """Listed rows for a row-list join: all, some (fewer than listed) and
    none, in random order."""
    perm = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(dev)
    return [(perm, torch.tensor(k, dtype=torch.int32, device=dev)),
            (perm, torch.tensor(k // 3, dtype=torch.int32, device=dev)),
            (perm, torch.tensor(0, dtype=torch.int32, device=dev))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,r", [("lww", 5), ("lww", 2), ("mvr", 7),
                                    ("mvr", 2), ("mvr", 64)])
def test_row_list_trees_match_plain(cuda_device, kind, r):
    """``join_replica_rows`` of the LWW-Set (lww_union_rows) and the
    MVRegister (mvr_merge_rows) on the card against the same tree run on
    the CPU (the plain versions), over all, some and no listed rows, at
    odd R, R = 2 (one level, in place) and R = 64."""
    from janus_tpu_torch.models import lwwset, mvregister

    rng = np.random.default_rng(r + len(kind))
    k = 9
    if kind == "lww":
        host = workloads.lww_slots(rng, (r, k), 8, canonical=False,
                                   dup_rows=0.2, num_elems=12)
        model = lwwset
    else:
        host = workloads.mvr_slots(rng, (r, k), 3, 5)
        model = mvregister
    for rows, n in _rows_cases(rng, k, cuda_device):
        mine = _on(host, cuda_device)
        ref = _on(host, "cpu")
        model.join_replica_rows(mine, rows, n)
        model.join_replica_rows(ref, rows.cpu(), n.cpu())
        torch.cuda.synchronize()
        _same(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,r", [("lww", 5), ("lww", 64), ("mvr", 5),
                                    ("mvr", 64)])
def test_full_trees_match_plain(cuda_device, kind, r):
    """``join_replicas`` (the halving tree, the last level broadcast into
    every replica) on the card against the CPU; the MVRegister's rows hold
    more concurrent values than V, so the capacity cut decides."""
    from janus_tpu_torch.models import lwwset, mvregister

    rng = np.random.default_rng(r * 3)
    if kind == "lww":
        host = workloads.lww_slots(rng, (r, 11), 16, canonical=False,
                                   full_rows=0.4, num_elems=40)
        model = lwwset
    else:
        host = workloads.mvr_slots(rng, (r, 11), 4, 6, span=5)
        model = mvregister
    mine, ref = _on(host, cuda_device), _on(host, "cpu")
    model.join_replicas(mine)
    model.join_replicas(ref)
    torch.cuda.synchronize()
    _same(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,c,b,mode,hot", [
    (3, 5, 8, 40, "apply", False), (4, 3, 6, 300, "captured", False),
    (5, 2, 4, 24, "capture", False), (2, 4, 64, 5000, "apply", True),
    (2, 4, 64, 5000, "capture", True), (16, 100, 64, 2048, "captured", False)])
def test_lww_apply_and_capture_match_plain(cuda_device, v, k, c, b, mode,
                                           hot):
    """lww_apply (uncaptured, captured) and lww_capture against their plain
    versions: non-canonical rows with duplicate elems, full rows that
    drop, keys in [-2K, 2K), every op code, equal stamps and negative low
    words; ``hot``: most lanes on one row, more than a window of them (the
    walk's windowed lane order)."""
    rng = np.random.default_rng(v * b + c)
    st = _lww_rows(rng, (v, k), c, cuda_device, canonical=False,
                   dup_rows=0.3, full_rows=0.4, num_elems=2 * c)
    ops = workloads.lww_mixed_ops(rng, (v, b), k, 2 * c,
                                  captured=mode == "captured")
    if hot:
        ops["key"][:, : 9 * b // 10] = 1
    dops = _on(ops, cuda_device)
    if mode == "capture":
        before = kernels.lww_capture.launches
        ok, drop = _kernel_vs_plain(kernels.lww_capture,
                                    kernels.lww_capture_plain, (st, dops))
        assert kernels.lww_capture.launches == before + 1
        assert bool((ok == 0).any()) and bool((ok == 1).any())
    else:
        before = kernels.lww_apply.launches
        drop = _kernel_vs_plain(kernels.lww_apply, kernels.lww_apply_plain,
                                (st, dops))
        assert kernels.lww_apply.launches == before + 1
    assert int(drop.sum()) > 0


def _walk_vs_host_plain(fn, plain, st, ops):
    """The wrapper on the card and its plain version on host copies (a
    plain walk is thousands of small steps, quicker there): outputs and
    in-place updates bit-equal."""
    mine = _clone(st)
    ref = {f: x.cpu() for f, x in st.items()}
    out = fn(mine, ops)
    want = plain(ref, {f: x.cpu() for f, x in ops.items()})
    torch.cuda.synchronize()
    _same((mine, out), (ref, want))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case,geo", [
    *[(case, geo) for case in workloads.LWW_WALK_CASES
      for geo in ((64, 500, 64, 64), (64, 500, 256, 64))],
    ("long_rows", (3, 8, 40, 2000)), ("hot_row", (2, 6, 300, 700)),
    ("hazards", (2, 6, 300, 700)), ("full_drop", (2, 6, 512, 700)),
    ("hazards", (2, 6, 512, 700))],
    ids=lambda x: x if isinstance(x, str) else "V{}K{}C{}B{}".format(*x))
def test_lww_walk_cases_match_plain(cuda_device, case, geo, mode):
    """The walk's edge cases (``workloads.lww_walk_case``) in the three
    modes: typed_store's 64 lanes a replica over rows of 64 and 256 slots
    (four rows a warp, one), hundreds of lanes a row, a row past its
    bucket (walked from the op fields), full rows that drop, and rows of
    300 and 512 slots (16 slots a thread)."""
    v, k, c, b = geo
    rng = np.random.default_rng(workloads.LWW_WALK_CASES.index(case) + c)
    st, ops = (_on(x, cuda_device) for x in workloads.lww_walk_case(
        rng, case, (v, b), k, c, captured=mode == "captured"))
    name = "lww_capture" if mode == "capture" else "lww_apply"
    before = getattr(kernels, name).launches
    out = _walk_vs_host_plain(getattr(kernels, name),
                              getattr(kernels, name + "_plain"), st, ops)
    assert getattr(kernels, name).launches == before + 1
    if case == "full_drop":
        drop = out[1] if mode == "capture" else out
        assert (drop > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lead,va,vb,w,canonical", [
    ((3, 5), 3, 3, 5, True), ((2, 4), 4, 2, 7, False), ((7,), 8, 8, 64, True),
    ((32, 500), 8, 8, 64, True), ((4, 9), 1, 1, 33, False)])
def test_mvr_merge_matches_plain(cuda_device, lead, va, vb, w, canonical):
    """mvr_merge against its plain version: dominated, equal and
    concurrent clocks, exact twins across and within the inputs, more
    concurrent values than V (overflow), clocks of W > 32 lanes, and the
    in-place form writing into several replicas."""
    rng = np.random.default_rng(va * w + len(lead))
    a = _mvr_rows(rng, lead, va, w, cuda_device, canonical=canonical)
    b = _mvr_rows(rng, lead, vb, w, cuda_device, canonical=canonical)
    before = kernels.mvr_merge.launches
    out, ovf = _kernel_vs_plain(kernels.mvr_merge, kernels.mvr_merge_plain,
                                (a, b, va))
    assert kernels.mvr_merge.launches == before + 1
    assert out["valid"].any()
    dst = {f: torch.empty((2,) + tuple(x.shape), dtype=x.dtype,
                          device=cuda_device) for f, x in a.items()}
    mine, ref = _clone(dst), _clone(dst)
    _, o1 = kernels.mvr_merge(a, b, va, out=mine)
    _, o2 = kernels.mvr_merge_plain(a, b, va, out=ref)
    torch.cuda.synchronize()
    _same((mine, o1), (ref, o2))


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,vc,w,b,mode,hot", [
    (3, 5, 3, 5, 40, "apply", False), (4, 3, 2, 6, 300, "captured", False),
    (5, 2, 3, 4, 24, "capture", False), (2, 4, 8, 64, 5000, "captured", True),
    (2, 4, 8, 64, 5000, "capture", True), (64, 50, 8, 64, 256, "capture",
                                           False)])
def test_mvr_apply_and_capture_match_plain(cuda_device, v, k, vc, w, b, mode,
                                           hot):
    """mvr_apply (captured, uncaptured) and mvr_capture against their
    plain versions: non-canonical rows, keys in [-2K, 2K), writers in
    [-2W, 2W) (the two writer rules), wclocks at the int32 extremes (the
    bump wraps), more concurrent writers than V (drops); ``hot``: most
    lanes on one row, more than a window of them."""
    rng = np.random.default_rng(v * b + vc)
    st = _mvr_rows(rng, (v, k), vc, w, cuda_device, canonical=False)
    st["clock"][..., 0] = torch.where(st["valid"], INT32_MAX,
                                      st["clock"][..., 0])
    ops = workloads.mvr_mixed_ops(rng, (v, b), k, w,
                                  captured=mode == "captured")
    if hot:
        ops["key"][:, : 9 * b // 10] = 1
    dops = _on(ops, cuda_device)
    if mode == "capture":
        before = kernels.mvr_capture.launches
        _kernel_vs_plain(kernels.mvr_capture, kernels.mvr_capture_plain,
                         (st, dops))
        assert kernels.mvr_capture.launches == before + 1
    else:
        before = kernels.mvr_apply.launches
        _kernel_vs_plain(kernels.mvr_apply, kernels.mvr_apply_plain,
                         (st, dops))
        assert kernels.mvr_apply.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("vc,w", [(1, 64), (8, 64), (32, 4)])
@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case", workloads.MVR_WALK_CASES)
def test_mvr_walk_cases_match_plain(cuda_device, case, mode, vc, w):
    """The walk's edge cases of ``workloads.mvr_walk_case`` (a row of
    more than 3,000 writes, a frontier passing V many times, exact twins,
    hazard keys and writers) at V = 2 views of B = 3,200 lanes, in the
    three modes: state, drops and captured clocks bit-equal to plain."""
    from janus_tpu_torch.kernels.mvr_rows import OP_FIELDS

    rng = np.random.default_rng(vc * w + len(case))
    st, ops = workloads.mvr_walk_case(rng, case, 2, 5, vc, w, 3200)
    if mode != "captured":
        ops = {f: ops[f] for f in OP_FIELDS}
    st, ops = _on(st, cuda_device), _on(ops, cuda_device)
    name = "mvr_capture" if mode == "capture" else "mvr_apply"
    fn = getattr(kernels, name)
    before = fn.launches
    _kernel_vs_plain(fn, getattr(kernels, name + "_plain"), (st, ops))
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6144, 7000])
@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
def test_mvr_walk_many_rows_match_plain(cuda_device, k, mode):
    """Views of K = 6,144 rows, the most whose rank sort runs in shared
    memory, and of 7,000, sorted in global memory: 4,096 mixed lanes a
    view, an eighth of them on one hot row, bit-equal to plain in the
    three modes."""
    from janus_tpu_torch.kernels.mvr_rows import OP_FIELDS

    v, vc, w, b = 2, 8, 64, 4096
    rng = np.random.default_rng(k + len(mode))
    st = _mvr_rows(rng, (v, k), vc, w, cuda_device)
    ops = workloads.mvr_mixed_ops(rng, (v, b), k, w,
                                  captured=mode == "captured")
    ops["key"][:, : b // 8] = 3
    if mode != "captured":
        ops = {f: ops[f] for f in OP_FIELDS}
    ops = _on(ops, cuda_device)
    name = "mvr_capture" if mode == "capture" else "mvr_apply"
    fn = getattr(kernels, name)
    before = fn.launches
    _kernel_vs_plain(fn, getattr(kernels, name + "_plain"), (st, ops))
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lww", "mvr"])
def test_typed_safekv_on_card_matches_cpu(cuda_device, kind):
    """The LWW-Set and the MVRegister through SafeKV at N=4, W=8: the
    packed output and every device tensor bit-equal between the card and
    the CPU, round by round."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import lwwset, mvregister
    from janus_tpu_torch.runtime import safecrdt

    n, w, k, b = 4, 8, 6, 16
    if kind == "lww":
        spec, dims = lwwset.SPEC, dict(num_keys=k, capacity=8)
    else:
        spec, dims = mvregister.SPEC, dict(num_keys=k, num_writers=n,
                                           capacity=2)
    kvs = {d: safecrdt.SafeKV(DagConfig(n, w), spec, ops_per_block=b,
                              device=d, **dims)
           for d in (cuda_device, torch.device("cpu"))}
    rng = np.random.default_rng(3)
    for t in range(14):
        if kind == "lww":
            ops = workloads.lww_add_remove(rng, n, k, b, t, num_elems=10)
        else:
            ops = workloads.mvr_writes(rng, n, k, b, num_values=6)
        packed = {}
        for d, kv in kvs.items():
            packed[d.type], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, d))
            kv.step_absorb(packed[d.type], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"]), t
        st = {d.type: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for d, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
    assert kvs[cuda_device].stats == kvs[torch.device("cpu")].stats


# -- the 2P-Set and the 2P2P Graph ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout,lead,ca,cb,canonical", [
    ("orset", (3, 5), 6, 6, False), ("orset", (2, 50), 256, 256, True),
    ("rga", (3, 5), 6, 6, False), ("rga", (2, 8), 1024, 1024, True),
    ("lww", (3, 5), 6, 6, False), ("lww", (2, 50), 256, 256, True)])
def test_slot_union_layouts_unchanged_by_the_np0_template(cuda_device, layout,
                                                          lead, ca, cb,
                                                          canonical):
    """The OR-Set's, RGA's and LWW-Set's instantiations of slot_union.cu,
    after the payload arrays took one unused entry for layouts without a
    payload: fresh and in-place (broadcast) forms bit-equal to their plain
    versions, overflow included."""
    rng = np.random.default_rng(ca + len(lead) + len(layout))
    make, fn, plain = {
        "orset": (_slots, kernels.slot_union, kernels.slot_union_plain),
        "rga": (_rga_rows, kernels.rga_union, kernels.rga_union_plain),
        "lww": (_lww_rows, kernels.lww_union, kernels.lww_union_plain)}[layout]
    a = make(rng, lead, ca, cuda_device, canonical=canonical, full_rows=0.5)
    b = make(rng, lead, cb, cuda_device, canonical=canonical, full_rows=0.5)
    _kernel_vs_plain(fn, plain, (a, b, ca))
    out = {f: torch.empty((3,) + lead + (ca,), dtype=x.dtype,
                          device=cuda_device) for f, x in a.items()}
    mine, ref = _clone(out), _clone(out)
    _, o1 = fn(a, b, ca, out=mine)
    _, o2 = plain(a, b, ca, out=ref)
    torch.cuda.synchronize()
    _same((mine, o1), (ref, o2))


def _tp_rows(rng, shape, c, dev, **kw):
    return _on(workloads.tp_slots(rng, shape, c, **kw), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("edges,lead,ca,cb,cap,canonical", [
    (False, (3, 5), 6, 6, 6, False), (False, (7,), 8, 8, 8, True),
    (False, (2, 4), 5, 3, 4, False), (False, (16, 100), 64, 64, 64, False),
    (False, (2, 50), 256, 256, 256, True), (True, (3, 5), 6, 6, 6, False),
    (True, (4,), 3, 2, 8, True), (True, (2, 50), 256, 256, 256, True),
    (True, (16, 10), 256, 256, 256, False)])
def test_tp_and_edge_union_match_plain(cuda_device, edges, lead, ca, cb, cap,
                                       canonical):
    """The TP and EDGE instantiations of slot_union.cu (no payload, the
    tombstone ORed): duplicates within a non-canonical input, one copy
    tombstoned, full rows (overflow), unequal widths, and the in-place form
    writing into several replicas."""
    rng = np.random.default_rng(ca * 7 + cb + edges)
    fn, plain = ((kernels.edge_union, kernels.edge_union_plain) if edges
                 else (kernels.tp_union, kernels.tp_union_plain))
    kw = dict(canonical=canonical, dup_rows=0.3, full_rows=0.5, edges=edges)
    a = _tp_rows(rng, lead, ca, cuda_device, **kw)
    b = _tp_rows(rng, lead, cb, cuda_device, **kw)
    before = fn.launches
    out, ovf = _kernel_vs_plain(fn, plain, (a, b, cap))
    assert fn.launches == before + 1
    assert out["valid"].any() and (cap > max(ca, cb) or ovf.any())
    dst = {f: torch.empty((2,) + lead + (cap,), dtype=x.dtype,
                          device=cuda_device) for f, x in a.items()}
    mine, ref = _clone(dst), _clone(dst)
    _, o1 = fn(a, b, cap, out=mine)
    _, o2 = plain(a, b, cap, out=ref)
    torch.cuda.synchronize()
    _same((mine, o1), (ref, o2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,r", [("tpset", 5), ("tpset", 2), ("graph", 7),
                                    ("graph", 2), ("graph", 64)])
def test_tp_trees_match_plain(cuda_device, kind, r):
    """``join_replica_rows`` (tp_union_rows, and for the Graph also
    edge_union_rows) and ``join_replicas`` of the 2P-Set and the Graph on
    the card against the same trees on the CPU, over all, some and no
    listed rows, at odd R, R = 2 and R = 64."""
    from janus_tpu_torch.models import graph, tpset

    rng = np.random.default_rng(r + len(kind))
    k = 9
    if kind == "tpset":
        host = workloads.tp_slots(rng, (r, k), 8, canonical=False,
                                  dup_rows=0.2, full_rows=0.4, num_elems=12)
        model = tpset
    else:
        host = workloads.graph_slots(rng, (r, k), 6, 12, 7, canonical=False,
                                     dup_rows=0.2, full_rows=0.4)
        model = graph
    for rows, n in _rows_cases(rng, k, cuda_device):
        mine, ref = _on(host, cuda_device), _on(host, "cpu")
        model.join_replica_rows(mine, rows, n)
        model.join_replica_rows(ref, rows.cpu(), n.cpu())
        torch.cuda.synchronize()
        _same(mine, ref)
    mine, ref = _on(host, cuda_device), _on(host, "cpu")
    model.join_replicas(mine)
    model.join_replicas(ref)
    torch.cuda.synchronize()
    _same(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,c,b,mode,hot", [
    (3, 5, 8, 40, "apply", False), (4, 3, 6, 300, "captured", False),
    (5, 2, 4, 24, "capture", False), (2, 4, 64, 5000, "apply", True),
    (2, 4, 64, 5000, "capture", True), (16, 100, 64, 2048, "captured", False)])
def test_tpset_apply_and_capture_match_plain(cuda_device, v, k, c, b, mode,
                                             hot):
    """tpset_apply (uncaptured, captured) and tpset_capture against their
    plain versions: non-canonical rows with duplicate elems, full rows that
    drop, keys in [-2K, 2K), every op code; ``hot``: most lanes on one row,
    more than a window of them."""
    rng = np.random.default_rng(v * b + c + 1)
    st = _tp_rows(rng, (v, k), c, cuda_device, canonical=False,
                  dup_rows=0.3, full_rows=0.4, num_elems=2 * c)
    ops = workloads.tp_mixed_ops(rng, (v, b), k, 2 * c,
                                 captured=mode == "captured")
    if hot:
        ops["key"][:, : 9 * b // 10] = 1
    dops = _on(ops, cuda_device)
    if mode == "capture":
        before = kernels.tpset_capture.launches
        ok, drop = _kernel_vs_plain(kernels.tpset_capture,
                                    kernels.tpset_capture_plain, (st, dops))
        assert kernels.tpset_capture.launches == before + 1
        assert bool((ok == 0).any()) and bool((ok == 1).any())
    else:
        before = kernels.tpset_apply.launches
        drop = _kernel_vs_plain(kernels.tpset_apply,
                                kernels.tpset_apply_plain, (st, dops))
        assert kernels.tpset_apply.launches == before + 1
    assert int(drop.sum()) > 0


def _graph_rows(rng, shape, cv, ce, nv, dev, **kw):
    return _on(workloads.graph_slots(rng, shape, cv, ce, nv, **kw), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,cv,ce,nv,b,mode,hot", [
    (3, 5, 6, 10, 5, 48, "apply", False),
    (4, 3, 6, 10, 8, 300, "captured", False),
    (5, 2, 4, 6, 5, 24, "capture", False),
    (2, 4, 32, 256, 32, 5000, "apply", True),
    (2, 4, 32, 256, 32, 5000, "capture", True),
    (16, 100, 32, 256, 40, 2048, "captured", False)])
def test_graph_apply_and_capture_match_plain(cuda_device, v, k, cv, ce, nv, b,
                                             mode, hot):
    """graph_apply (uncaptured, captured) and graph_capture against their
    plain versions: non-canonical blocks with duplicates, full blocks that
    drop, keys in [-2K, 2K), codes -1 to 5, self-loops, endpoints at
    INT32_MAX; ``hot`` as for tpset_apply."""
    rng = np.random.default_rng(v * b + cv + 2)
    st = _graph_rows(rng, (v, k), cv, ce, nv, cuda_device, canonical=False,
                     dup_rows=0.3, full_rows=0.4, at_max=0.05)
    ops = workloads.graph_mixed_ops(rng, (v, b), k, nv,
                                    captured=mode == "captured")
    if hot:
        ops["key"][:, : 9 * b // 10] = 1
    dops = _on(ops, cuda_device)
    if mode == "capture":
        before = kernels.graph_capture.launches
        ok, drop = _kernel_vs_plain(kernels.graph_capture,
                                    kernels.graph_capture_plain, (st, dops))
        assert kernels.graph_capture.launches == before + 1
        assert bool((ok == 0).any()) and bool((ok == 1).any())
    else:
        before = kernels.graph_apply.launches
        drop = _kernel_vs_plain(kernels.graph_apply,
                                kernels.graph_apply_plain, (st, dops))
        assert kernels.graph_apply.launches == before + 1
    assert int(drop.sum()) > 0


# the walk's row shapes on the card: (kind, CV or C, CE), one for each
# instantiation of csrc/graph_apply.cu (the Graph at CV <= 32 and <= 256,
# the 2P-Set at C <= 64 and <= 256)
WALK_SHAPES = (("graph", 32, 256), ("graph", 64, 256), ("tpset", 64, 0),
               ("tpset", 256, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case", workloads.GRAPH_WALK_CASES)
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_graph_walk_cases_match_plain(cuda_device, shape, case, mode):
    """The walk's edge cases (``workloads.graph_walk_case``) through
    graph_apply / graph_capture and tpset_apply / tpset_capture against
    their plain versions, bit-equal, at each instantiation's widths: 2
    views, 500 rows (a few lanes a row), 2,200 lanes a view, so rows of
    1, 31, 32 and 33 lanes (a row's bucket holds 32), one of more than
    2,048, rows only adds touch, self-loops and ids at INT32_MAX, full
    blocks and the hazards are each walked in every mode."""
    kind, cv, ce = shape
    rng = np.random.default_rng(len(case) + cv + ce)
    st, ops = workloads.graph_walk_case(rng, case, 2, 500, cv, ce, 32, 2200,
                                        edges=kind == "graph")
    name = f"{kind}_{'capture' if mode == 'capture' else 'apply'}"
    fields = (("op", "key", "a0", "a1") if kind == "graph"
              else ("op", "key", "a0"))
    if mode != "captured":
        ops = {f: ops[f] for f in fields}
    fn = getattr(kernels, name)
    before = fn.launches
    _kernel_vs_plain(fn, getattr(kernels, name + "_plain"),
                     (_on(st, cuda_device), _on(ops, cuda_device)))
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("lead,cv,ce,nv,at_max", [
    ((3, 5), 6, 10, 5, 0.0), ((8, 16), 6, 10, 5, 0.2),
    ((16, 1000), 32, 256, 32, 0.01), ((7,), 1, 3, 2, 0.3),
    ((4, 3), 0, 5, 2, 0.0), ((2, 3), 40, 300, 50, 0.05)])
def test_edge_mask_matches_plain(cuda_device, lead, cv, ce, nv, at_max):
    """edge_mask against its plain version: live, dead and absent
    endpoints, duplicate slots, endpoints at INT32_MAX (the sentinel
    quirk), CV = 0, CV past one thread's slots and CE past a block."""
    rng = np.random.default_rng(cv * 3 + ce + len(lead))
    st = _graph_rows(rng, lead, cv, ce, nv, cuda_device, canonical=False,
                     dup_rows=0.3, at_max=at_max)
    before = kernels.edge_mask.launches
    out = _kernel_vs_plain(kernels.edge_mask, kernels.edge_mask_plain, (st,))
    assert kernels.edge_mask.launches == before + 1
    if cv and ce > 10:
        assert bool(out.any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tpset", "graph"])
def test_tp_safekv_on_card_matches_cpu(cuda_device, kind):
    """The 2P-Set and the Graph through SafeKV at N=4, W=8: the packed
    output and every device tensor bit-equal between the card and the CPU,
    round by round, and the Graph's edge_count of the prospective views."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import graph, tpset
    from janus_tpu_torch.runtime import safecrdt

    n, w, k, b = 4, 8, 6, 16
    if kind == "tpset":
        spec, dims = tpset.SPEC, dict(num_keys=k, capacity=8)
    else:
        spec, dims = graph.SPEC, dict(num_keys=k, v_capacity=8, e_capacity=24)
    kvs = {d: safecrdt.SafeKV(DagConfig(n, w), spec, ops_per_block=b,
                              device=d, **dims)
           for d in (cuda_device, torch.device("cpu"))}
    rng = np.random.default_rng(4)
    for t in range(14):
        if kind == "tpset":
            ops = workloads.tpset_add_remove(rng, n, k, b, num_elems=8)
        else:
            ops = workloads.graph_ops(rng, n, k, b, num_vertices=8,
                                      out_degree=3)
        packed = {}
        for d, kv in kvs.items():
            packed[d.type], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, d))
            kv.step_absorb(packed[d.type], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"]), t
        st = {d.type: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for d, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
        if kind == "graph":
            counts = [kv.query_prospective("edge_count").cpu()
                      for kv in kvs.values()]
            assert torch.equal(*counts), t
    assert kvs[cuda_device].stats == kvs[torch.device("cpu")].stats


def _union_case(rng, layout, case, lead, c):
    """One edge case's rows of a warp-merge layout: ``workloads.
    tp_union_case`` for "tp" and "edge", ``lww_union_case`` for "lww"."""
    if layout == "lww":
        return workloads.lww_union_case(rng, case, lead, c)
    return workloads.tp_union_case(rng, case, lead, c, edges=layout == "edge")


UNION_WRAPPERS = {"tp": "tp_union", "edge": "edge_union", "lww": "lww_union"}


def _tp_union_merge_case(dev, edges, case, c, layout=None):
    """The warp merge of the TP, EDGE or LWW layout (slot_union.cu, a
    row's appended tail sorted and merged into its prefix) on one edge case
    at C = c: fresh outputs at a capacity below, at and above one row's,
    ``out`` of two planes (the broadcast's block merge), ``out`` aliasing
    ``a``, and rows of unequal widths."""
    layout = layout or ("edge" if edges else "tp")
    name = UNION_WRAPPERS[layout]
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    rng = np.random.default_rng(len(case) + c + edges)
    a, b = (_on(x, dev) for x in _union_case(rng, layout, case, (48,), c))
    before = fn.launches
    for cap in (c // 2 + 3, c, 3 * c):
        got, ovf = fn(a, b, cap)
        ref, ref_ovf = plain(a, b, cap)
        _assert_outputs_equal(got, ref)
        _assert_outputs_equal(ovf, ref_ovf)
    ref, ref_ovf = plain(a, b, c)
    out = {f: torch.full((2, 48, c), 7, dtype=x.dtype, device=dev)
           for f, x in a.items()}
    _, ovf = fn(a, b, c, out=out)
    for f in ref:
        assert torch.equal(out[f], ref[f].expand_as(out[f])), f
    _assert_outputs_equal(ovf, ref_ovf)
    alias = _clone(a)
    fn(alias, b, c, out={f: x.unsqueeze(0) for f, x in alias.items()})
    _assert_outputs_equal(alias, ref)
    narrow = {f: x[:, : c // 3 + 1].contiguous() for f, x in b.items()}
    got, ovf = fn(a, narrow, c + 20)
    ref, ref_ovf = plain(a, narrow, c + 20)
    torch.cuda.synchronize()
    assert fn.launches == before + 6
    _assert_outputs_equal(got, ref)
    _assert_outputs_equal(ovf, ref_ovf)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 256])
@pytest.mark.parametrize("case", workloads.TP_UNION_CASES)
def test_tp_union_merge_matches_plain(cuda_device, case, c):
    """``tp_union``'s warp merge on every 2P edge case at the Graph's
    vertex rows (C = 32) and the 2P-Set's store rows (C = 256)."""
    _tp_union_merge_case(cuda_device, False, case, c)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 256])
@pytest.mark.parametrize("case", workloads.TP_UNION_CASES)
def test_edge_union_merge_matches_plain(cuda_device, case, c):
    """``edge_union``'s warp merge on every 2P edge case at C = 32 and the
    Graph's store edge rows (C = 256)."""
    _tp_union_merge_case(cuda_device, True, case, c)


def _tp_union_rows_merge_case(dev, edges, case, r, kind=None):
    """The row-list mode of the TP, EDGE or LWW warp merge on one edge case
    at C = 256, K = 16 key rows of r replicas, with 0, 1 and K rows listed:
    the converge's row-list tree through the kernel against the same tree
    of plain versions (r = 2: one level that writes the rows it read;
    r = 3 and 5: scratch levels, then the broadcast into every replica)."""
    from janus_tpu_torch.kernels.replica_tree import join_tree_rows
    from janus_tpu_torch.kernels.slot_union import EDGE, LWW, TP

    kind = kind or ("edge" if edges else "tp")
    layout = {"tp": TP, "edge": EDGE, "lww": LWW}[kind]
    name = UNION_WRAPPERS[kind] + "_rows"
    rng = np.random.default_rng(len(case) + r + edges)
    k, c = 16, 256
    draws = [_union_case(rng, kind, case, (k,), c)
             for _ in range((r + 1) // 2)]
    rows_of = [x for pair in draws for x in pair][:r]
    st = _on({f: np.stack([x[f] for x in rows_of]) for f in layout.fields},
             dev)
    rows = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(dev)
    for n_rows in (0, 1, k):
        n = torch.tensor(n_rows, dtype=torch.int32, device=dev)
        mine, ref = _clone(st), _clone(st)
        fn = getattr(kernels, name)
        before = fn.launches
        join_tree_rows(layout.fields, fn, mine, rows, n)
        join_tree_rows(layout.fields, getattr(kernels, name + "_plain"), ref,
                       rows, n)
        torch.cuda.synchronize()
        assert fn.launches == before + (r - 1).bit_length()
        _assert_outputs_equal(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 5])
@pytest.mark.parametrize("case", workloads.TP_UNION_CASES)
def test_tp_union_rows_merge_matches_plain(cuda_device, case, r):
    """``tp_union_rows``' warp merge on every 2P edge case."""
    _tp_union_rows_merge_case(cuda_device, False, case, r)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 5])
@pytest.mark.parametrize("case", workloads.TP_UNION_CASES)
def test_edge_union_rows_merge_matches_plain(cuda_device, case, r):
    """``edge_union_rows``' warp merge on every 2P edge case."""
    _tp_union_rows_merge_case(cuda_device, True, case, r)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 256])
@pytest.mark.parametrize("case", workloads.LWW_UNION_CASES)
def test_lww_union_merge_matches_plain(cuda_device, case, c):
    """``lww_union``'s warp merge on every LWW edge case (the 2P key
    orders with stamps, equal and extreme stamps, all-invalid rows) at
    C = 32 and the typed store's rows (C = 256)."""
    _tp_union_merge_case(cuda_device, False, case, c, layout="lww")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 5])
@pytest.mark.parametrize("case", workloads.LWW_UNION_CASES)
def test_lww_union_rows_merge_matches_plain(cuda_device, case, r):
    """``lww_union_rows``' warp merge on every LWW edge case."""
    _tp_union_rows_merge_case(cuda_device, False, case, r, kind="lww")


@pytest.mark.cuda
def test_lww_union_refuses_rows_past_shared_memory(cuda_device):
    """The LWW merge's rows at the most a block holds (25 bytes a record:
    Ca + Cb <= 9,128) join; one slot more a row is refused before any
    launch."""
    rng = np.random.default_rng(4)
    most = 4564

    def rows(c):
        return _lww_rows(rng, (1,), c, cuda_device, full_rows=1.0)
    a, b = rows(most), rows(most)
    _kernel_vs_plain(kernels.lww_union, kernels.lww_union_plain, (a, b, most))
    before = kernels.launches()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.lww_union(rows(most + 1), rows(most + 1))
    assert kernels.launches() == before


@pytest.mark.cuda
def test_tp_unions_refuse_rows_past_shared_memory(cuda_device):
    """The 2P merge's rows at the most a block holds (9 bytes a TP record,
    13 an edge: Ca + Cb <= 25,355 and 17,553 records) join; one slot more
    a row is refused before any launch."""
    rng = np.random.default_rng(3)
    for edges, fn, most in ((False, kernels.tp_union, 12677),
                            (True, kernels.edge_union, 8776)):
        def rows(c):
            return _on(workloads.tp_slots(rng, (1,), c, edges=edges),
                       cuda_device)
        a, b = rows(most), rows(most)
        plain = kernels.edge_union_plain if edges else kernels.tp_union_plain
        _kernel_vs_plain(fn, plain, (a, b, most))
        before = kernels.launches()
        with pytest.raises(ValueError, match="shared memory"):
            fn(rows(most + 1), rows(most + 1))
        assert kernels.launches() == before


RING_GEOMETRIES = [
    # (W, N, B, B'): grows, shrinks, a shrink by one lane, the adaptive
    # presets' ring halved (W 8, N 16, B 5,120)
    (8, 4, 8, 16), (8, 4, 16, 4), (5, 3, 33, 32), (8, 16, 5120, 2560),
    (8, 16, 64, 704),
    # B' (or B) not a multiple of 4: rows off the 16-byte path
    (4, 3, 13, 6), (4, 3, 6, 13), (8, 16, 5120, 2557)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(workloads.RING_EXTRAS))
@pytest.mark.parametrize("geo,live_tail", [
    (g, live) for g in RING_GEOMETRIES
    for live in ((False, True) if g[3] < g[2] else (False,))])
def test_ring_resize_matches_plain(cuda_device, kind, geo, live_tail):
    """Every ring field copied or zero-filled bit-equal to the plain
    version, and the live-tail flag (a shrink's refusal) equal to it; a
    live tail only where a shrink has a tail."""
    w, n, b, new_b = geo
    rng = np.random.default_rng(w * n + b + new_b)
    ring = workloads.ring_resize_case(rng, w, n, b, new_b,
                                      workloads.RING_EXTRAS[kind], live_tail)
    dring = workloads.ops_to_device(ring, cuda_device)
    before = kernels.ring_resize.launches
    got, flag = kernels.ring_resize(dring, new_b)
    want, want_flag = kernels.ring_resize_plain(dring, new_b)
    torch.cuda.synchronize()
    assert kernels.ring_resize.launches == before + 1
    assert int(flag.item()) == int(want_flag.item()) == int(live_tail)
    assert got.keys() == want.keys() == dring.keys()
    for f in got:
        assert got[f].shape == want[f].shape
        assert torch.equal(got[f], want[f]), f
    # the input ring is left as it was
    for f, x in ring.items():
        assert np.array_equal(dring[f].cpu().numpy(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", RING_GEOMETRIES)
def test_ring_resize_width3_extra_matches_plain(cuda_device, geo):
    """A capture extra of width 3 (rows of 3 B int32, a multiple of 4 only
    when B is) beside the op fields; the new ring's fields are views of one
    buffer, each on a 16-byte boundary, the flag after them."""
    w, n, b, new_b = geo
    rng = np.random.default_rng(w + b + 3 * new_b)
    ring = workloads.ops_to_device(workloads.ring_resize_case(
        rng, w, n, b, new_b, {"x3": 3, "x1": 1}, new_b < b), cuda_device)
    got, flag = kernels.ring_resize(ring, new_b)
    want, want_flag = kernels.ring_resize_plain(ring, new_b)
    torch.cuda.synchronize()
    assert int(flag.item()) == int(want_flag.item()) == int(new_b < b)
    for f in want:
        assert torch.equal(got[f], want[f]), f
        assert got[f].is_contiguous() and got[f].data_ptr() % 16 == 0
    assert len({x.untyped_storage().data_ptr() for x in got.values()}) == 1
    assert flag.untyped_storage().data_ptr() == \
        got["op"].untyped_storage().data_ptr()


@pytest.mark.cuda
def test_ring_resize_refuses_bad_operands(cuda_device):
    rng = np.random.default_rng(3)
    ring = workloads.ops_to_device(
        workloads.ring_resize_case(rng, 4, 4, 8, 4, {}), cuda_device)
    strided = dict(ring, key=ring["key"].transpose(0, 1).contiguous()
                   .transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ring_resize(strided, 4)
    with pytest.raises(ValueError, match="int32"):
        kernels.ring_resize(dict(ring, a0=ring["a0"].long()), 4)
    mixed = dict(ring, a1=ring["a1"].cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.ring_resize(mixed, 4)
    many = dict(ring, **{f"x{i}": ring["a2"].clone() for i in range(11)})
    with pytest.raises(ValueError, match="at most 16"):
        kernels.ring_resize(many, 4)


@pytest.mark.cuda
def test_safekv_resize_block_on_card_matches_cpu(cuda_device):
    """A grow, a refused shrink and a taken one on the card, each round
    after them bit-equal to the same run on the CPU."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime import safecrdt
    from janus_tpu_torch.utils.ids import TagMinter

    n, w, k = 4, 8, 8
    kvs = [safecrdt.SafeKV(DagConfig(n, w), orset.SPEC, ops_per_block=8,
                           apply_budget=8, device=d, num_keys=k, capacity=8,
                           rm_capacity=3) for d in (cuda_device, "cpu")]
    rng = np.random.default_rng(9)
    minters = [TagMinter(v) for v in range(n)]

    def step(live):
        b = kvs[0].B
        ops = workloads.orset_add_remove(rng, minters, k, b, num_elems=6)
        for f in ops:
            ops[f][:, live:] = 0
        for kv in kvs:
            kv.step(ops)
        for f in safecrdt.DEVICE_FIELDS:
            a, c = (getattr(kv, f) for kv in kvs)
            if isinstance(a, dict):
                for x in a:
                    assert torch.equal(a[x].cpu(), c[x]), (f, x)
            else:
                assert torch.equal(a.cpu(), c), f

    for _ in range(3):
        step(2)
    assert [kv.resize_block(16) for kv in kvs] == [True, True]
    step(16)
    assert [kv.resize_block(4) for kv in kvs] == [False, False]
    for _ in range(4 * w):
        step(2)
        done = [kv.resize_block(4) for kv in kvs]
        assert done[0] == done[1]
        if done[0]:
            break
    assert [kv.B for kv in kvs] == [4, 4]
    step(4)
    assert kvs[0].stats == kvs[1].stats


@pytest.mark.cuda
def test_safekv_ring_views_on_card_match_cpu(cuda_device):
    """Resizes to B not a multiple of 4 and back, each followed by rounds,
    then state_arrays loaded into a fresh SafeKV on the card that carries
    on: every round and every state_arrays bit-equal to the same run on
    the CPU (whose plain version lays the ring out the same way)."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime import safecrdt
    from janus_tpu_torch.utils.ids import TagMinter

    n, w, k = 4, 8, 8

    def make(dev, b):
        return safecrdt.SafeKV(DagConfig(n, w), orset.SPEC, ops_per_block=b,
                               apply_budget=8, device=dev, num_keys=k,
                               capacity=8, rm_capacity=3)

    kvs = [make(cuda_device, 8), make("cpu", 8)]
    rng = np.random.default_rng(12)
    minters = [TagMinter(v) for v in range(n)]

    def same(x, y, where):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for f in x:
                if f not in ("submit_wall", "wall_latency_log"):  # clocks
                    same(x[f], y[f], f"{where}.{f}")
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, where
            np.testing.assert_array_equal(x, y, err_msg=where)
        else:
            assert x == y, where

    def same_arrays(where):
        same(*(kv.state_arrays() for kv in kvs), where)

    def step(live):
        ops = workloads.orset_add_remove(rng, minters, k, kvs[0].B,
                                         num_elems=6)
        for f in ops:
            ops[f][:, live:] = 0
        for kv in kvs:
            kv.step(ops)

    step(2)
    for b in (13, 6, 16, 7):
        for _ in range(2 * w):
            done = [kv.resize_block(b) for kv in kvs]
            assert done[0] == done[1]
            if done[0]:
                break
            step(2)
        assert [kv.B for kv in kvs] == [b, b]
        step(min(3, b))
        same_arrays(f"B {b}")
    fresh = make(cuda_device, kvs[0].B)
    fresh.load_state(kvs[0].state_arrays())
    kvs[0] = fresh
    for _ in range(3):
        step(3)
    same_arrays("after load_state")
    assert kvs[0].stats == kvs[1].stats

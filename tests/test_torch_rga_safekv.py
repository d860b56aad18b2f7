"""Parity of the port's RGA through SafeKV (janus_tpu_torch, on the CPU)
with the JAX package's: the single-op capture (``base.capture_and_apply``
with ``rga.prepare_ops``), ``setops.mark_members``, the RGA's GC-fence
compaction ``rga.compact_fence``, and whole SafeKV rounds through ``step``.
On the CPU each wrapper runs its kernel's plain version.

Inputs are seeded numpy draws handed to both packages. Hazards: inserts
on one document lane after lane, full rows that drop an insert (its
counter still advances the floor), keys in [-K, 2K), no-op and unknown op
codes, Lamport floors at INT32_MAX (the mint wraps), duplicate and
SENTINEL query keys, M = 0 and T = 0. The SafeKV runs use the churn of
the smoke script's ``rga_consensus`` phase (``workloads.rga_churn``) at
N=4, W=8, K=4 documents of 64 slots, B=8, with GC advances, compactions
and a crashed node brought back by a state transfer, and mirror
tests/test_rga.py::test_rga_through_consensus and
tests/test_compact.py::test_rga_churn_with_compaction through ``step``
(the split submit/tick path is not ported). Every comparison is bit-equal
(int32 and bool state; tolerance exactly 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import base as jax_base
from janus_tpu.models import rga as jax_rga
from janus_tpu.ops import mark_members as jax_mark_members
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import base, rga
from janus_tpu_torch.ops import setops
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.runtime import safecrdt

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the JAX functions, jitted so that each shape compiles once
J_CAPTURE = jax.jit(jax.vmap(
    lambda st, o: jax_base.capture_and_apply(jax_rga.SPEC, st, o)))
J_FENCE = jax.jit(jax.vmap(jax_rga.compact_fence, in_axes=(0, None)))
J_TEXT = jax.jit(jax_rga.text)

N, W, K, C, B = 4, 8, 4, 64, 8
ROUNDS, IDLE = 14, 10
CRASHED = range(3, 10)  # rounds during which node N-1 is down


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return convert.tree_from_numpy(convert.tree_to_numpy(tree), "cpu")


def _assert_equal(got, want, where=""):
    got, want = convert.tree_to_numpy(got), convert.tree_to_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    x, y = np.asarray(got), np.asarray(want)
    assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype,
                                                       x.shape, y.shape)
    np.testing.assert_array_equal(x, y, err_msg=where)


def _state(rng, v, k, c, **kw):
    st = workloads.rga_slots(rng, (v, k), c, **kw)
    st["_depth"] = np.zeros((v, 8, 0), np.int32)
    st["ctr_floor"] = rng.integers(-2, c + 2, (v, k)).astype(np.int32)
    return st


def _capture_case(name, rng):
    """(state [V, K, C], ops [V, B]) of one named hazard."""
    v, k, c, b = 3, 4, 8, 24
    if name == "one_document":  # consecutive inserts on one key
        st = _state(rng, v, k, c, full_rows=0.0, fill=0.3)
        ops = workloads.rga_mixed_ops(rng, (v, b), k, c, hazards=False)
        ops["op"][:] = rga.OP_INSERT
        ops["key"][:] = 1
        ops["op"][:, 5] = rga.OP_DELETE  # a delete between them
        return st, ops
    if name == "full_rows":  # inserts that drop, the floor still advancing
        st = _state(rng, v, k, c, full_rows=1.0, dead=0.0)
        ops = workloads.rga_mixed_ops(rng, (v, b), k, c, hazards=False)
        ops["op"][:, ::2] = rga.OP_INSERT
        return st, ops
    if name == "hazards":  # keys in [-K, 2K), no-ops, unknown codes
        st = _state(rng, v, k, c, canonical=False, dup_rows=0.5,
                    negative=0.1)
        return st, workloads.rga_mixed_ops(rng, (v, b), k, c)
    assert name == "wrap"  # floors at INT32_MAX: the minted counter wraps
    st = _state(rng, v, k, c)
    st["ctr_floor"][:, ::2] = SENTINEL
    ops = workloads.rga_mixed_ops(rng, (v, b), k, c)
    return st, ops


@pytest.mark.parametrize("name,seed", [("one_document", 1), ("full_rows", 2),
                                       ("hazards", 3), ("wrap", 4)])
def test_capture_matches_jax_scan(name, seed):
    """``capture_and_apply(rga.SPEC)`` (the ``rga_capture`` wrapper) and the
    plain lane loop ``base.capture_scan`` against JAX's vmapped scan: the
    state after the batch and the prepared ops with ``eff_ctr``."""
    st, ops = _capture_case(name, np.random.default_rng(seed))
    want_st, want_ops = J_CAPTURE(_jax(st), _jax(ops))
    for capture in (base.capture_and_apply, base.capture_scan):
        got_st, got_ops = capture(rga.SPEC, _torch(st), _torch(ops))
        _assert_equal(got_ops, want_ops, f"{capture.__name__} ops")
        _assert_equal(got_st, want_st, f"{capture.__name__} state")
    if name == "full_rows":  # the drops happened
        _, dropped = kernels.rga_capture_plain(
            {f: _torch(st)[f] for f in (*rga.FIELDS, "ctr_floor")},
            _torch({f: ops[f] for f in base.OP_FIELDS}))
        assert int(dropped.sum()) > 0


def test_capture_refused_without_a_kernel():
    """A type with single-op capture and no capture kernel raises; it
    never runs the lane loop."""
    spec = base.CRDTTypeSpec(
        name="NoKernel", type_code="nokernel", init=None,
        apply_ops=lambda s, o: pytest.fail("the lane loop ran"), merge=None,
        queries={}, op_codes={}, prepare_ops=lambda s, o: o)
    ops = base.make_op_batch(op=[1, 1], key=[0, 0], device="cpu")
    with pytest.raises(NotImplementedError, match="NoKernel"):
        base.capture_and_apply(spec, {}, ops)


def _i32(*xs):
    return tuple(np.asarray(x, np.int32) for x in xs)


BIG = SENTINEL - 1
MARK_CASES = {
    # b_valid all False: nothing matches, even on exact key equality
    "b_all_invalid": (_i32([3, 5, 7], [1, 1, 1]), _i32([3, 5], [1, 1]),
                      [False, False]),
    # A keyed SENTINEL matches no masked B SENTINEL
    "a_sentinel": (_i32([SENTINEL] * 4, [SENTINEL] * 4),
                   _i32([SENTINEL, 2], [SENTINEL, 2]), [False, True]),
    "t_zero": (_i32([1, 2], [3, 4]), _i32([], []), []),
    "m_zero": (_i32([], []), _i32([1, 2], [3, 4]), [True, True]),
    # SENTINEL - 1 is an ordinary key, apart from SENTINEL
    "sentinel_minus_one": (_i32([BIG, BIG, 5], [BIG, 0, BIG]),
                           _i32([BIG, SENTINEL], [BIG, SENTINEL]),
                           [True, True]),
}


@pytest.mark.parametrize("name", [*MARK_CASES, "random"])
def test_mark_members_matches_jax(name):
    """``mark_members`` (the wrapper's plain version) against
    ``janus_tpu.ops.setops.mark_members``: the edge cases of
    tests/test_setops.py and random keys with duplicates on both sides and
    a masked share of queries."""
    if name == "random":
        rng = np.random.default_rng(9)
        a = _i32(rng.integers(-3, 4, 700), rng.integers(-3, 4, 700))
        b = _i32(rng.integers(-3, 4, 90), rng.integers(-3, 4, 90))
        b = tuple(np.where(rng.random(90) < 0.1, SENTINEL, x) for x in b)
        valid = rng.random(90) < 0.7
    else:
        a, b, valid = MARK_CASES[name]
    valid = np.asarray(valid, bool)
    want = jax_mark_members(tuple(map(jnp.asarray, a)),
                            tuple(map(jnp.asarray, b)), jnp.asarray(valid))
    t = [torch.from_numpy(x) for x in (*a, *b)]
    for fn in (kernels.mark_members, setops.mark_members):
        got = fn((t[0], t[1]), (t[2], t[3]), torch.from_numpy(valid))
        _assert_equal(got, want, name)


def _ring(rng, t, k, c, live_ids):
    """A flattened live ring ``[T]`` of RGA ops: inserts whose ids and
    parents hit ``live_ids`` (an array of (rep, ctr) rows) or miss them,
    deletes and no-ops."""
    op = rng.choice([0, rga.OP_INSERT, rga.OP_DELETE], t, p=[0.2, 0.5, 0.3])
    hit = live_ids[rng.integers(0, len(live_ids), (t, 2))]
    miss = rng.random((t, 2)) < 0.3
    return {"op": op.astype(np.int32),
            "key": rng.integers(0, k, t).astype(np.int32),
            "a0": rng.integers(32, 127, t).astype(np.int32),
            "a1": np.where(miss[:, 0], 99, hit[:, 0, 0]).astype(np.int32),
            "a2": hit[:, 0, 1].astype(np.int32),
            "writer": hit[:, 1, 0].astype(np.int32),
            "eff_ctr": np.where(miss[:, 1], c + 50,
                                hit[:, 1, 1])[:, None].astype(np.int32)}


@pytest.mark.parametrize("seed", [5, 6])
def test_compact_fence_batched_matches_vmap(seed):
    """``rga.compact_fence`` on a state of V views at once (one
    ``mark_members`` over every view) against JAX's per-view
    ``vmap(compact_fence)``; ``compact_fences`` of two states likewise."""
    rng = np.random.default_rng(seed)
    v, k, c = 4, 3, 16
    sts = [_state(rng, v, k, c, dead=0.6, full_rows=0.5) for _ in range(2)]
    valid = sts[0]["valid"]
    live_ids = np.stack([sts[0]["id_rep"][valid], sts[0]["id_ctr"][valid]], 1)
    ring = _ring(rng, 40, k, c, live_ids)
    want = [J_FENCE(_jax(st), _jax(ring)) for st in sts]
    _assert_equal(rga.compact_fence(_torch(sts[0]), _torch(ring)), want[0],
                  "compact_fence")
    got = rga.compact_fences(tuple(_torch(st) for st in sts), _torch(ring))
    for g, w_, in zip(got, want):
        _assert_equal(g, w_, "compact_fences")
    # the fence protected something an unfenced compaction reclaims
    plain = rga.compact(_torch(sts[0]))
    assert not np.array_equal(convert.tree_to_numpy(plain)["valid"],
                              np.asarray(want[0]["valid"]))


def _active(t):
    active = np.ones((N,), bool)
    active[N - 1] = t not in CRASHED
    return active


def _minted(kv, info, L):
    """Each node's insert counters ``[N, L]`` of the round just stepped:
    the ``eff_ctr`` its block carries in the ring (0 for a node whose
    batch was not accepted: its inserts never happened)."""
    ring = convert.tree_to_numpy(kv.ops_buffer)["eff_ctr"]
    return np.stack([ring[s, v, :L, 0] if acc else np.zeros(L, np.int32)
                     for v, (s, acc) in enumerate(zip(info["slot"],
                                                      info["accepted"]))])


def _by_id(st):
    """Every view's documents as lists of their valid slots' fields, each
    document sorted by id: equal when two states hold the same elements,
    whatever slots they occupy."""
    x = convert.tree_to_numpy(st)
    keys = ("id_ctr", "id_rep", "par_ctr", "par_rep", "chr", "dead")
    return [[sorted(zip(*(x[f][v, k][x["valid"][v, k]].tolist() for f in keys)))
             for k in range(x["valid"].shape[1])]
            for v in range(x["valid"].shape[0])]


def _device_state(kv):
    return convert.tree_to_numpy(
        {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})


@pytest.fixture(scope="module")
def churn():
    """The churn's op stream: pass 1 runs the insert lanes alone through
    the port (node N-1 crashed for some rounds, as in pass 2) and records
    their counters, which name the ids the anchors and deletes of the full
    stream use."""
    kv = safecrdt.SafeKV(DagConfig(N, W), rga.SPEC, ops_per_block=B,
                         device="cpu", num_keys=K, capacity=C, max_depth=8)
    minted = {}
    for t in range(ROUNDS):
        ops = workloads.rga_churn(N, B, K, t)
        minted[t] = _minted(kv, kv.step(ops, active=_active(t)), B // 2)
    return minted, [workloads.rga_churn(N, B, K, t, minted)
                    for t in range(ROUNDS)]


def test_safekv_churn_matches_jax_every_round(churn):
    """The churn through the port's ``SafeKV.step`` and JAX's, node N-1
    crashed for some rounds and brought back by a state transfer (the
    ring's ``eff_ctr`` extra, the ``ctr_floor`` leaf and the zero-size
    ``_depth`` carried along), every device leaf and the packed output
    bit-equal after every round, then idle rounds to a drain; the counters
    minted equal pass 1's; GC advanced and compacted; views agree."""
    minted, stream = churn
    mine = safecrdt.SafeKV(DagConfig(N, W), rga.SPEC, ops_per_block=B,
                           device="cpu", num_keys=K, capacity=C, max_depth=8)
    ref = JaxSafeKV(JaxDagConfig(N, W), jax_rga.SPEC, ops_per_block=B,
                    num_keys=K, capacity=C, max_depth=8)
    idle = {f: np.zeros((N, B), np.int32) for f in base.OP_FIELDS}
    for t in range(ROUNDS + IDLE):
        ops = stream[t] if t < ROUNDS else idle
        packed, meta = mine.step_dispatch(ops, active=_active(t))
        jpacked, jmeta = ref.step_dispatch(ops, active=_active(t))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked),
                                      err_msg=f"packed round {t}")
        info = mine.step_absorb(packed, meta)
        ref.step_absorb(jpacked, jmeta)
        _assert_equal(_device_state(mine), _device_state(ref), f"round {t}")
        if t < ROUNDS:
            np.testing.assert_array_equal(_minted(mine, info, B // 2),
                                          minted[t])
    assert mine.stats == ref.stats
    assert mine.stats["compactions"] > 0 and mine.stats["slots_dropped"] == 0
    assert mine.stats["state_transfers"] > 0
    assert mine.prospective["dead"].dtype == torch.bool
    # the stable views are bit-equal; every view's prospective state holds
    # the same elements, in the slots its apply order gave them
    for f, x in mine.stable.items():
        assert torch.equal(x, x[:1].expand_as(x)), f
    assert _by_id(mine.prospective) == _by_id(mine.stable)
    view0 = {f: x[0] for f, x in _jax(_device_state(ref)["stable"]).items()}
    for doc in range(K):
        got = convert.tree_to_numpy(mine.query_stable("text", doc))
        want = J_TEXT(view0, doc)
        _assert_equal({f: x[0] for f, x in got.items()}, want, f"text {doc}")


def _letters(out, v):
    out = convert.tree_to_numpy(out)
    return "".join(chr(c) for c, m in zip(out["chr"][v], out["live"][v]) if m)


def test_rga_through_consensus_mirror():
    """tests/test_rga.py::test_rga_through_consensus through ``step``:
    each node types its own letter at the head of one document,
    concurrently; every view reads one text holding all four letters,
    stable equal to prospective, and the port equals JAX every round. The
    document has the churn mirror's 16 slots (the JAX test's 64 and depth
    16 hold the same four letters), so JAX compiles one step for both."""
    n, w, b = 4, 8, 2
    dims = dict(num_keys=1, capacity=16, max_depth=8)
    mine = safecrdt.SafeKV(DagConfig(n, w), rga.SPEC, ops_per_block=b,
                           device="cpu", **dims)
    ref = JaxSafeKV(JaxDagConfig(n, w), jax_rga.SPEC, ops_per_block=b, **dims)
    op = np.zeros((n, b), np.int32)
    op[:, 0] = rga.OP_INSERT
    a0 = np.zeros((n, b), np.int32)
    a0[:, 0] = ord("A") + np.arange(n)
    writer = np.repeat(np.arange(n, dtype=np.int32)[:, None], b, 1)
    first = base.make_op_batch(op=op, key=np.zeros((n, b)), a0=a0,
                               writer=writer, device="cpu")
    idle = {f: np.zeros((n, b), np.int32) for f in base.OP_FIELDS}
    for t in range(2 * w):
        ops = convert.tree_to_numpy(first) if t == 0 else idle
        mine.step(ops)
        ref.step(ops)
        _assert_equal(_device_state(mine), _device_state(ref), f"round {t}")
    texts = set()
    for v in range(n):
        p = _letters(mine.query_prospective("text", 0), v)
        assert p == _letters(mine.query_stable("text", 0), v)
        texts.add(p)
    assert len(texts) == 1 and sorted(texts.pop()) == ["A", "B", "C", "D"]


def test_rga_churn_with_compaction_mirror():
    """tests/test_compact.py::test_rga_churn_with_compaction through
    ``step``: node 0 inserts one element a round and then deletes every
    visible one, 1.5 times the capacity in all; compaction keeps the
    document below capacity, ``dead`` stays bool, every view reads one
    text, and the port equals JAX every round."""
    n, w, b, cap = 4, 8, 2, 16
    dims = dict(num_keys=1, capacity=cap, max_depth=8)
    mine = safecrdt.SafeKV(DagConfig(n, w), rga.SPEC, ops_per_block=b,
                           device="cpu", **dims)
    ref = JaxSafeKV(JaxDagConfig(n, w), jax_rga.SPEC, ops_per_block=b, **dims)
    vs = np.repeat(np.arange(n, dtype=np.int32)[:, None], b, 1)
    zeros = np.zeros((n, b), np.int32)
    for t in range(3 * cap // 2):
        op = zeros.copy()
        op[0, 0] = rga.OP_INSERT
        ins = dict(op=op, key=zeros, a0=np.full((n, b), 65 + t % 26, np.int32),
                   a1=zeros, a2=zeros, writer=vs)
        out = convert.tree_to_numpy(mine.query_prospective("text", 0))
        live = out["live"][0]
        reps, ctrs = out["id_rep"][0][live][:b], out["id_ctr"][0][live][:b]
        m = len(reps)
        dele = dict(op=zeros.copy(), key=zeros, a0=zeros, a1=zeros.copy(),
                    a2=zeros.copy(), writer=vs)
        dele["op"][0, :m] = rga.OP_DELETE
        dele["a1"][0, :m], dele["a2"][0, :m] = reps, ctrs
        for ops in (ins, dele):
            mine.step(ops)
            ref.step(ops)
        _assert_equal(_device_state(mine), _device_state(ref), f"round {t}")
    idle = {f: zeros for f in base.OP_FIELDS}
    for _ in range(w):
        mine.step(idle)
        ref.step(idle)
    _assert_equal(_device_state(mine), _device_state(ref), "drained")
    assert mine.stats == ref.stats and mine.stats["compactions"] > 0
    occ = rga.element_count(mine.prospective)
    assert int(occ.max()) < cap
    assert mine.prospective["dead"].dtype == torch.bool
    out = mine.query_prospective("text", 0)
    assert out["live"].dtype == torch.bool
    assert len({_letters(out, v) for v in range(n)}) == 1

"""Workload generators (counterpart: janus_tpu/bench/workloads.py).

Batches are drawn with numpy from a ``np.random.Generator`` — the same
draws, in the same order, as the JAX package's generators — and moved
onto a device with ``ops_to_device``.
"""
from __future__ import annotations

import numpy as np
import torch

from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels import leader
from janus_tpu_torch.kernels.mvr_rows import frontier
from janus_tpu_torch.models import (base, graph, lwwset, mvregister, orset,
                                    pncounter, rga, tpset)
from janus_tpu_torch.ops.lattice import SENTINEL


def pnc_uniform(rng: np.random.Generator, num_replicas: int, num_keys: int,
                batch: int) -> dict:
    """Uniform inc/dec mix over all keys; writer lane = replica id.
    Returns a dict of int32[num_replicas, batch] numpy arrays."""
    shape = (num_replicas, batch)
    ops = {
        "op": rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1, shape),
        "key": rng.integers(0, num_keys, shape),
        "a0": rng.integers(1, 10, shape),
        "writer": np.broadcast_to(
            np.arange(num_replicas, dtype=np.int32)[:, None], shape),
    }
    return {f: np.ascontiguousarray(ops[f], np.int32) if f in ops
            else np.zeros(shape, np.int32) for f in base.OP_FIELDS}


def _op_batch(shape, **fields) -> dict:
    """int32 numpy op batch of ``shape``; missing fields are zero."""
    return {f: np.ascontiguousarray(np.broadcast_to(fields[f], shape), np.int32)
            if f in fields else np.zeros(shape, np.int32)
            for f in base.OP_FIELDS}


def _mint_adds(minters, is_add: np.ndarray) -> np.ndarray:
    """[R, B, 2] tags: fresh per-replica tags in the add lanes, zero
    elsewhere (removes ignore a1/a2)."""
    tags = np.zeros(is_add.shape + (2,), np.int32)
    for i, m in enumerate(minters):
        lanes = np.nonzero(is_add[i])[0]
        if lanes.size:
            tags[i, lanes] = m.mint_many(lanes.size)
    return tags


def orset_add_remove(rng: np.random.Generator, minters, num_keys: int,
                     batch: int, num_elems: int = 64,
                     add_ratio: float = 0.5) -> dict:
    """Add/remove mix over uniform keys with fresh per-replica tags for
    the adds (one ``utils.ids.TagMinter`` per replica). Returns int32
    ``[len(minters), batch]`` numpy arrays."""
    shape = (len(minters), batch)
    is_add = rng.random(shape) < add_ratio
    op = np.where(is_add, orset.OP_ADD, orset.OP_REMOVE)
    tags = _mint_adds(minters, is_add)
    return _op_batch(shape, op=op, key=rng.integers(0, num_keys, shape),
                     a0=rng.integers(0, num_elems, shape),
                     a1=tags[..., 0], a2=tags[..., 1])


def zipf_keys(rng: np.random.Generator, num_keys: int, shape,
              theta: float = 0.99) -> np.ndarray:
    """Zipf-distributed key choice (rank r drawn with weight r^-theta)."""
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    probs = 1.0 / ranks**theta
    probs /= probs.sum()
    return rng.choice(num_keys, size=shape, p=probs).astype(np.int32)


def orset_hot_window(rng: np.random.Generator, minters, num_keys: int,
                     batch: int, tick: int, hot: int,
                     theta: float = 0.99, num_elems: int = 64) -> dict:
    """One tick of the anti-entropy store's OR-Set traffic: a 50/50
    add/remove mix whose keys are Zipf-skewed inside a hot window of
    ``hot`` keys that rotates by ``hot`` every tick, so the whole key
    space is touched over a run. The draws follow the JAX harness's
    OR-Set half of its store geometry (adds, tags, keys, elements)."""
    shape = (len(minters), batch)
    base_key = (tick * hot) % num_keys
    is_add = rng.random(shape) < 0.5
    tags = _mint_adds(minters, is_add)
    keys = (base_key + zipf_keys(rng, hot, shape, theta)) % num_keys
    return _op_batch(shape, op=np.where(is_add, orset.OP_ADD, orset.OP_REMOVE),
                     key=keys, a0=rng.integers(0, num_elems, shape),
                     a1=tags[..., 0], a2=tags[..., 1])


def pnc_hot_window(rng: np.random.Generator, num_replicas: int,
                   num_keys: int, batch: int, tick: int, hot: int,
                   theta: float = 0.99) -> dict:
    """One tick of the anti-entropy store's PN-Counter traffic: inc/dec
    with amounts in [1, 10), writer lane = replica, keys Zipf-skewed inside
    the same rotating hot window as ``orset_hot_window``. The draws follow
    the JAX harness's PN-Counter half of its store geometry (op, keys,
    amounts)."""
    shape = (num_replicas, batch)
    base_key = (tick * hot) % num_keys
    op = rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1, shape)
    keys = (base_key + zipf_keys(rng, hot, shape, theta)) % num_keys
    return _op_batch(shape, op=op, key=keys, a0=rng.integers(1, 10, shape),
                     writer=np.arange(num_replicas)[:, None])


def store_delta_tick(rng: np.random.Generator, minters, num_keys: int,
                     batch: int, tick: int, hot: int,
                     theta: float = 0.99) -> dict:
    """One tick of the two-type store (``{"pnc": ..., "orset": ...}``,
    one replica per minter), drawn in the JAX harness's order: the
    PN-Counter's ops, then the OR-Set's."""
    return {"pnc": pnc_hot_window(rng, len(minters), num_keys, batch, tick,
                                  hot, theta),
            "orset": orset_hot_window(rng, minters, num_keys, batch, tick,
                                      hot, theta)}


def orset_slots(rng: np.random.Generator, shape, capacity: int,
                full_rows: float = 0.25, fill: float = 0.6, reps: int = 4,
                num_elems: int = 8, removed: float = 0.3,
                canonical: bool = True, dup_rows: float = 0.0) -> dict:
    """Random OR-Set slot rows ``shape + (capacity,)`` as numpy arrays
    (``tag_rep``, ``tag_ctr``, ``elem``, ``removed``, ``valid``).

    A ``full_rows`` share of rows is full, the rest hold up to ``fill`` of
    the capacity; tags are distinct within a row, with ``reps`` minting
    replicas and counters from 1. Canonical rows are sorted by tag with
    SENTINEL keys and zero payloads in invalid slots. Otherwise slots are
    shuffled, invalid slots hold junk, and a ``dup_rows`` share of rows
    repeats one valid tag in a second slot."""
    c = capacity
    rows = int(np.prod(shape, dtype=np.int64))
    space = max(4 * c, reps)
    pick = np.argsort(rng.random((rows, space)), axis=1)[:, :c]
    n = np.where(rng.random(rows) < full_rows, c,
                 rng.integers(0, int(fill * c) + 1, rows))
    valid = np.arange(c)[None, :] < n[:, None]
    tag = np.where(valid, pick, space)
    tag.sort(axis=1)
    valid = tag < space
    per = -(-space // reps)  # counters per minting replica
    rep = np.where(valid, tag // per, SENTINEL).astype(np.int32)
    ctr = np.where(valid, tag % per + 1, SENTINEL).astype(np.int32)
    elem = np.where(valid, rng.integers(0, num_elems, (rows, c)), 0)
    rm = valid & (rng.random((rows, c)) < removed)
    out = {"tag_rep": rep, "tag_ctr": ctr, "elem": elem.astype(np.int32),
           "removed": rm, "valid": valid}
    if not canonical:
        junk = ~valid
        out["tag_rep"] = np.where(junk, rng.integers(-5, 5, (rows, c)), rep)
        out["tag_ctr"] = np.where(junk, rng.integers(-5, 5, (rows, c)), ctr)
        out["elem"] = np.where(junk, rng.integers(-5, 5, (rows, c)), elem)
        out["removed"] = np.where(junk, rng.random((rows, c)) < 0.5, rm)
        for r in np.nonzero((rng.random(rows) < dup_rows) & (n >= 2))[0]:
            src, dst = rng.choice(n[r], 2, replace=False)
            for f in ("tag_rep", "tag_ctr"):
                out[f][r, dst] = out[f][r, src]
        perm = np.argsort(rng.random((rows, c)), axis=1)
        out = {f: np.take_along_axis(x, perm, 1) for f, x in out.items()}
    return {f: np.ascontiguousarray(x.reshape(tuple(shape) + (c,)),
                                    bool if f in ("removed", "valid") else np.int32)
            for f, x in out.items()}


def orset_mixed_ops(rng: np.random.Generator, shape, num_keys: int,
                    capacity: int, hazards: bool = True) -> dict:
    """OR-Set op lanes of every code (0 no-op, 1 add, 2 remove, 3 clear)
    whose tags collide with ``orset_slots``' tags and with each other's,
    as int32 numpy arrays of ``shape``. With ``hazards``, keys fall in
    [-K, 2K) and 5% of the adds carry a SENTINEL tag."""
    k = num_keys
    ops = {
        "op": rng.choice(4, shape, p=[0.1, 0.45, 0.35, 0.1]),
        "key": rng.integers(-k, 2 * k, shape) if hazards else rng.integers(0, k, shape),
        "a0": rng.integers(0, 8, shape),
        "a1": rng.integers(0, 4, shape),
        "a2": rng.integers(1, capacity + 2, shape),
        "writer": np.zeros(shape),
    }
    if hazards:
        ops["a1"] = np.where(rng.random(shape) < 0.05, SENTINEL, ops["a1"])
    return {f: v.astype(np.int32) for f, v in ops.items()}


ORSET_APPLY_CASES = ("mixed", "hot_row", "noop_noncanonical", "untouched",
                     "out_of_range_full", "int32_max", "exact_fill")


def orset_apply_case(rng: np.random.Generator, case: str, shape,
                     num_keys: int, capacity: int, r_cap: int = 0):
    """``(state, ops)`` for one of ``ORSET_APPLY_CASES``: OR-Set rows ``[V,
    K, C]`` and op lanes ``[V, B]`` as numpy arrays (with captured tags
    ``rm_rep``/``rm_ctr``/``rm_elem`` ``[V, B, r_cap]`` when ``r_cap``),
    the edge cases of an apply that groups each view's lanes by gathered
    row and walks only those rows:

    - ``mixed``: every op code, keys in [-K, 2K), SENTINEL adds,
      non-canonical rows with duplicate tags;
    - ``hot_row``: 90% of the lanes on row 1 (its bucket overflows);
    - ``noop_noncanonical``: NOOP lanes on non-canonical rows, which they
      leave canonical;
    - ``untouched``: non-canonical rows, the lanes on the first half of
      the rows only (the rest stay byte for byte);
    - ``out_of_range_full``: full rows, every key out of range (clamped to
      the first or last row): adds of absent tags drop, nothing is
      written;
    - ``int32_max``: valid (INT32_MAX, INT32_MAX) tags among the invalid
      slots, and adds of that tag and of others;
    - ``exact_fill``: rows one slot short of full, two adds of new tags a
      row (the first fills it, the second evicts the largest tag and
      drops).
    """
    v, b = shape
    k, c = num_keys, capacity
    canonical = case in ("out_of_range_full", "int32_max")
    full = 1.0 if case == "out_of_range_full" else 0.4
    st = orset_slots(rng, (v, k), c, canonical=canonical, dup_rows=0.3,
                     full_rows=full)
    ops = orset_mixed_ops(rng, (v, b), k, c, hazards=case == "mixed")
    if case == "hot_row":
        ops["key"][:, : 9 * b // 10] = min(1, k - 1)
    elif case == "noop_noncanonical":
        ops["op"][:] = 0
    elif case == "untouched":
        ops["key"] = rng.integers(0, max(k // 2, 1), (v, b)).astype(np.int32)
    elif case == "out_of_range_full":
        ops["key"] = np.where(rng.random((v, b)) < 0.5,
                              rng.integers(k, 2 * k, (v, b)),
                              rng.integers(-2 * k, -k, (v, b))
                              ).astype(np.int32)
        ops["a1"] = rng.integers(8, 12, (v, b)).astype(np.int32)
    elif case == "int32_max":
        rows = st["valid"].reshape(-1, c)
        for f in ("tag_rep", "tag_ctr", "elem"):
            st[f] = st[f].reshape(-1, c)
        for r in np.nonzero(rng.random(rows.shape[0]) < 0.5)[0]:
            free = np.nonzero(~rows[r])[0]
            for j in free[rng.random(free.size) < 0.5]:
                rows[r, j] = True
                st["tag_rep"][r, j] = st["tag_ctr"][r, j] = SENTINEL
                st["elem"][r, j] = rng.integers(0, 8)
        st = {f: x.reshape(v, k, c) for f, x in st.items()}
        st["valid"] = rows.reshape(v, k, c)
        hit = rng.random((v, b)) < 0.3
        ops["a1"] = np.where(hit, SENTINEL, ops["a1"]).astype(np.int32)
        ops["a2"] = np.where(hit, SENTINEL, ops["a2"]).astype(np.int32)
    elif case == "exact_fill":
        st = orset_slots(rng, (v, k), c, full_rows=1.0)
        st["valid"][..., -1] = st["removed"][..., -1] = False
        st["tag_rep"][..., -1] = st["tag_ctr"][..., -1] = SENTINEL
        st["elem"][..., -1] = 0
        ops["op"][:] = 1
        lane = np.arange(b)
        ops["key"] = np.broadcast_to(rng.permutation(k)[lane // 2 % k],
                                     (v, b)).astype(np.int32)
        ops["a1"] = rng.integers(8, 12, (v, b)).astype(np.int32)
        ops["a2"] = np.broadcast_to(lane + 1, (v, b)).astype(np.int32)
    if r_cap:
        cap = (v, b, r_cap)
        ops["rm_rep"] = np.where(rng.random(cap) < 0.1, SENTINEL,
                                 rng.integers(0, 4, cap)).astype(np.int32)
        ops["rm_ctr"] = rng.integers(1, c + 2, cap).astype(np.int32)
        ops["rm_elem"] = rng.integers(0, 8, cap).astype(np.int32)
        if r_cap > 1:
            for f in ("rm_rep", "rm_ctr", "rm_elem"):
                ops[f][..., 1] = ops[f][..., 0]
    return st, {f: np.ascontiguousarray(x, np.int32) for f, x in ops.items()}


def with_capture_hazards(rng: np.random.Generator, ops: dict) -> dict:
    """A captured op batch (numpy, ``[..., B]`` fields with ``[..., B, R]``
    captures, B >= 8) with the replay's hazards mixed in: 10% of the
    captured lanes SENTINEL, and lanes 5-7 turned into removes of lane 1's
    key that capture lane 1's tag (so one tag arrives up to four times)."""
    out = {f: np.array(x, copy=True) for f, x in ops.items()}
    holes = rng.random(out["rm_rep"].shape) < 0.1
    out["rm_rep"] = np.where(holes, SENTINEL, out["rm_rep"]).astype(np.int32)
    for f, src in (("rm_rep", "a1"), ("rm_ctr", "a2"), ("rm_elem", "a0")):
        out[f][..., 5:8, 0] = out[src][..., 1:2]
    out["op"][..., 5:8] = orset.OP_REMOVE
    out["key"][..., 5:8] = out["key"][..., 1:2]
    return out


# the replay's edge cases of ``orset_replay_case``
ORSET_REPLAY_CASES = ("mixed", "hot_key", "unsorted_rows", "four_copies",
                      "sentinel_tags", "negative_keys", "past_rows",
                      "exact_fill")


def orset_replay_case(rng: np.random.Generator, case: str, shape,
                      num_keys: int, capacity: int, r_cap: int):
    """``(state, ops)`` for one of ``ORSET_REPLAY_CASES``: OR-Set slot rows
    ``[V, K, C]`` and a captured op batch (``[V, B]`` fields, ``rm_rep``,
    ``rm_ctr``, ``rm_elem`` ``[V, B, R]``) as numpy arrays, the edge cases
    of a replay that merges each row's sorted op records into its sorted
    state. A remove or clear captures up to R tags, most of its row's
    (its elems with them), some of the batch's adds, 10% SENTINEL holes.

    - ``mixed``: every op code, keys in [0, K), canonical rows;
    - ``hot_key``: 90% of the lanes on key 0 (its bucket overflows);
    - ``unsorted_rows``: shuffled rows, junk in invalid slots, a tag twice
      in half the rows;
    - ``four_copies``: adds of their row's state tags (with other elems),
      and lanes 5-7 removes capturing lane 1's tag (four copies of it);
    - ``sentinel_tags``: a valid state tag (INT32_MAX, INT32_MAX) closing
      a third of the rows, adds of it and of (INT32_MAX, x);
    - ``negative_keys``: every key in [-K, 0) (records lost, drops
      counted per key value);
    - ``past_rows``: 80% of the keys in [K, 2K) (ignored);
    - ``exact_fill``: each row's new distinct tags fill it exactly to C
      (even rows) or one past it (odd rows: one drop).
    """
    v, b = shape
    k, c, r = num_keys, capacity, r_cap
    canonical = case != "unsorted_rows"
    st = orset_slots(rng, (v, k), c, canonical=canonical, full_rows=0.3,
                     dup_rows=0.5, removed=0.3)
    ops = orset_mixed_ops(rng, (v, b), k, c, hazards=False)
    if case == "hot_key":
        ops["key"][:, : 9 * b // 10] = 0
    elif case == "negative_keys":
        ops["key"] = rng.integers(-k, 0, (v, b)).astype(np.int32)
    elif case == "past_rows":
        past = rng.random((v, b)) < 0.8
        ops["key"] = np.where(past, rng.integers(k, 2 * k, (v, b)),
                              ops["key"]).astype(np.int32)
    elif case == "exact_fill":
        ops = {f: np.zeros((v, b), np.int32) for f in ops}
        for vi in range(v):
            lane = 0
            for ki in range(k):
                free = c - int(st["valid"][vi, ki].sum()) + ki % 2
                for j in range(free):
                    if lane >= b:
                        break
                    ops["op"][vi, lane] = orset.OP_ADD
                    ops["key"][vi, lane] = ki
                    ops["a0"][vi, lane] = j
                    ops["a1"][vi, lane] = 9
                    ops["a2"][vi, lane] = 1000 * ki + j
                    lane += 1
    vi = np.arange(v)[:, None, None]
    row = np.clip(ops["key"], 0, k - 1)[..., None]
    slot = rng.integers(0, c, (v, b, r)) if c else np.zeros((v, b, r), int)
    if c:
        got = {f: st[f][vi, row, slot] for f in ("tag_rep", "tag_ctr", "elem",
                                                 "valid")}
    else:
        got = {"tag_rep": np.full((v, b, r), SENTINEL),
               "tag_ctr": np.zeros((v, b, r)), "elem": np.zeros((v, b, r)),
               "valid": np.zeros((v, b, r), bool)}
    other = rng.integers(0, b, (v, b, r))
    from_ops = rng.random((v, b, r)) < 0.2
    rm_rep = np.where(from_ops, ops["a1"][vi, other],
                      np.where(got["valid"], got["tag_rep"], SENTINEL))
    rm_ctr = np.where(from_ops, ops["a2"][vi, other], got["tag_ctr"])
    rm_elem = np.where(from_ops, ops["a0"][vi, other], got["elem"])
    rm_rep = np.where(rng.random((v, b, r)) < 0.1, SENTINEL, rm_rep)
    ops.update(rm_rep=rm_rep.astype(np.int32), rm_ctr=rm_ctr.astype(np.int32),
               rm_elem=rm_elem.astype(np.int32))
    if case == "four_copies" and b >= 8:
        own = rng.random((v, b)) < 0.5
        s0 = slot[..., 0]
        ops["a1"] = np.where(own, st["tag_rep"][vi[..., 0], row[..., 0], s0],
                             ops["a1"]).astype(np.int32)
        ops["a2"] = np.where(own, st["tag_ctr"][vi[..., 0], row[..., 0], s0],
                             ops["a2"]).astype(np.int32)
        ops["a0"] = (ops["a0"] + 3).astype(np.int32)
        ops = with_capture_hazards(rng, ops)
    elif case == "sentinel_tags" and c:
        n = st["valid"].sum(-1)
        for vi_, ki in zip(*np.nonzero((n > 0) & (rng.random((v, k)) < 0.3))):
            st["tag_rep"][vi_, ki, n[vi_, ki] - 1] = SENTINEL
            st["tag_ctr"][vi_, ki, n[vi_, ki] - 1] = SENTINEL
        big = rng.random((v, b)) < 0.2
        ops["a1"] = np.where(big, SENTINEL, ops["a1"]).astype(np.int32)
        ops["a2"] = np.where(big & (rng.random((v, b)) < 0.5), SENTINEL,
                             ops["a2"]).astype(np.int32)
    return st, ops


def rga_text_replay(rng: np.random.Generator, num_replicas: int,
                    num_keys: int, lanes: int, lag: int, tick: int) -> dict:
    """One tick of the harness's RGA replay (harness preset ``rga``,
    BASELINE config 5): int32 numpy ``[R, 2L]`` op fields. Lanes ``j < L``
    insert ``rng.integers(32, 127)`` at the root of document ``(v + j + t)
    % K`` (replica v); from tick ``lag`` on, lanes ``L + j`` delete replica
    v's own insert of tick ``t - lag`` (id ``(t - lag + 1, v)``: every
    document takes an insert every tick, so its converged counter after
    tick t' is t' + 1). The same draws, in the same order, as the JAX
    harness's ``gen(t)`` when called for t = 0, 1, ... on one generator."""
    R, L, K, t = num_replicas, lanes, num_keys, tick
    vs = np.arange(R, dtype=np.int32)[:, None]
    js = np.arange(L, dtype=np.int32)[None, :]
    shape = (R, 2 * L)
    out = {f: np.zeros(shape, np.int32) for f in base.OP_FIELDS}
    out["op"][:, :L] = rga.OP_INSERT
    out["key"][:, :L] = (vs + js + t) % K
    out["a0"][:, :L] = rng.integers(32, 127, (R, L))
    if t >= lag:
        out["op"][:, L:] = rga.OP_DELETE
        out["key"][:, L:] = (vs + js + t - lag) % K
        out["a1"][:, L:] = vs
        out["a2"][:, L:] = t - lag + 1
    out["writer"][:] = vs
    return out


def rga_churn(num_nodes: int, ops_per_block: int, num_keys: int, tick: int,
              minted=None) -> dict:
    """Round ``tick`` of the RGA's consensus churn (BASELINE config 5's
    shape, janus_tpu/bench/harness.py:1800-1824, through SafeKV): int32
    numpy ``[N, B]`` op fields, node v's block in row v. Lanes ``j < L =
    B // 2`` insert chr ``32 + (7v + 3j + t) % 95`` into document ``(v +
    j + t) % K``: even lanes at the root, odd lanes after the node's own
    insert of round ``t - 1`` at lane ``j + 1`` (the same document). Lanes
    ``L + j`` delete the node's own insert of round ``t - 2`` at lane j.
    An insert's id is ``(v, counter)``, its counter minted at submit, so
    ``minted`` maps a round to its insert lanes' counters (int32 ``[N,
    L]``, the ``eff_ctr`` its blocks carried); an anchor or a delete whose
    round is missing there falls back to the root or a no-op. Those
    counters depend on the insert lanes alone (the document's Lamport
    floor survives compaction), so a first run of the inserts without
    ``minted`` records them."""
    minted = minted or {}
    N, L, K, t = num_nodes, ops_per_block // 2, num_keys, tick
    vs = np.arange(N)[:, None]
    js = np.arange(L)[None, :]
    out = {f: np.zeros((N, ops_per_block), np.int32) for f in base.OP_FIELDS}
    out["writer"][:] = vs
    out["op"][:, :L] = rga.OP_INSERT
    out["key"][:, :L] = (vs + js + t) % K
    out["a0"][:, :L] = 32 + (7 * vs + 3 * js + t) % 95
    prev = minted.get(t - 1)
    if prev is not None and L > 1:
        odd = np.arange(1, L - 1, 2)  # lanes whose lane j + 1 exists
        out["a1"][:, odd] = vs
        out["a2"][:, odd] = prev[:, odd + 1]
    old = minted.get(t - 2)
    if old is not None:
        out["op"][:, L:] = rga.OP_DELETE
        out["key"][:, L:] = (vs + js + t - 2) % K
        out["a1"][:, L:] = vs
        out["a2"][:, L:] = old
    return out


def rga_slots(rng: np.random.Generator, shape, capacity: int,
              full_rows: float = 0.25, fill: float = 0.7, reps: int = 4,
              dead: float = 0.3, canonical: bool = True,
              dup_rows: float = 0.0, chain: float = 0.4,
              dangling: float = 0.05, negative: float = 0.0) -> dict:
    """Random RGA slot rows ``shape + (capacity,)`` as numpy arrays (the
    seven fields of ``rga.FIELDS``).

    A ``full_rows`` share of rows is full, the rest hold up to ``fill`` of
    the capacity. Ids are distinct within a row: ``reps`` writers,
    counters from 1 (a ``negative`` share of them negated). Each element's
    parent is the element before it in id order with probability
    ``chain`` (deep chains), a ``dangling`` id not in the row, the root,
    or a random element of the row (itself and later ones included, so
    cycles occur). Canonical rows are sorted by id with SENTINEL keys and
    zero payloads in invalid slots. Otherwise slots are shuffled, invalid
    slots hold junk, and a ``dup_rows`` share of rows repeats one valid id
    in a second slot."""
    c = capacity
    rows = int(np.prod(shape, dtype=np.int64))
    space = max(4 * c, reps)
    pick = np.argsort(rng.random((rows, space)), axis=1)[:, :c]
    n = np.where(rng.random(rows) < full_rows, c,
                 rng.integers(0, int(fill * c) + 1, rows))
    valid = np.arange(c)[None, :] < n[:, None]
    code = np.where(valid, pick, space)
    code.sort(axis=1)
    ctr = code // reps + 1
    ctr = np.where(rng.random((rows, c)) < negative, -ctr, ctr)
    rep = code % reps
    order = np.lexsort((rep, ctr, ~valid), axis=1)
    ctr = np.take_along_axis(ctr, order, 1)
    rep = np.take_along_axis(rep, order, 1)
    # parents: previous element, dangling id, root, or any element
    u = rng.random((rows, c))
    anyone = rng.integers(0, np.maximum(n, 1)[:, None], (rows, c))
    prev = np.maximum(np.arange(c)[None, :] - 1, 0)
    src = np.where(u < chain, prev, anyone)
    p_ctr = np.take_along_axis(ctr, src, 1)
    p_rep = np.take_along_axis(rep, src, 1)
    root = (u >= chain) & (u < chain + 0.15)
    dang = (u >= chain + 0.15) & (u < chain + 0.15 + dangling)
    first = np.arange(c)[None, :] == 0
    p_ctr = np.where(root | first, 0, np.where(dang, space + 7, p_ctr))
    p_rep = np.where(root | first, 0, np.where(dang, reps + 1, p_rep))
    chars = rng.integers(32, 127, (rows, c))
    out = {"id_ctr": np.where(valid, ctr, SENTINEL),
           "id_rep": np.where(valid, rep, SENTINEL),
           "par_ctr": np.where(valid, p_ctr, 0),
           "par_rep": np.where(valid, p_rep, 0),
           "chr": np.where(valid, chars, 0),
           "dead": valid & (rng.random((rows, c)) < dead), "valid": valid}
    if not canonical:
        junk = ~valid
        for f in ("id_ctr", "id_rep", "par_ctr", "par_rep", "chr"):
            out[f] = np.where(junk, rng.integers(-5, 5, (rows, c)), out[f])
        out["dead"] = np.where(junk, rng.random((rows, c)) < 0.5, out["dead"])
        for r in np.nonzero((rng.random(rows) < dup_rows) & (n >= 2))[0]:
            s, d = rng.choice(n[r], 2, replace=False)
            for f in ("id_ctr", "id_rep"):
                out[f][r, d] = out[f][r, s]
        perm = np.argsort(rng.random((rows, c)), axis=1)
        out = {f: np.take_along_axis(x, perm, 1) for f, x in out.items()}
    return {f: np.ascontiguousarray(out[f].reshape(tuple(shape) + (c,)),
                                    bool if f in ("dead", "valid") else np.int32)
            for f in rga.FIELDS}


# the capture's edge cases of ``orset_capture_case``
ORSET_CAPTURE_CASES = ("minted", "long_walk", "descending", "key_alias",
                       "repeat_tag", "noncanonical")


def orset_capture_case(rng: np.random.Generator, case: str, shape,
                       num_keys: int, capacity: int) -> tuple:
    """``(state, ops)`` for one of ``ORSET_CAPTURE_CASES``: OR-Set slot rows
    ``shape[:-1] + (num_keys, capacity)`` and op lanes ``shape`` (numpy),
    the edge cases of a capture that buckets the adds by row and walks a
    remove's bucket:

    - ``minted``: canonical rows; adds with tags minted in lane order per
      view (so every bucket is in tag order), removes and a few clears on
      uniform keys;
    - ``long_walk``: every lane on key 0; adds of elems 1..63 but about
      eight of elem 0, and removes of elem 0, so a remove walks nearly all
      earlier adds to find its few matches;
    - ``descending``: adds whose tags descend with lane (every bucket needs
      its sort), on a few keys;
    - ``key_alias``: keys -1, K - 1, K, 2K - 1, -K and 0, which gather two
      rows, while a lane matches only adds of its own raw key;
    - ``repeat_tag``: adds that carry tags of their key's row (the state's
      copy must come first) and tags repeated within the batch;
    - ``noncanonical``: shuffled rows with junk in invalid slots and a tag
      twice in a row (the state prefix out of tag order), hazard ops."""
    *lead, b = shape
    k, c = num_keys, capacity
    canonical = case != "noncanonical"
    st = orset_slots(rng, tuple(lead) + (k,), c, full_rows=0.3, fill=0.8,
                     num_elems=8, canonical=canonical, dup_rows=0.4)
    if case == "noncanonical":
        return st, orset_mixed_ops(rng, shape, k, c)
    op = rng.choice([orset.OP_ADD, orset.OP_REMOVE, orset.OP_CLEAR], shape,
                    p=[0.5, 0.45, 0.05])
    key = rng.integers(0, k, shape)
    elem = rng.integers(0, 8, shape)
    lane = np.broadcast_to(np.arange(b), shape)
    a1 = np.broadcast_to(np.arange(int(np.prod(lead, dtype=np.int64)))
                         .reshape(tuple(lead) + (1,)) % 4 + 4, shape)
    a2 = lane + 1
    if case == "long_walk":
        key = np.zeros(shape, np.int64)
        op = np.where(rng.random(shape) < 0.5, orset.OP_ADD, orset.OP_REMOVE)
        op = np.where(rng.random(shape) < 0.01, orset.OP_CLEAR, op)
        elem = np.where(op == orset.OP_ADD, 1 + lane % 63, 0)
        rare = lane % max(7, b // 8) == 0  # about eight adds of elem 0
        elem = np.where((op == orset.OP_ADD) & rare, 0, elem)
    elif case == "descending":
        key = rng.integers(0, min(k, 3), shape)
        a2 = b + 5 - lane
    elif case == "key_alias":
        key = rng.choice(np.array([-1, k - 1, k, 2 * k - 1, -k, 0]), shape)
    elif case == "repeat_tag":
        row = np.where(key < 0, key + k, key)
        slot = rng.integers(0, c, shape)
        lead_ix = np.indices(shape)[:-1]
        have = st["valid"][(*lead_ix, row, slot)]
        own = have & (rng.random(shape) < 0.6)
        a1 = np.where(own, st["tag_rep"][(*lead_ix, row, slot)], a1)
        a2 = np.where(own, st["tag_ctr"][(*lead_ix, row, slot)], a2)
        elem = np.where(own, st["elem"][(*lead_ix, row, slot)], elem)
        twin = rng.random(shape) < 0.2  # a tag of an earlier lane again
        src = (lane * rng.random(shape)).astype(np.int64)
        a1 = np.where(twin, np.take_along_axis(a1, src, -1), a1)
        a2 = np.where(twin, np.take_along_axis(a2, src, -1), a2)
    elif case != "minted":
        raise ValueError(f"unknown capture case {case!r}")
    is_add = op == orset.OP_ADD
    return st, _op_batch(shape, op=op, key=key, a0=elem,
                         a1=np.where(is_add, a1, 0),
                         a2=np.where(is_add, a2, 0))


# the union's edge cases of ``orset_union_case``
ORSET_UNION_CASES = ("shared_tags", "one_unsorted", "reversed", "shuffled",
                     "hole", "repeat_in_row", "full")


def _orset_subset(rng: np.random.Generator, rows: dict, share: float,
                  fresh_payloads: bool) -> dict:
    """The valid slots of canonical OR-Set ``rows`` each kept with
    probability ``share``, packed to the front in their order and made
    canonical; with ``fresh_payloads`` the kept ones get new elems and
    tombstones."""
    keep = rows["valid"] & (rng.random(rows["valid"].shape) < share)
    order = np.argsort(~keep, axis=-1, kind="stable")
    out = {f: np.take_along_axis(x, order, -1) for f, x in rows.items()}
    valid = np.take_along_axis(keep, order, -1)
    if fresh_payloads:
        out["elem"] = rng.integers(0, 8, valid.shape).astype(np.int32)
        out["removed"] = rng.random(valid.shape) < 0.5
    for f in ("tag_rep", "tag_ctr"):
        out[f] = np.where(valid, out[f], SENTINEL).astype(np.int32)
    out["elem"] = np.where(valid, out["elem"], 0).astype(np.int32)
    out["removed"] = valid & out["removed"]
    out["valid"] = valid
    return out


def orset_union_case(rng: np.random.Generator, case: str, shape,
                     capacity: int) -> tuple:
    """Rows ``a``, ``b`` ``shape + (capacity,)`` (numpy, the five OR-Set
    slot fields) for one of ``ORSET_UNION_CASES``, the edge cases of a
    union that merges rows sorted by tag:

    - ``shared_tags``: two canonical rows drawn from one pool, so they
      share tags whose elems and tombstones differ;
    - ``one_unsorted``: those rows with b's slots shuffled (a sorted, b
      not);
    - ``reversed``: both rows reversed;
    - ``shuffled``: both shuffled, junk in invalid slots;
    - ``hole``: canonical rows with an invalid slot (junk keys) in the
      middle of the valid prefix;
    - ``repeat_in_row``: canonical rows with one tag in two neighbouring
      slots of one row;
    - ``full``: full canonical rows with distinct tags, Ca + Cb kept."""
    c = capacity
    if case == "full":
        a = orset_slots(rng, shape, c, full_rows=1.0)
        b = orset_slots(rng, shape, c, full_rows=1.0)
        b["tag_rep"] = b["tag_rep"] + 4  # distinct from a's, order kept
        return a, b
    pool = orset_slots(rng, shape, c, full_rows=0.3, fill=0.9)
    a = _orset_subset(rng, pool, 0.6, False)
    b = _orset_subset(rng, pool, 0.6, True)
    perm = lambda x: np.argsort(rng.random(x.shape), axis=-1)  # noqa: E731
    if case == "one_unsorted":
        order = perm(b["valid"])
        b = {f: np.take_along_axis(x, order, -1) for f, x in b.items()}
    elif case == "reversed":
        a = {f: np.ascontiguousarray(x[..., ::-1]) for f, x in a.items()}
        b = {f: np.ascontiguousarray(x[..., ::-1]) for f, x in b.items()}
    elif case == "shuffled":
        for row in (a, b):
            junk = ~row["valid"]
            for f in ("tag_rep", "tag_ctr", "elem"):
                row[f] = np.where(junk, rng.integers(-5, 5, junk.shape),
                                  row[f]).astype(np.int32)
            row["removed"] = np.where(junk, rng.random(junk.shape) < 0.5,
                                      row["removed"])
            order = perm(row["valid"])
            for f in row:
                row[f] = np.take_along_axis(row[f], order, -1)
    elif case == "hole":
        for row in (a, b):
            n = row["valid"].sum(-1)
            at = rng.integers(1, np.maximum(n - 1, 2))
            hole = (np.arange(c) == at[..., None]) & (n >= 3)[..., None]
            row["valid"] = row["valid"] & ~hole
            row["tag_rep"] = np.where(hole, rng.integers(-5, 5, hole.shape),
                                      row["tag_rep"]).astype(np.int32)
    elif case == "repeat_in_row":
        for row in (a, b):
            n = row["valid"].sum(-1)
            at = rng.integers(1, np.maximum(n, 2))
            dup = (np.arange(c) == at[..., None]) & (n >= 2)[..., None]
            for f in ("tag_rep", "tag_ctr"):
                prev = np.concatenate([row[f][..., :1], row[f][..., :-1]], -1)
                row[f] = np.where(dup, prev, row[f]).astype(np.int32)
    elif case != "shared_tags":
        raise ValueError(f"unknown union case {case!r}")
    return a, b

# the union's edge cases of ``rga_union_case``
RGA_UNION_CASES = ("sorted", "tail_sorted", "tail_random", "reversed",
                   "random", "hole", "sentinel", "all_invalid", "full")


def _rga_subset(rng: np.random.Generator, rows: dict, share: float,
                fresh_payloads: bool) -> dict:
    """The valid slots of canonical RGA ``rows`` each kept with
    probability ``share``, packed to the front in their order and made
    canonical; with ``fresh_payloads`` the kept ones get new parents,
    chars and tombstones."""
    keep = rows["valid"] & (rng.random(rows["valid"].shape) < share)
    order = np.argsort(~keep, axis=-1, kind="stable")
    out = {f: np.take_along_axis(x, order, -1) for f, x in rows.items()}
    valid = np.take_along_axis(keep, order, -1)
    if fresh_payloads:
        for f, hi in (("par_ctr", 50), ("par_rep", 6), ("chr", 127)):
            out[f] = rng.integers(0, hi, valid.shape).astype(np.int32)
        out["dead"] = rng.random(valid.shape) < 0.5
    for f in ("id_ctr", "id_rep"):
        out[f] = np.where(valid, out[f], SENTINEL).astype(np.int32)
    for f in ("par_ctr", "par_rep", "chr"):
        out[f] = np.where(valid, out[f], 0).astype(np.int32)
    out["dead"] = valid & out["dead"]
    out["valid"] = valid
    return out


def rga_union_case(rng: np.random.Generator, case: str, shape,
                   capacity: int) -> tuple:
    """Rows ``a``, ``b`` ``shape + (capacity,)`` (numpy, the seven fields
    of ``rga.FIELDS``) for one of ``RGA_UNION_CASES``, the edge cases of a
    union that merges sorted rows:

    - ``sorted``: two sorted rows drawn from one pool of ids, so they
      share ids whose parents, chars and tombstones differ;
    - ``tail_sorted`` / ``tail_random``: those rows with fresh ids in
      their free slots, above every id of the row (an apply's mint, still
      sorted) or random (a sorted prefix and an unsorted tail);
    - ``reversed``: those rows with their slots reversed;
    - ``random``: shuffled rows with junk in invalid slots and an id
      repeated within a row, half of b's ids copied from a;
    - ``hole``: sorted rows with an invalid slot (junk keys) in the middle
      of the valid prefix;
    - ``sentinel``: sorted rows whose last valid id is (INT32_MAX,
      INT32_MAX) or (INT32_MAX, 2), tying with the invalid slots' key;
    - ``all_invalid``: every slot of a invalid (junk fields), half of b's
      rows too;
    - ``full``: full sorted rows with distinct ids, Ca + Cb kept."""
    c = capacity
    if case == "random":
        a = rga_slots(rng, shape, c, canonical=False, dup_rows=0.4,
                      full_rows=0.5, negative=0.1)
        b = rga_slots(rng, shape, c, canonical=False, dup_rows=0.4,
                      full_rows=0.5, negative=0.1)
        take = rng.random(tuple(shape) + (c,)) < 0.5
        for f in ("id_ctr", "id_rep", "valid"):
            b[f] = np.where(take, a[f], b[f])
        return a, b
    if case == "full":
        a = rga_slots(rng, shape, c, full_rows=1.0, negative=0.1)
        b = rga_slots(rng, shape, c, full_rows=1.0, negative=0.1)
        b["id_rep"] = b["id_rep"] + 4  # distinct from a's, order kept
        return a, b
    pool = rga_slots(rng, shape, c, full_rows=0.3, fill=0.9, negative=0.1)
    a = _rga_subset(rng, pool, 0.6, False)
    b = _rga_subset(rng, pool, 0.6, True)
    if case in ("tail_sorted", "tail_random"):
        for row in (a, b):
            n = row["valid"].sum(-1)
            m = rng.integers(0, c - n + 1)  # free slots after the prefix
            at = np.arange(c)
            free = (at >= n[..., None]) & (at < (n + m)[..., None])
            if case == "tail_sorted":
                top = np.where(row["valid"], row["id_ctr"], 0).max(-1)
                ctr = top[..., None] + 1 + np.cumsum(free, -1)
            else:
                ctr = rng.integers(-5, 3 * c, free.shape)
            row["id_ctr"] = np.where(free, ctr, row["id_ctr"]).astype(np.int32)
            row["id_rep"] = np.where(free, rng.integers(0, 4, free.shape),
                                     row["id_rep"]).astype(np.int32)
            row["par_ctr"] = np.where(free, 0, row["par_ctr"]).astype(np.int32)
            row["chr"] = np.where(free, rng.integers(32, 127, free.shape),
                                  row["chr"]).astype(np.int32)
            row["valid"] = row["valid"] | free
    elif case == "reversed":
        a = {f: np.ascontiguousarray(x[..., ::-1]) for f, x in a.items()}
        b = {f: np.ascontiguousarray(x[..., ::-1]) for f, x in b.items()}
    elif case == "hole":
        for row in (a, b):
            n = row["valid"].sum(-1)
            at = rng.integers(1, np.maximum(n - 1, 2))
            hole = (np.arange(c) == at[..., None]) & (n >= 3)[..., None]
            row["valid"] = row["valid"] & ~hole
            row["id_ctr"] = np.where(hole, rng.integers(-5, 5, hole.shape),
                                     row["id_ctr"]).astype(np.int32)
    elif case == "sentinel":
        for row, rep in ((a, SENTINEL), (b, 2)):
            n = row["valid"].sum(-1)
            last = (np.arange(c) == (n - 1)[..., None]) & (n >= 1)[..., None]
            pick = last & (rng.random(n.shape) < 0.7)[..., None]
            row["id_ctr"] = np.where(pick, SENTINEL, row["id_ctr"]).astype(
                np.int32)
            row["id_rep"] = np.where(pick, rep, row["id_rep"]).astype(np.int32)
        b["id_rep"] = np.where(b["valid"] & (b["id_ctr"] == SENTINEL)
                               & (rng.random(b["valid"].shape) < 0.5),
                               SENTINEL, b["id_rep"]).astype(np.int32)
    elif case == "all_invalid":
        junk = rga_slots(rng, shape, c, canonical=False, fill=1.0)
        a = {**junk, "valid": np.zeros_like(junk["valid"])}
        empty = (rng.random(tuple(shape)) < 0.5)[..., None]
        b["valid"] = b["valid"] & ~empty
    elif case != "sorted":
        raise ValueError(f"unknown union case {case!r}")
    return a, b


# the compaction's edge cases of ``rga_compact_case``
RGA_COMPACT_CASES = ("sorted", "descent", "hole", "duplicates", "sentinel",
                     "self_parent", "absent", "dead_chains")


def rga_compact_case(rng: np.random.Generator, case: str, shape,
                     capacity: int) -> tuple:
    """``(rows, protect)`` for one of ``RGA_COMPACT_CASES``, the edge cases
    of a compaction whose parent test searches a sorted row's ids: RGA rows
    ``shape + (capacity,)`` (numpy, the seven fields of ``rga.FIELDS``),
    their valid prefix sorted by id unless the case says otherwise, and a
    random protect mask (bool, a fifth of the slots).

    - ``sorted``: canonical rows, parents mostly the element before;
    - ``descent``: two adjacent valid slots swapped: one descent;
    - ``hole``: an invalid slot (junk id) inside the valid prefix;
    - ``duplicates``: a valid id repeated in the next slot (the row still
      sorted), both copies dead and referenced as a parent;
    - ``sentinel``: the last valid id (INT32_MAX, INT32_MAX), tying with
      the invalid slots' key, or (INT32_MAX, 2), dead and referenced;
    - ``self_parent``: elements that are their own parent, dead;
    - ``absent``: parents that name no valid slot: an invalid slot's junk
      id, or an id no slot holds;
    - ``dead_chains``: long chains, most of them dead, so dead interior
      elements anchor dead leaves."""
    c = capacity
    lead = tuple(shape)
    if case == "dead_chains":
        rows = rga_slots(rng, lead, c, full_rows=0.5, fill=0.9, chain=0.9,
                         dangling=0.0, dead=0.8, negative=0.1)
    else:
        rows = rga_slots(rng, lead, c, full_rows=0.3, fill=0.9, dead=0.6,
                         negative=0.1)
    protect = rng.random(lead + (c,)) < 0.2
    n = rows["valid"].sum(-1)
    at = np.arange(c)
    # one random valid slot i per row with room after it (i + 1 < n)
    i = (rng.random(lead) * np.maximum(n - 1, 1)).astype(np.int64)
    has = n >= 2
    here = (at == i[..., None]) & has[..., None]
    after = (at == (i + 1)[..., None]) & has[..., None]
    ids = ("id_ctr", "id_rep")
    pars = ("par_ctr", "par_rep")

    def refer(target, share):
        """A ``share`` of each row's valid slots take ``target`` ((ctr,
        rep) arrays of ``lead``) as their parent."""
        pick = rows["valid"] & (rng.random(lead + (c,)) < share)
        for f, t in zip(pars, target):
            rows[f] = np.where(pick, t[..., None], rows[f]).astype(np.int32)

    if case == "descent":
        for f in rga.FIELDS:
            x = rows[f]
            lo = np.take_along_axis(x, i[..., None], -1)
            hi = np.take_along_axis(x, np.minimum(i + 1, c - 1)[..., None], -1)
            rows[f] = np.where(here, hi, np.where(after, lo, x)).astype(x.dtype)
    elif case == "hole":
        hole = here & (n >= 3)[..., None]
        rows["valid"] = rows["valid"] & ~hole
        rows["dead"] = rows["dead"] & ~hole
        for f in ids:
            rows[f] = np.where(hole, rng.integers(-5, 5, hole.shape),
                               rows[f]).astype(np.int32)
    elif case == "duplicates":
        for f in ids:
            src = np.take_along_axis(rows[f], i[..., None], -1)
            rows[f] = np.where(after, src, rows[f]).astype(np.int32)
        rows["dead"] = rows["dead"] | here | after
        refer([np.take_along_axis(rows[f], i[..., None], -1)[..., 0]
               for f in ids], 0.05)
    elif case == "sentinel":
        last = (at == (n - 1)[..., None]) & (n >= 1)[..., None]
        rep = np.where(rng.random(lead) < 0.5, SENTINEL, 2)
        rows["id_ctr"] = np.where(last, SENTINEL, rows["id_ctr"]).astype(
            np.int32)
        rows["id_rep"] = np.where(last, rep[..., None],
                                  rows["id_rep"]).astype(np.int32)
        rows["dead"] = rows["dead"] | last
        refer([np.full(lead, SENTINEL), np.where(rng.random(lead) < 0.5,
                                                 SENTINEL, rep)], 0.05)
    elif case == "self_parent":
        own = rows["valid"] & (rng.random(lead + (c,)) < 0.3)
        for f, g in zip(pars, ids):
            rows[f] = np.where(own, rows[g], rows[f]).astype(np.int32)
        rows["dead"] = rows["dead"] | own
    elif case == "absent":
        junk = ~rows["valid"]
        for f in ids:
            rows[f] = np.where(junk, rng.integers(1, 4 * c, junk.shape),
                               rows[f]).astype(np.int32)
        j = rng.integers(0, c, lead + (c,))
        pick = rows["valid"] & (rng.random(lead + (c,)) < 0.3)
        nowhere = rng.random(lead + (c,)) < 0.5
        for f, g, far in zip(pars, ids, (8 * c + 11, 97)):
            target = np.where(nowhere, far, np.take_along_axis(rows[g], j, -1))
            rows[f] = np.where(pick, target, rows[f]).astype(np.int32)
        rows["dead"] = rows["dead"] | (rows["valid"]
                                       & (rng.random(lead + (c,)) < 0.3))
    elif case not in ("sorted", "dead_chains"):
        raise ValueError(f"unknown compaction case {case!r}")
    rows = {f: np.ascontiguousarray(x) for f, x in rows.items()}
    return rows, np.ascontiguousarray(protect)


def rga_mixed_ops(rng: np.random.Generator, shape, num_keys: int,
                  capacity: int, reps: int = 4, hazards: bool = True,
                  captured: bool = False) -> dict:
    """RGA op lanes of every code (0 no-op, 1 insert, 2 delete, 3 unknown)
    whose ids and parents collide with ``rga_slots``' ids and with each
    other's (deletes of absent ids land placeholders; a later insert of
    the same id folds into one), as int32 numpy arrays of ``shape``. With
    ``hazards``, keys fall in [-K, 2K) and a share of targets are negative
    or SENTINEL. With ``captured``, an ``eff_ctr`` ``shape + (1,)`` field
    repeats counters of present ids (re-inserts)."""
    k = num_keys
    ops = {
        "op": rng.choice(4, shape, p=[0.1, 0.5, 0.3, 0.1]),
        "key": (rng.integers(-k, 2 * k, shape) if hazards
                else rng.integers(0, k, shape)),
        "a0": rng.integers(32, 127, shape),
        "a1": rng.integers(0, reps, shape),
        "a2": rng.integers(0, capacity + 2, shape),
        "writer": rng.integers(0, reps, shape),
    }
    if hazards:
        odd = rng.random(shape)
        ops["a2"] = np.where(odd < 0.05, -ops["a2"],
                             np.where(odd < 0.08, SENTINEL, ops["a2"]))
    out = {f: v.astype(np.int32) for f, v in ops.items()}
    if captured:
        out["eff_ctr"] = rng.integers(1, capacity + 2,
                                      tuple(shape) + (1,)).astype(np.int32)
    return out


# the LWW-Set's stamps: microseconds since the Unix epoch at a fixed
# instant (2025-10-09T00:00:00Z), split as the JAX service mints them
LWW_EPOCH_US = 1_759_968_000_000_000


def lww_stamps(ts: np.ndarray):
    """``(hi, lo)`` int32 lanes of int64 microsecond stamps, as
    janus_tpu/net/service.py mints them: ``hi = ts >> 31``, ``lo = ts &
    0x7FFFFFFF``."""
    ts = np.asarray(ts, np.int64)
    return (ts >> 31).astype(np.int32), (ts & 0x7FFFFFFF).astype(np.int32)


def _hot_keys(rng: np.random.Generator, num_keys: int, shape, tick: int,
              hot: int, theta: float) -> np.ndarray:
    """Keys Zipf-skewed inside a window of ``hot`` keys that rotates by
    ``hot`` every tick (``orset_hot_window``'s keys)."""
    base_key = (tick * hot) % num_keys
    return (base_key + zipf_keys(rng, hot, shape, theta)) % num_keys


def lww_add_remove(rng: np.random.Generator, num_nodes: int, num_keys: int,
                   batch: int, tick: int, num_elems: int = 64,
                   add_ratio: float = 0.5, hot: int | None = None,
                   theta: float = 0.99) -> dict:
    """Round ``tick`` of the LWW-Set's add/remove traffic: int32 numpy ``[N,
    B]`` op fields, node (or replica) v's batch in row v, a 50/50
    add/remove mix over ``num_elems`` elements (``orset_add_remove``'s
    range) and uniform keys, or with ``hot`` keys Zipf(``theta``)-skewed in
    a rotating hot window (``orset_hot_window``'s). Node v stamps its j-th
    op of the round ``LWW_EPOCH_US + tick * B + j + 1`` microseconds:
    strictly increasing per node, and every node's clock starts at the one
    epoch, so equal stamps across nodes happen (the add-wins tie rule
    decides them)."""
    shape = (num_nodes, batch)
    is_add = rng.random(shape) < add_ratio
    op = np.where(is_add, lwwset.OP_ADD, lwwset.OP_REMOVE)
    ts = LWW_EPOCH_US + tick * batch + np.arange(1, batch + 1)[None, :]
    hi, lo = lww_stamps(np.broadcast_to(ts, shape))
    keys = (rng.integers(0, num_keys, shape) if hot is None
            else _hot_keys(rng, num_keys, shape, tick, hot, theta))
    return _op_batch(shape, op=op, key=keys,
                     a0=rng.integers(0, num_elems, shape), a1=hi, a2=lo,
                     writer=np.arange(num_nodes)[:, None])


def mvr_writes(rng: np.random.Generator, num_nodes: int, num_keys: int,
               batch: int, theta: float = 0.99,
               num_values: int = 1 << 20, hot: int | None = None,
               tick: int = 0) -> dict:
    """One round of MVRegister writes: int32 numpy ``[N, B]`` op fields,
    node (or replica) v's batch in row v, Zipf(``theta``) keys
    (``zipf_keys``; with ``hot``, inside the rotating hot window of round
    ``tick``), writer lane = the node, values drawn from ``[0,
    num_values)``."""
    shape = (num_nodes, batch)
    keys = (zipf_keys(rng, num_keys, shape, theta) if hot is None
            else _hot_keys(rng, num_keys, shape, tick, hot, theta))
    return _op_batch(shape, op=mvregister.OP_WRITE, key=keys,
                     a0=rng.integers(0, num_values, shape),
                     writer=np.arange(num_nodes)[:, None])


def lww_slots(rng: np.random.Generator, shape, capacity: int,
              full_rows: float = 0.25, fill: float = 0.6,
              num_elems: int | None = None, canonical: bool = True,
              dup_rows: float = 0.0, stamps: int = 4) -> dict:
    """Random LWW-Set slot rows ``shape + (capacity,)`` as numpy arrays (the
    six fields of ``lwwset.FIELDS``).

    A ``full_rows`` share of rows is full, the rest hold up to ``fill`` of
    the capacity; elems are distinct within a row, drawn from
    ``num_elems`` (default 2C). Stamps are (hi, lo) with hi in [0, 2) and
    lo one of ``stamps`` values around 0 and the int32 extremes (negative
    lo: the unsigned low word), a quarter of each polarity unstamped, so
    equal stamps and add/remove ties are common. Canonical rows are sorted
    by elem with SENTINEL keys and zero payloads in invalid slots.
    Otherwise slots are shuffled, invalid slots hold junk, and a
    ``dup_rows`` share of rows repeats one valid elem in a second slot."""
    c = capacity
    rows = int(np.prod(shape, dtype=np.int64))
    space = max(num_elems or 2 * c, c)
    pick = np.argsort(rng.random((rows, space)), axis=1)[:, :c]
    n = np.where(rng.random(rows) < full_rows, c,
                 rng.integers(0, int(fill * c) + 1, rows))
    valid = np.arange(c)[None, :] < n[:, None]
    elem = np.where(valid, pick, space)
    elem.sort(axis=1)
    valid = elem < space
    lows = np.array([0, 1, 2, -1, -(2**31), 2**31 - 1, 7, -5][:max(stamps, 1)])
    out = {"elem": np.where(valid, elem, SENTINEL)}
    for pol in ("add", "rm"):
        hi = rng.integers(0, 2, (rows, c))
        lo = rng.choice(lows, (rows, c))
        none = rng.random((rows, c)) < 0.25
        out[f"{pol}_hi"] = np.where(valid & ~none, hi, 0)
        out[f"{pol}_lo"] = np.where(valid & ~none, lo, 0)
    out["valid"] = valid
    if not canonical:
        junk = ~valid
        for f in ("elem", "add_hi", "add_lo", "rm_hi", "rm_lo"):
            out[f] = np.where(junk, rng.integers(-5, 5, (rows, c)), out[f])
        for r in np.nonzero((rng.random(rows) < dup_rows) & (n >= 2))[0]:
            src, dst = rng.choice(n[r], 2, replace=False)
            out["elem"][r, dst] = out["elem"][r, src]
        perm = np.argsort(rng.random((rows, c)), axis=1)
        out = {f: np.take_along_axis(x, perm, 1) for f, x in out.items()}
    return {f: np.ascontiguousarray(out[f].reshape(tuple(shape) + (c,)),
                                    bool if f == "valid" else np.int32)
            for f in lwwset.FIELDS}


def lww_mixed_ops(rng: np.random.Generator, shape, num_keys: int,
                  num_elems: int, hazards: bool = True,
                  captured: bool = False) -> dict:
    """LWW-Set op lanes of every code (0 no-op, 1 add, 2 remove, 3
    unknown) whose elems collide with ``lww_slots``' and with each
    other's, stamps as there (equal stamps and negative low words), as
    int32 numpy arrays of ``shape``. With ``hazards``, keys fall in [-2K,
    2K). With ``captured``, an ``ok`` ``shape + (1,)`` field is 0 or 1."""
    k = num_keys
    lows = np.array([0, 1, 2, -1, -(2**31), 2**31 - 1, 7, -5])
    ops = {
        "op": rng.choice(4, shape, p=[0.1, 0.45, 0.35, 0.1]),
        "key": (rng.integers(-2 * k, 2 * k, shape) if hazards
                else rng.integers(0, k, shape)),
        "a0": rng.integers(0, num_elems, shape),
        "a1": rng.integers(0, 2, shape),
        "a2": rng.choice(lows, shape),
        "writer": np.zeros(shape),
    }
    out = {f: v.astype(np.int32) for f, v in ops.items()}
    if captured:
        out["ok"] = rng.integers(0, 2, tuple(shape) + (1,)).astype(np.int32)
    return out


# the LWW-Set walk's edge cases of ``lww_walk_case``
LWW_WALK_CASES = ("hazards", "typed_store", "long_rows", "hot_row",
                  "full_drop")


def lww_walk_case(rng: np.random.Generator, case: str, shape,
                  num_keys: int, capacity: int, captured: bool = False):
    """``(state, ops)`` for one of ``LWW_WALK_CASES``: LWW-Set rows ``[V,
    K, C]`` and op lanes ``[V, B]`` (with ``ok`` ``[V, B, 1]`` when
    ``captured``) as numpy arrays, the edge cases of a walk that groups
    each view's live lanes by row and walks many rows a warp:

    - ``hazards``: non-canonical rows with duplicate elems, keys in [-2K,
      2K), every op code, equal stamps and negative low words;
    - ``typed_store``: typed_store's traffic, keys Zipf-skewed in a hot
      window of 32 keys, canonical rows;
    - ``long_rows``: 8 keys, every lane live (hundreds of lanes a row,
      past a window of records);
    - ``hot_row``: 90% of the lanes on row 1 (its bucket overflows);
    - ``full_drop``: full rows and adds and removes of absent elems (every
      enabled one drops).
    """
    v, b = shape
    k, c = num_keys, capacity
    canonical = case in ("typed_store", "full_drop")
    st = lww_slots(rng, (v, k), c, canonical=canonical, dup_rows=0.3,
                   full_rows=1.0 if case == "full_drop" else 0.4,
                   num_elems=2 * c)
    if case == "typed_store":
        ops = lww_add_remove(rng, v, k, b, 0, hot=32)
    else:
        ops = lww_mixed_ops(rng, (v, b), k, 2 * c,
                            hazards=case == "hazards")
    if case == "long_rows":
        ops["op"] = rng.integers(1, 3, (v, b)).astype(np.int32)
        ops["key"] = rng.integers(0, min(k, 8), (v, b)).astype(np.int32)
    elif case == "hot_row":
        ops["key"][:, : 9 * b // 10] = 1
    elif case == "full_drop":
        ops["a0"] = rng.integers(4 * c, 5 * c, (v, b)).astype(np.int32)
    ops = {f: np.array(ops[f], np.int32) for f in base.OP_FIELDS}
    if captured:
        ops["ok"] = rng.integers(0, 2, (v, b, 1)).astype(np.int32)
    return st, ops


def mvr_slots(rng: np.random.Generator, shape, capacity: int,
              num_writers: int, fill: float = 0.7, canonical: bool = True,
              span: int = 3, num_values: int = 4) -> dict:
    """Random MVRegister rows ``shape + (capacity,)`` as numpy arrays
    (``val``, ``valid``, ``clock`` with a trailing axis of ``num_writers``
    lanes): up to ``fill`` of the slots valid, values from
    ``num_values``, clock lanes from [-1, span) (dominated, equal and
    concurrent pairs all common). Canonical rows are the causal frontier
    of those entries (``kernels.mvr_rows.frontier``); otherwise the
    entries stay as drawn, invalid slots holding junk."""
    c, w = capacity, num_writers
    full = tuple(shape) + (c,)
    valid = rng.random(full) < fill
    val = rng.integers(0, num_values, full)
    clock = rng.integers(-1, span, full + (w,))
    if canonical:
        out, _ = frontier(torch.from_numpy(val.astype(np.int32)),
                          torch.from_numpy(valid),
                          torch.from_numpy(clock.astype(np.int32)), c)
        return {f: out[f].numpy().copy() for f in ("val", "valid", "clock")}
    return {"val": np.where(valid, val, rng.integers(-5, 5, full)).astype(np.int32),
            "valid": valid, "clock": clock.astype(np.int32)}


def mvr_mixed_ops(rng: np.random.Generator, shape, num_keys: int,
                  num_writers: int, hazards: bool = True,
                  captured: bool = False, num_values: int = 4,
                  span: int = 3) -> dict:
    """MVRegister op lanes (0 no-op, 1 write, 2 unknown) whose values
    collide with ``mvr_slots``' and with each other's, as int32 numpy
    arrays of ``shape``. With ``hazards``, keys fall in [-2K, 2K) and
    writers in [-2W, 2W). With ``captured``, a ``wclock`` ``shape + (W,)``
    field holds clocks in [-1, span) with 5% of the lanes at the int32
    extremes."""
    k, w = num_keys, num_writers
    ops = {
        "op": rng.choice(3, shape, p=[0.15, 0.75, 0.1]),
        "key": (rng.integers(-2 * k, 2 * k, shape) if hazards
                else rng.integers(0, k, shape)),
        "a0": rng.integers(0, num_values, shape),
        "a1": np.zeros(shape), "a2": np.zeros(shape),
        "writer": (rng.integers(-2 * w, 2 * w, shape) if hazards
                   else rng.integers(0, w, shape)),
    }
    out = {f: v.astype(np.int32) for f, v in ops.items()}
    if captured:
        clk = rng.integers(-1, span, tuple(shape) + (w,))
        ext = rng.random(clk.shape) < 0.05
        clk = np.where(ext, rng.choice([-(2**31), 2**31 - 1], clk.shape), clk)
        out["wclock"] = clk.astype(np.int32)
    return out


# the MVRegister walk's edge cases of ``mvr_walk_case``
MVR_WALK_CASES = ("long", "cut", "twins", "hazards")


def mvr_walk_case(rng: np.random.Generator, case: str, num_views: int,
                  num_keys: int, capacity: int, num_writers: int,
                  batch: int) -> tuple:
    """``(state, ops)`` for one of ``MVR_WALK_CASES``, the edge cases of
    the MVRegister's sequential apply: rows ``[V, K, capacity]`` with
    ``num_writers`` clock lanes (``mvr_slots``) and op lanes ``[V, batch]``
    with a captured ``wclock`` ``[V, batch, W]`` (numpy int32; drop it for
    the uncaptured apply and the capture).

    - ``long``: 95% of the lanes write key 1, a walk longer than one
      window of lane indices when ``batch`` > 2,156; clocks that grow
      every 8 lanes with concurrent noise, values from 8 (twins);
    - ``cut``: a quarter of the lanes write key 2, clocks in blocks of
      ``capacity + 3`` pairwise concurrent ones (a fixed lane sum), each
      block above the last, so that row's frontier passes V and falls
      back to one value many times;
    - ``twins``: lanes drawn from three (value, clock) pairs, which the
      first two rows also hold: exact twins of each other and of the
      rows' entries;
    - ``hazards``: non-canonical rows, every op code, keys in [-2K, 2K),
      writers in [-2W, 2W), wclocks at the int32 extremes."""
    V, K, vc, w, B = num_views, num_keys, capacity, num_writers, batch
    shape = (V, B)
    if case == "hazards":
        st = mvr_slots(rng, (V, K), vc, w, canonical=False)
        return st, mvr_mixed_ops(rng, shape, K, w, captured=True,
                                 num_values=8)
    st = mvr_slots(rng, (V, K), vc, w)
    b = np.arange(B)[None, :, None]
    if case == "long":
        key = np.where(rng.random(shape) < 0.95, 1, rng.integers(0, K, shape))
        a0 = rng.integers(0, 8, shape)
        clock = b // 8 + rng.integers(0, 2, shape + (w,))
    elif case == "cut":
        key = np.where(rng.random(shape) < 0.25, 2, rng.integers(0, K, shape))
        a0 = rng.integers(0, 40, shape)
        # blocks of vc + 3 of key 2's writes, in lane order
        block = (np.cumsum(key == 2, -1) - 1) // (vc + 3)
        parts = rng.multinomial(12, [1.0 / w] * w, size=shape)
        clock = 100 * block[..., None] + parts
    elif case == "twins":
        key = rng.integers(0, K, shape)
        pool_val = rng.integers(0, 4, 3)
        pool_clock = rng.integers(-1, 3, (3, w))
        pick = rng.integers(0, 3, shape)
        a0 = pool_val[pick]
        clock = pool_clock[pick]
        m = min(3, vc)
        st["val"][:, :2, :m] = pool_val[:m]
        st["clock"][:, :2, :m] = pool_clock[:m]
        st["valid"][:, :2, :m] = True
    else:
        raise ValueError(f"unknown walk case {case!r}")
    ops = _op_batch(shape, op=mvregister.OP_WRITE, key=key, a0=a0,
                    writer=rng.integers(0, w, shape))
    ops["wclock"] = np.ascontiguousarray(clock, np.int32)
    return st, ops


def tpset_add_remove(rng: np.random.Generator, num_nodes: int,
                     num_keys: int, batch: int, num_elems: int = 64,
                     add_ratio: float = 0.5, hot: int | None = None,
                     tick: int = 0, theta: float = 0.99) -> dict:
    """The 2P-Set's add/remove traffic: int32 numpy ``[N, B]`` op fields,
    node (or replica) v's batch in row v, a 50/50 add/remove mix over
    ``num_elems`` elements a key (``orset_add_remove``'s range, BASELINE
    config 2's mix) and uniform keys, or with ``hot`` keys
    Zipf(``theta``)-skewed in a hot window rotating with ``tick``."""
    shape = (num_nodes, batch)
    is_add = rng.random(shape) < add_ratio
    op = np.where(is_add, tpset.OP_ADD, tpset.OP_REMOVE)
    keys = (rng.integers(0, num_keys, shape) if hot is None
            else _hot_keys(rng, num_keys, shape, tick, hot, theta))
    return _op_batch(shape, op=op, key=keys,
                     a0=rng.integers(0, num_elems, shape),
                     writer=np.arange(num_nodes)[:, None])


# the Graph's op mix: (op code, share)
GRAPH_MIX = ((graph.OP_ADD_VERTEX, 0.30), (graph.OP_ADD_EDGE, 0.40),
             (graph.OP_REMOVE_EDGE, 0.15), (graph.OP_REMOVE_VERTEX, 0.15))


def graph_ops(rng: np.random.Generator, num_nodes: int, num_keys: int,
              batch: int, num_vertices: int = 32, out_degree: int = 8,
              hot: int | None = None, tick: int = 0,
              theta: float = 0.99) -> dict:
    """The Graph's traffic: int32 numpy ``[N, B]`` op fields, uniform keys
    (or Zipf-skewed in a rotating hot window with ``hot``), ``num_vertices``
    vertex ids a key, and the mix of ``GRAPH_MIX`` (av 30%, ae 40%, re 15%,
    rv 15%). A vertex op names a0 = v; an edge op a0 = src and a1 = dst =
    (src + 1 + j) mod ``num_vertices`` with j < ``out_degree``, so a key
    holds at most ``num_vertices * out_degree`` distinct edges."""
    shape = (num_nodes, batch)
    codes, shares = zip(*GRAPH_MIX)
    op = rng.choice(np.array(codes), shape, p=np.array(shares))
    keys = (rng.integers(0, num_keys, shape) if hot is None
            else _hot_keys(rng, num_keys, shape, tick, hot, theta))
    src = rng.integers(0, num_vertices, shape)
    dst = (src + 1 + rng.integers(0, out_degree, shape)) % num_vertices
    on_edge = (op == graph.OP_ADD_EDGE) | (op == graph.OP_REMOVE_EDGE)
    return _op_batch(shape, op=op, key=keys, a0=src,
                     a1=np.where(on_edge, dst, 0),
                     writer=np.arange(num_nodes)[:, None])


def tp_slots(rng: np.random.Generator, shape, capacity: int,
             full_rows: float = 0.25, fill: float = 0.6,
             num_elems: int | None = None, canonical: bool = True,
             dup_rows: float = 0.0, removed: float = 0.3,
             edges: bool = False) -> dict:
    """Random 2P slot rows ``shape + (capacity,)`` as numpy arrays: the TP
    layout (``elem``, ``removed``, ``valid``), or with ``edges`` the EDGE
    layout (``src``, ``dst``, ``removed``, ``valid``).

    A ``full_rows`` share of rows is full, the rest hold up to ``fill`` of
    the capacity; keys are distinct within a row, elems drawn from
    ``num_elems`` (default 2C), edges from ``[0, num_elems)^2`` (default
    num_elems the least whose square is 2C or more); a ``removed`` share of
    the valid slots holds a tombstone. Canonical rows are sorted by their
    keys with SENTINEL keys and no tombstone in invalid slots. Otherwise
    slots are shuffled, invalid slots hold junk, and a ``dup_rows`` share
    of rows repeats one valid key in a second slot."""
    c = capacity
    rows = int(np.prod(shape, dtype=np.int64))
    if edges:
        side = num_elems or int(np.ceil(np.sqrt(2 * c)))
        space = max(side * side, c)
    else:
        space = max(num_elems or 2 * c, c)
    pick = np.argsort(rng.random((rows, space)), axis=1)[:, :c]
    n = np.where(rng.random(rows) < full_rows, c,
                 rng.integers(0, int(fill * c) + 1, rows))
    valid = np.arange(c)[None, :] < n[:, None]
    ids = np.where(valid, pick, space)
    ids.sort(axis=1)
    valid = ids < space
    keys = ({"src": ids // side, "dst": ids % side} if edges
            else {"elem": ids})
    out = {f: np.where(valid, k, SENTINEL) for f, k in keys.items()}
    out["removed"] = valid & (rng.random((rows, c)) < removed)
    out["valid"] = valid
    if not canonical:
        junk = ~valid
        for f in keys:
            out[f] = np.where(junk, rng.integers(-5, 5, (rows, c)), out[f])
        out["removed"] |= junk & (rng.random((rows, c)) < 0.5)
        for r in np.nonzero((rng.random(rows) < dup_rows) & (n >= 2))[0]:
            src, dst = rng.choice(n[r], 2, replace=False)
            for f in keys:
                out[f][r, dst] = out[f][r, src]
        perm = np.argsort(rng.random((rows, c)), axis=1)
        out = {f: np.take_along_axis(x, perm, 1) for f, x in out.items()}
    fields = ("src", "dst", "removed", "valid") if edges else tpset.FIELDS
    return {f: np.ascontiguousarray(out[f].reshape(tuple(shape) + (c,)),
                                    bool if f in ("removed", "valid")
                                    else np.int32)
            for f in fields}


def graph_slots(rng: np.random.Generator, shape, v_capacity: int,
                e_capacity: int, num_vertices: int, at_max: float = 0.0,
                **kw) -> dict:
    """Random Graph rows as numpy arrays (the seven leaves of
    ``graph.FIELDS``): a vertex block of ``tp_slots`` over
    ``num_vertices`` ids and an edge block over the same ids, so endpoints
    are live, dead and absent alike; ``kw`` as for ``tp_slots`` (both
    blocks). An ``at_max`` share of the valid edge slots has one endpoint
    at INT32_MAX (the dangling-edge filter's sentinel quirk)."""
    vs = tp_slots(rng, shape, v_capacity, num_elems=num_vertices, **kw)
    es = tp_slots(rng, shape, e_capacity, num_elems=num_vertices,
                  edges=True, **kw)
    hit = es["valid"] & (rng.random(es["valid"].shape) < at_max)
    on_src = rng.random(hit.shape) < 0.5
    es["src"] = np.where(hit & on_src, SENTINEL, es["src"]).astype(np.int32)
    es["dst"] = np.where(hit & ~on_src, SENTINEL, es["dst"]).astype(np.int32)
    return {"v": vs["elem"], "v_removed": vs["removed"],
            "v_valid": vs["valid"], "src": es["src"], "dst": es["dst"],
            "e_removed": es["removed"], "e_valid": es["valid"]}


# the 2P unions' edge cases of ``tp_union_case``
TP_UNION_CASES = ("shared_elems", "appended_tail_1", "appended_tail_8",
                  "appended_tail_64", "one_unsorted", "reversed", "shuffled",
                  "hole", "triple_in_row", "sentinel_elem", "full")


def _tp_canonical(rng: np.random.Generator, rows: int, c: int, space: int,
                  n) -> np.ndarray:
    """Key ids ``[rows, c]``: row r holds ``n[r]`` distinct ids of
    ``[0, space)`` in ascending order, then ``space`` (no key)."""
    pick = np.argsort(rng.random((rows, space)), axis=1)[:, :c]
    ids = np.where(np.arange(c)[None, :] < n[:, None], pick, space)
    ids.sort(axis=1)
    return ids


def tp_union_case(rng: np.random.Generator, case: str, shape, capacity: int,
                  edges: bool = False) -> tuple:
    """Rows ``a``, ``b`` ``shape + (capacity,)`` (numpy, the TP layout's
    fields, or with ``edges`` the EDGE layout's) for one of
    ``TP_UNION_CASES``, the edge cases of a union that merges rows sorted
    by key after sorting the tail an apply appended to each:

    - ``shared_elems``: two canonical rows drawn from one pool of keys, so
      they share keys whose tombstones differ;
    - ``appended_tail_<k>``: a canonical prefix, then k keys absent from it
      in random order (at most C - 1; as a 2P-Set or Graph apply inserts
      at the first free slot; for edges often the src of a prefix key with
      a lower dst), then invalid slots;
    - ``one_unsorted``: shared rows with b's slots shuffled;
    - ``reversed``: both rows reversed;
    - ``shuffled``: both shuffled, junk keys and tombstones in invalid
      slots;
    - ``hole``: canonical rows with an invalid slot (junk keys) in the
      middle of the valid prefix;
    - ``triple_in_row``: canonical rows with one key in three neighbouring
      slots of a row (only the second copy's tombstone folds into the
      kept one);
    - ``sentinel_elem``: a canonical prefix whose last valid keys are
      INT32_MAX (the 2P-Set's elem; an edge's src, dst or both), tying
      with the invalid slots' key, then an appended tail of lower keys,
      then invalid slots holding junk;
    - ``full``: full canonical rows with distinct keys, Ca + Cb kept."""
    c = capacity
    rows = int(np.prod(shape, dtype=np.int64))
    side = int(np.ceil(np.sqrt(2 * c)))
    space = max(side * side, c) if edges else 2 * c
    at = np.arange(c)[None, :]

    def fields(ids, valid, removed, sent=None):
        """The layout's fields of key ids (``sent``: which of the keys'
        fields a slot holds at INT32_MAX, bit 0 the first)."""
        keys = ({"src": ids // side, "dst": ids % side} if edges
                else {"elem": ids})
        if sent is not None:
            for bit, f in enumerate(keys):
                keys[f] = np.where((sent >> bit) & 1 == 1, SENTINEL,
                                   keys[f])
        out = {f: np.where(valid, k, SENTINEL) for f, k in keys.items()}
        out["removed"] = valid & removed
        out["valid"] = valid
        return out

    def tombs():
        return rng.random((rows, c)) < 0.4

    if case == "full":
        ids = _tp_canonical(rng, rows, c, space, np.full(rows, c))
        ids2 = _tp_canonical(rng, rows, c, space, np.full(rows, c))
        full = np.ones((rows, c), bool)
        pair = (fields(ids, full, tombs()),
                fields(ids2 + space, full, tombs()))  # distinct, in order
    elif case.startswith("appended_tail") or case == "sentinel_elem":
        pair = []
        for _ in range(2):
            k = min(int(case.rsplit("_", 1)[1]) if case != "sentinel_elem"
                    else 4, c - 1)
            n_sent = 2 if case == "sentinel_elem" and c >= 4 else 0
            k = min(k, c - 1 - n_sent) if n_sent else k
            m = rng.integers(0, c - k - n_sent + 1, rows)
            order = np.argsort(rng.random((rows, space)), axis=1)
            ids = np.full((rows, c), space)
            for r in range(rows):
                pre = np.sort(order[r, :m[r]])
                if edges and m[r] > 0:
                    # absent keys on the src of the prefix's last key first
                    row_src = pre[-1] // side
                    near = [x for x in order[r, m[r]:] if x // side == row_src]
                    rest = [x for x in order[r, m[r]:] if x // side != row_src]
                    new = np.array((near[: (k + 1) // 2] + rest)[:k],
                                   np.int64)
                    rng.shuffle(new)
                else:
                    new = order[r, m[r]:m[r] + k]
                ids[r, :m[r]] = pre
                ids[r, m[r] + n_sent:m[r] + n_sent + k] = new
            valid = at < (m + n_sent + k)[:, None]
            sent = None
            if n_sent:
                # TP: two valid copies of elem INT32_MAX; edges: src at
                # INT32_MAX, then both (each sorts after the one before)
                slot = (at >= m[:, None]) & (at < (m + n_sent)[:, None])
                sent = np.where(slot, np.where(at == m[:, None], 1, 3)
                                if edges else 1, 0)
            row = fields(ids, valid, tombs(), sent)
            if case == "sentinel_elem":
                junk = ~valid
                for f in row:
                    if f not in ("removed", "valid"):
                        row[f] = np.where(junk, rng.integers(-5, 5, junk.shape),
                                          row[f])
            pair.append(row)
    else:
        n = np.where(rng.random(rows) < 0.3, c, rng.integers(0, int(0.9 * c)
                                                              + 1, rows))
        pool = _tp_canonical(rng, rows, c, space, n)
        pair = []
        for _ in range(2):
            keep = (pool < space) & (rng.random((rows, c)) < 0.6)
            ids = np.where(keep, pool, space)
            ids.sort(axis=1)
            pair.append(fields(ids, ids < space, tombs()))
        a, b = pair
        perm = lambda: np.argsort(rng.random((rows, c)), axis=1)  # noqa: E731
        if case == "one_unsorted":
            o = perm()
            b = {f: np.take_along_axis(x, o, 1) for f, x in b.items()}
        elif case == "reversed":
            a, b = ({f: x[:, ::-1] for f, x in t.items()} for t in (a, b))
        elif case == "shuffled":
            for row in (a, b):
                junk = ~row["valid"]
                for f in row:
                    if f == "removed":
                        row[f] = row[f] | (junk & (rng.random(junk.shape)
                                                   < 0.5))
                    elif f != "valid":
                        row[f] = np.where(junk, rng.integers(-5, 5, junk.shape),
                                          row[f])
                o = perm()
                for f in row:
                    row[f] = np.take_along_axis(row[f], o, 1)
        elif case == "hole":
            for row in (a, b):
                nv = row["valid"].sum(-1)
                pos = rng.integers(1, np.maximum(nv - 1, 2))
                hole = (at == pos[:, None]) & (nv >= 3)[:, None]
                row["valid"] = row["valid"] & ~hole
                f0 = "src" if edges else "elem"
                row[f0] = np.where(hole, rng.integers(-5, 5, hole.shape),
                                   row[f0])
        elif case == "triple_in_row":
            for row in (a, b):
                nv = row["valid"].sum(-1)
                pos = rng.integers(0, np.maximum(nv - 2, 1))
                three = (nv >= 3)[:, None] & (at > pos[:, None]) & (
                    at <= pos[:, None] + 2)
                for f in row:
                    if f not in ("removed", "valid"):
                        src = np.take_along_axis(row[f], pos[:, None], 1)
                        row[f] = np.where(three, src, row[f])
        elif case != "shared_elems":
            raise ValueError(f"unknown 2P union case {case!r}")
        pair = (a, b)
    names = ("src", "dst", "removed", "valid") if edges else tpset.FIELDS
    return tuple({f: np.ascontiguousarray(
        t[f].reshape(tuple(shape) + (c,)),
        bool if f in ("removed", "valid") else np.int32) for f in names}
        for t in pair)


# the LWW union's edge cases of ``lww_union_case``: the 2P cases' key
# orders with stamps attached, and three of the LWW-Set's own
LWW_UNION_CASES = TP_UNION_CASES + ("equal_stamps", "extreme_stamps",
                                    "empty")
# stamp words: negative low words order above positive ones (unsigned)
LWW_LOWS = (0, 1, 2, -1, -(2**31), 2**31 - 1, 7, -5)
LWW_EXTREMES = (-(2**31), -1, 0, 1, 2**31 - 1)


def lww_union_case(rng: np.random.Generator, case: str, shape,
                   capacity: int) -> tuple:
    """Rows ``a``, ``b`` ``shape + (capacity,)`` (numpy, the LWW-Set's
    fields) for one of ``LWW_UNION_CASES``, the edge cases of a union that
    merges rows sorted by elem after sorting the tail an apply appended to
    each. The elems and valid slots of the first eleven are
    ``tp_union_case``'s (sorted, appended tails of 1, 8 and 64, one row
    shuffled, both reversed or shuffled with junk in invalid slots, a hole,
    one elem three times in a row, elem INT32_MAX tying with invalid
    slots, full rows that overflow), with stamps (hi, lo) of hi in [0, 2)
    and lo among ``LWW_LOWS`` (negative low words, the int32 extremes), a
    quarter of each polarity unstamped, junk in invalid slots of the
    shuffled rows. The LWW-Set's own:

    - ``equal_stamps``: ``triple_in_row``'s rows (one elem three times in
      a row), each repeat holding the stamps of the copy before it, and
      b's stamps of an elem a holds equal to a's, or equal but for the sign
      of the low words;
    - ``extreme_stamps``: shuffled rows whose stamp words are all drawn
      from ``LWW_EXTREMES``;
    - ``empty``: rows with no valid slot, junk in every field."""
    c = capacity
    base = {"equal_stamps": "triple_in_row", "extreme_stamps": "shuffled",
            "empty": "shuffled"}.get(case, case)
    pair = tp_union_case(rng, base, shape, c)
    rows = int(np.prod(shape, dtype=np.int64))
    out = []
    for t in pair:
        valid = t["valid"].reshape(rows, c)
        elem = t["elem"].reshape(rows, c)
        row = {"elem": elem}
        for pol in ("add", "rm"):
            if case == "extreme_stamps":
                hi = rng.choice(LWW_EXTREMES, (rows, c))
                lo = rng.choice(LWW_EXTREMES, (rows, c))
            else:
                hi = rng.integers(0, 2, (rows, c))
                lo = rng.choice(LWW_LOWS, (rows, c))
            none = rng.random((rows, c)) < 0.25
            row[f"{pol}_hi"] = np.where(valid & ~none, hi, 0)
            row[f"{pol}_lo"] = np.where(valid & ~none, lo, 0)
        row["valid"] = valid
        if case == "empty":
            row["valid"] = np.zeros_like(valid)
        if base == "shuffled":
            junk = ~row["valid"]
            for f in lwwset.FIELDS[1:-1]:
                row[f] = np.where(junk, rng.integers(-5, 5, (rows, c)),
                                  row[f])
        out.append(row)
    if case == "equal_stamps":
        a, b = out
        stamps = ("add_hi", "add_lo", "rm_hi", "rm_lo")
        for r in range(rows):
            # a copy that repeats the elem before it in its row takes that
            # copy's stamps; b's copy of an elem a holds takes a's, its low
            # words' sign flipped a third of the time
            for t in (a, b):
                for i in range(1, c):
                    if (t["valid"][r, i] and t["valid"][r, i - 1]
                            and t["elem"][r, i] == t["elem"][r, i - 1]):
                        for f in stamps:
                            t[f][r, i] = t[f][r, i - 1]
            at = {e: i for i, e in enumerate(a["elem"][r]) if a["valid"][r, i]}
            for j in range(c):
                i = at.get(b["elem"][r, j]) if b["valid"][r, j] else None
                if i is None:
                    continue
                flip = rng.random() < 0.3
                for f in stamps:
                    x = a[f][r, i]
                    b[f][r, j] = -x if flip and f.endswith("_lo") else x
    return tuple({f: np.ascontiguousarray(
        t[f].reshape(tuple(shape) + (c,)),
        bool if f == "valid" else np.int32) for f in lwwset.FIELDS}
        for t in out)


def tp_mixed_ops(rng: np.random.Generator, shape, num_keys: int,
                 num_elems: int, hazards: bool = True,
                 captured: bool = False) -> dict:
    """2P-Set op lanes of every code from -1 to 4 (0 no-op, 1 add, 2
    remove; -1, 3 and 4 unknown to the 2P-Set, 3 and 4 the Graph's edge
    codes in the walk the two types share) whose elems collide with
    ``tp_slots``' and with each other's, as int32 numpy arrays of
    ``shape``. With ``hazards``, keys fall in [-2K, 2K). With
    ``captured``, an ``ok`` ``shape + (1,)`` field is 0 or 1."""
    k = num_keys
    ops = _op_batch(
        tuple(shape), op=rng.choice([-1, 0, 1, 2, 3, 4], shape,
                                    p=[0.03, 0.07, 0.45, 0.35, 0.05, 0.05]),
        key=(rng.integers(-2 * k, 2 * k, shape) if hazards
             else rng.integers(0, k, shape)),
        a0=rng.integers(0, num_elems, shape))
    if captured:
        ops["ok"] = rng.integers(0, 2, tuple(shape) + (1,)).astype(np.int32)
    return ops


def graph_mixed_ops(rng: np.random.Generator, shape, num_keys: int,
                    num_vertices: int, hazards: bool = True,
                    captured: bool = False) -> dict:
    """Graph op lanes whose vertices collide with ``graph_slots``', as
    int32 numpy arrays of ``shape``: every code from -1 to 5 (the four ops
    and codes outside 1-4), a0 and a1 over ``num_vertices`` ids with a
    tenth of the lanes self-loops (a1 = a0). With ``hazards``, keys fall
    in [-2K, 2K) and 3% of the endpoints are INT32_MAX. With ``captured``,
    an ``ok`` ``shape + (1,)`` field is 0 or 1."""
    k = num_keys
    a0 = rng.integers(0, num_vertices, shape)
    a1 = np.where(rng.random(shape) < 0.1, a0,
                  rng.integers(0, num_vertices, shape))
    if hazards:
        a0 = np.where(rng.random(shape) < 0.03, SENTINEL, a0)
        a1 = np.where(rng.random(shape) < 0.03, SENTINEL, a1)
    ops = _op_batch(
        tuple(shape),
        op=rng.choice(np.arange(-1, 6), shape,
                      p=[0.04, 0.08, 0.25, 0.15, 0.25, 0.15, 0.08]),
        key=(rng.integers(-2 * k, 2 * k, shape) if hazards
             else rng.integers(0, k, shape)),
        a0=a0, a1=a1)
    if captured:
        ops["ok"] = rng.integers(0, 2, tuple(shape) + (1,)).astype(np.int32)
    return ops


# the Graph and 2P-Set walk's edge cases of ``graph_walk_case``
GRAPH_WALK_CASES = ("sizes", "long", "av_only", "loops", "full", "hazards")
# the lanes of the rows of case "sizes": a group of one lane, one short of
# a warp, a warp, one past it
WALK_SIZES = (1, 31, 32, 33)


def graph_walk_case(rng: np.random.Generator, case: str, num_views: int,
                    num_keys: int, v_capacity: int, e_capacity: int,
                    num_vertices: int, batch: int, edges: bool = True) -> tuple:
    """``(state, ops)`` for one of ``GRAPH_WALK_CASES``, the edge cases of
    the Graph's sequential apply (``edges``) or the 2P-Set's (the same walk
    over a vertex block alone): rows ``[V, K, ...]`` of ``graph_slots``
    (``v_capacity`` vertex and ``e_capacity`` edge slots over
    ``num_vertices`` ids; the 2P-Set's ``tp_slots`` of ``v_capacity``
    slots), non-canonical, a key twice in some rows, and op lanes ``[V,
    batch]`` of ``graph_mixed_ops`` (``tp_mixed_ops``: codes -1 to 5, or
    -1 to 4) with a captured ``ok`` ``[V, batch, 1]`` (numpy int32; drop it
    for the uncaptured apply and the capture). Keys are in range but for
    ``hazards``.

    - ``sizes``: rows 0-3 gathered by exactly 1, 31, 32 and 33 lanes
      (``WALK_SIZES``), the other lanes on rows 4 on, all interleaved;
    - ``long``: 95% of the lanes on row 1, more than one window of 2,048
      lane indices when ``batch`` > 2,156;
    - ``av_only``: every lane on the rows of the first half is an add
      (av), so those rows see no gate;
    - ``loops``: half of the edge lanes self-loops, a tenth of the ids
      INT32_MAX (vertices, edge ends, the 2P-Set's elems), in the rows
      too;
    - ``full``: full blocks without tombstones and ids from twice the
      rows' range, so that upserts of absent keys drop;
    - ``hazards``: keys in [-2K, 2K) and 3% of the endpoints INT32_MAX."""
    V, K, B = num_views, num_keys, batch
    nv = num_vertices
    cv = v_capacity
    full = case == "full"
    kw = dict(canonical=False, dup_rows=0.3, full_rows=1.0 if full else 0.3,
              removed=0.0 if full else 0.3)
    if edges:
        st = graph_slots(rng, (V, K), cv, e_capacity, nv,
                         at_max=0.1 if case == "loops" else 0.0, **kw)
    else:
        st = tp_slots(rng, (V, K), cv, num_elems=nv, **kw)
    ids = 2 * nv if full else nv
    hazards = case == "hazards"
    if edges:
        ops = graph_mixed_ops(rng, (V, B), K, ids, hazards=hazards,
                              captured=True)
    else:
        ops = tp_mixed_ops(rng, (V, B), K, ids, hazards=hazards,
                           captured=True)
    key = ops["key"]
    if case == "sizes":
        fixed = np.repeat(np.arange(len(WALK_SIZES)), WALK_SIZES)
        for v in range(V):
            row = np.concatenate([fixed, rng.integers(
                len(WALK_SIZES), K, B - fixed.size)])
            key[v] = rng.permutation(row)
    elif case == "long":
        key[:] = np.where(rng.random((V, B)) < 0.95, 1, key)
    elif case == "av_only":
        ops["op"] = np.where(key < K // 2, 1, ops["op"]).astype(np.int32)
    elif case == "loops":
        a0 = ops["a0"]
        a0[:] = np.where(rng.random((V, B)) < 0.1, SENTINEL, a0)
        if edges:
            a1 = ops["a1"]
            a1[:] = np.where(rng.random((V, B)) < 0.5, a0, a1)
            a1[:] = np.where(rng.random((V, B)) < 0.1, SENTINEL, a1)
        else:
            st["elem"] = np.where(st["valid"] & (rng.random(
                st["valid"].shape) < 0.1), SENTINEL, st["elem"]).astype(
                    np.int32)
    return st, ops


# the RGA walk's edge cases at a SafeKV delta apply's shape
RGA_WALK_CASES = ("consensus", "negative_floors", "noop_rows", "key_hazards",
                  "hot_row")


def rga_walk_case(rng: np.random.Generator, case: str, num_views: int,
                  num_keys: int, capacity: int, block: int,
                  blocks: int = 16) -> tuple:
    """``(state, ops)`` for one of ``RGA_WALK_CASES``, the edge cases of the
    RGA's sequential apply at the shape of SafeKV's delta applies: rows
    ``[V, K, capacity]`` of ``rga_slots`` (non-canonical, a tenth of the
    ids negative) with ``ctr_floor`` ``[V, K]`` in [-2, capacity + 2), and
    ``[V, blocks * block]`` op lanes whose first quarter are live (inserts
    and deletes of ``rga_mixed_ops``, ids colliding with the rows') and
    the rest not: OP_NOOP (a tenth code 3) at key 0, as the ring's cleared
    lanes carry, or at the key of a live lane, as an applied block's
    lanes do; with a captured ``eff_ctr`` ``[V, B, 1]`` (numpy int32;
    drop it for the uncaptured apply and the capture).

    - ``consensus``: that batch;
    - ``negative_floors``: every floor in [-3, 0), a third of the rows
      full of valid slots with negative counters (so a mint there reads
      the floor, and the no-op's clamp at 0 shows), and on each of them
      an in-range no-op followed by an uncaptured insert, the other order
      on half of them;
    - ``noop_rows``: a third of the rows gathered by no live lane, only by
      no-ops in range (codes 0, 3, -1 and 5), and lanes out of range;
    - ``key_hazards``: keys in [-K, 2K) on every lane, codes -1 to 5
      among the first quarter;
    - ``hot_row``: the first half of the lanes live, two thirds of them on
      row 1 (more than a walk's bucket of 128 lanes when ``blocks *
      block`` >= 384), no-ops on row 1 among them."""
    V, K, C = num_views, num_keys, capacity
    B = blocks * block
    st = rga_slots(rng, (V, K), C, canonical=False, dup_rows=0.3,
                   full_rows=0.3, negative=0.1)
    st["ctr_floor"] = rng.integers(-2, C + 2, (V, K)).astype(np.int32)
    ops = rga_mixed_ops(rng, (V, B), K, C, hazards=case == "key_hazards",
                        captured=True)
    n_live = B // 2 if case == "hot_row" else B // 4
    op, key = ops["op"], ops["key"]
    op[:, :n_live] = np.where(rng.random((V, n_live)) < 0.6, 1, 2)
    rest = B - n_live
    op[:, n_live:] = np.where(rng.random((V, rest)) < 0.9, 0, 3)
    if case != "key_hazards":
        applied = np.take_along_axis(
            key[:, :n_live], rng.integers(0, n_live, (V, rest)), 1)
        key[:, n_live:] = np.where(rng.random((V, rest)) < 0.5, 0, applied)
    else:
        op[:, :n_live] = rng.integers(-1, 6, (V, n_live))
    if case == "negative_floors":
        st["ctr_floor"][:] = rng.integers(-3, 0, (V, K))
        rows = np.arange(0, K, 3)
        st["valid"][:, rows] = True
        st["id_ctr"][:, rows] = -rng.integers(1, 50, (V, rows.size, C))
        for v in range(V):
            for j, r in enumerate(rows):
                at = np.sort(rng.choice(n_live, 2, replace=False))
                noop, ins = (at if j % 2 == 0 else at[::-1])
                op[v, noop], key[v, noop] = rng.choice([0, 3, -1]), r
                op[v, ins], key[v, ins] = 1, r
    elif case == "noop_rows":
        quiet = np.arange(1, K, 3)
        for v in range(V):
            on = np.isin(key[v], quiet) & ((op[v] == 1) | (op[v] == 2))
            key[v] = np.where(on, (key[v] + 1) % K, key[v])
            lanes = rng.choice(B, 2 * quiet.size, replace=False)
            key[v, lanes] = np.concatenate([quiet, quiet + 2 * K])
            op[v, lanes] = rng.choice([0, 3, -1, 5], lanes.size)
    elif case == "hot_row":
        hot = rng.random((V, B)) < 2 / 3
        hot[:, n_live:] = rng.random((V, rest)) < 0.05
        key[:] = np.where(hot, 1, key)
    return st, ops


def ops_to_device(ops: dict, device=None) -> dict:
    """Move an op batch (numpy or tensors, one array per field) onto
    ``device`` as contiguous int32 tensors."""
    dev = resolve_device(device)
    return {f: torch.tensor(np.asarray(v), dtype=torch.int32, device=dev)
            if not isinstance(v, torch.Tensor)
            else v.to(device=dev, dtype=torch.int32).contiguous()
            for f, v in ops.items()}


INT32_MIN = -(2**31)


def consensus_state(rng: np.random.Generator, num_nodes: int,
                    num_rounds: int, wrap: bool = False):
    """A random DAG state, commit state and applied mask of ``num_nodes``
    nodes over a ``num_rounds``-slot window, as numpy arrays in the
    layouts of ``consensus.dag`` and ``consensus.tusk``. Any bool tensors
    are valid inputs of the consensus functions, so the draws test them
    away from the states the protocol reaches.

    The GC frontier is 0 or above it; node rounds fall around the window
    (below 0 when the frontier is 0, so ring slots take negative modulo),
    and evaluated waves sit near the frontier (anchors at rounds 0-2 and
    below). With ``wrap`` the frontier is near INT32_MIN and the waves
    near 2^30, so ``2 * wave`` wraps around int32.
    Returns ``(dag_state, commit_state, applied)``."""
    n, w = num_nodes, num_rounds

    def bools(shape, p):
        return rng.random(shape) < p

    if wrap:
        base = INT32_MIN + int(rng.integers(0, 2 * w))
        node_round = 2**31 - 1 - rng.integers(0, 3, n)
        eval_wave = 2**30 - 1 - rng.integers(0, 2, n)
    else:
        base = int(rng.choice([0, int(rng.integers(1, 3 * w))]))
        node_round = base + rng.integers(-2, w + 1, n)
        eval_wave = base // 2 - 1 + rng.integers(-2, max(1, w // 2), n)
    slots = np.arange(w)
    slot_round = base + (slots - base) % w  # the live round of each slot
    committed = bools((n, w, n), 0.15)
    i32 = np.int32
    dag_state = {
        "edges": bools((w, n, n), 0.8),
        "block_exists": bools((w, n), 0.7),
        "block_seen": bools((n, w, n), 0.85),
        "acks": bools((w, n, n), 0.5),
        "cert_exists": bools((w, n), 0.6),
        "cert_seen": bools((n, w, n), 0.8),
        "node_round": node_round.astype(i32),
        "slot_round": slot_round.astype(i32),
        "base_round": np.array(base, i32),
    }
    commit_state = {
        "committed": committed,
        "commit_seq": np.where(committed, rng.integers(0, 100, (n, w, n)),
                               -1).astype(i32),
        "last_wave": (eval_wave - rng.integers(0, 3, n)).astype(i32),
        "eval_wave": eval_wave.astype(i32),
        "commit_counter": rng.integers(0, 100, n).astype(i32),
        "slot_round": slot_round.astype(i32),
    }
    return dag_state, commit_state, bools((n, w, n), 0.3)


def round_masks(rng: np.random.Generator, num_nodes: int, num_rounds: int):
    """Random ``(active[N], withhold[W, N], invalid[W, N])`` bool masks
    for ``dag.round_step``."""
    n, w = num_nodes, num_rounds
    return (rng.random(n) < 0.75, rng.random((w, n)) < 0.2,
            rng.random((w, n)) < 0.15)


def wire_batch(rng: np.random.Generator, num_nodes: int, slot_round,
               payload: int = 0, messages: int = 0):
    """A random batch of DAG messages as received over the wire, for
    ``dag.ingest_batch``: blocks at live, stale and ahead-of-window rounds,
    re-sends of a (round, source) with other edges, signatures and
    certificates, node ids mostly in range but some in [-N, 0) (JAX counts
    them from the end), below -N or at N and above (dropped), and a
    ``seen_by`` that is empty, in range, or mixed. With ``payload`` (int32
    elements of a block's ring row), about half the blocks carry a payload
    row, each at its own in-range ring cell. ``messages`` sets the number
    of each kind (random below 3N when 0). Returns ``(blocks, sigs, certs,
    seen_by)``."""
    n = num_nodes
    live = np.asarray(slot_round, np.int64)
    w = live.size
    m, s, c = ((messages,) * 3 if messages else
               (int(x) for x in rng.integers(1, 3 * n, 3)))

    def ids(size):
        return np.where(rng.random(size) < 0.8, rng.integers(0, n, size),
                        rng.integers(-n - 3, n + 4, size))

    def rounds(size):
        pick = rng.random(size)
        return np.where(pick < 0.6, rng.choice(live, size),
                        np.where(pick < 0.8,
                                 live.min() - rng.integers(1, w + 3, size),
                                 live.max() + rng.integers(1, w + 3, size)))

    blocks = [[int(r), int(v), rng.random(n) < 0.5]
              for r, v in zip(rounds(m), ids(m))]
    for i in range(min(3, m)):  # a re-send with other edges
        blocks.append([blocks[i][0], blocks[i][1], rng.random(n) < 0.5])
    blocks = [blocks[i] for i in rng.permutation(len(blocks))]
    cells = set()
    for b in blocks:
        cell = (b[0] % w, b[1])
        if payload and 0 <= b[1] < n and cell not in cells \
                and rng.random() < 0.5:
            cells.add(cell)
            b.append(rng.integers(-2**31, 2**31 - 1, payload).astype(np.int32))
    sigs = [(int(r), int(v), int(t))
            for r, v, t in zip(rounds(s), ids(s), ids(s))]
    certs = [(int(r), int(v)) for r, v in zip(rounds(c), ids(c))]
    kind = int(rng.integers(0, 3))
    seen_by = (np.zeros(0, np.int32) if kind == 0 else
               np.nonzero(rng.random(n) < 0.5)[0] if kind == 1 else ids(3))
    return ([tuple(b) for b in blocks], sigs, certs,
            np.asarray(seen_by, np.int32))


def backchain_state(num_nodes: int, num_rounds: int, seed: int = 0):
    """A DAG on which one commit call (steps >= 2) commits two anchors:
    wave 0's leader holds a certificate that only one round-1 block
    references (no 2f+1 support), and wave 1's anchor, which has full
    support, reaches it through that block, so the back-chain discovery
    chains it. Every node is at round 4 and holds every block and
    certificate of rounds 0-3. Returns ``(dag_state, commit_state)`` as
    numpy arrays with a fresh commit state."""
    n, w = num_nodes, num_rounds
    if n < 4 or w < 5:
        raise ValueError("backchain_state needs at least 4 nodes and 5 slots")
    cfg = DagConfig(n, w)
    l0, l1 = (int(x) for x in leader.leader_of(
        cfg, torch.arange(2, dtype=torch.int64), seed))
    edges = np.zeros((w, n, n), bool)
    edges[1] = True
    edges[1, :, l0] = False
    edges[1, (l0 + 1) % n, l0] = True  # the one reference to wave 0's leader
    edges[2] = True
    edges[3] = True
    held = np.zeros((n, w, n), bool)
    held[:, :4] = True
    exists = np.zeros((w, n), bool)
    exists[:4] = True
    dag_state = {
        "edges": edges, "block_exists": exists, "block_seen": held.copy(),
        "acks": np.broadcast_to(exists[:, :, None], (w, n, n)).copy(),
        "cert_exists": exists.copy(), "cert_seen": held.copy(),
        "node_round": np.full(n, 4, np.int32),
        "slot_round": np.arange(w, dtype=np.int32),
        "base_round": np.array(0, np.int32),
    }
    commit_state = {
        "committed": np.zeros((n, w, n), bool),
        "commit_seq": np.full((n, w, n), -1, np.int32),
        "last_wave": np.full(n, -1, np.int32),
        "eval_wave": np.full(n, -1, np.int32),
        "commit_counter": np.zeros(n, np.int32),
        "slot_round": np.arange(w, dtype=np.int32),
    }
    return dag_state, commit_state


def gc_state(rng: np.random.Generator, num_nodes: int, num_rounds: int,
             wrap: bool = False):
    """A random state at the end of a SafeKV round, shaped so the GC
    frontier has work: a run of slots from the frontier up is finished in
    every view (committed as one reference set, stably applied, every
    certificate prospectively applied, the origins' own uncertified blocks
    left as residue) and frozen, and one view, the straggler, is not done
    with one of them. Returns numpy ``(dag_state, commit_state,
    com_before, prosp_applied, stable_applied, buffer_filled)``; the
    frontier may advance by more than one slot, and the straggler is lost
    when its slot dies."""
    n, w = num_nodes, num_rounds
    dag, com, _ = consensus_state(rng, n, w, wrap=wrap)
    base = int(dag["base_round"])
    finished = int(rng.integers(0, w + 1))  # slots from the frontier up
    cert = dag["cert_exists"]
    committed = com["committed"].copy()
    # mostly every certificate committed (no uncommitted certificate can
    # gain a commit), sometimes not
    ref = (rng.random((w, n)) < 0.5) | (cert & (rng.random((w, 1)) < 0.8))
    prosp = rng.random((n, w, n)) < 0.3
    stable = rng.random((n, w, n)) < 0.5
    for i in range(finished):
        s = (base + i) % w
        committed[:, s] = ref[s]
        stable[:, s] = ref[s]
        prosp[:, s] = cert[s]
        own = rng.random(n) < 0.3  # the origin's own uncertified block
        prosp[np.arange(n), s, np.arange(n)] |= own & ~cert[s]
    if finished and rng.random() < 0.7:  # a straggler on a finished slot
        v, s = int(rng.integers(0, n)), (base + int(rng.integers(0, finished))) % w
        committed[v, s] = ~ref[s]
    com["committed"] = committed
    com["commit_seq"] = np.where(committed, rng.integers(0, 50, (n, w, n)),
                                 -1).astype(np.int32)
    # most views far ahead, so the finished slots are frozen; evaluated
    # waves above the live even rounds or not
    dag["node_round"] = (dag["slot_round"].max() + rng.integers(-1, 4, n)
                         ).astype(np.int32)
    com["eval_wave"] = (com["eval_wave"] + rng.integers(0, w, n)).astype(np.int32)
    com["last_wave"] = np.minimum(com["last_wave"] + rng.integers(0, 3, n),
                                  com["eval_wave"]).astype(np.int32)
    com_before = committed & (rng.random((n, w, n)) < 0.7)
    filled = rng.random((w, n)) < 0.5
    return dag, com, com_before, prosp, stable, filled


# SafeKV ring extras of each type at the widths the presets give them
# (the OR-Set's capture lanes at rm_capacity 4, the MVRegister's clock at
# 8 writers, the width-1 extras of the RGA and the gated sets)
RING_EXTRAS = {"pnc": {}, "orset": dict.fromkeys(orset.CAPTURE_FIELDS, 4),
               "mvregister": {"wclock": 8}, "rga": {"eff_ctr": 1},
               "lwwset": {"ok": 1}}


def ring_resize_case(rng: np.random.Generator, num_rounds: int,
                     num_nodes: int, b: int, new_b: int, extras: dict,
                     live_tail: bool = False) -> dict:
    """A SafeKV op ring ``[W, N, b]`` per op field and ``[W, N, b, width]``
    per extra, random int32 everywhere. For a shrink (``new_b < b``) the
    op lanes from ``new_b`` on are OP_NOOP, but for one live lane at a
    random (slot, node) when ``live_tail``; the other fields' tail lanes
    keep their random values (only ``op`` decides a lane's liveness)."""
    shape = (num_rounds, num_nodes, b)
    ring = {f: _rand_int32(rng, shape) for f in base.OP_FIELDS}
    ring["op"] = rng.integers(0, 4, shape).astype(np.int32)
    for name, width in extras.items():
        ring[name] = _rand_int32(rng, shape + (width,))
    if new_b < b:
        ring["op"][:, :, new_b:] = base.OP_NOOP
        if live_tail:
            s, v = rng.integers(0, num_rounds), rng.integers(0, num_nodes)
            ring["op"][s, v, rng.integers(new_b, b)] = 1
    return ring


def _rand_int32(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(
        np.int32)

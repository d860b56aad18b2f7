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
from janus_tpu_torch.models import base, orset, pncounter, rga
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

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
from janus_tpu_torch.models import base, pncounter


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

"""Tusk wave commit over the ring-buffered DAG tensors
(counterpart: janus_tpu/consensus/tusk.py).

Wave = 2 rounds; the leader of a wave commits with >=2f+1 support in the
next round; skipped leaders are back-chained by reachability; traversal
never descends through committed certificates. The JAX package runs one
view's commit as nested ``lax.scan``/``fori_loop`` under ``vmap``; here
``commit_view`` is one launch of the ``tusk_commit`` kernel (its plain
version, for the CPU, batches the view axis and runs the scans as Python
loops of a fixed trip count), so a commit reads no tensor value on the
host. Leaders come from ``kernels/leader.py``, which the kernel's
wrapper shares.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.kernels.leader import leader_of, leaders  # noqa: F401
from janus_tpu_torch.device import resolve_device

State = Dict[str, torch.Tensor]

INT32_MAX = torch.iinfo(torch.int32).max


def init_commit(cfg: DagConfig, device=None) -> State:
    n, w = cfg.num_nodes, cfg.num_rounds
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "committed": torch.zeros((n, w, n), dtype=torch.bool, device=dev),
        "commit_seq": torch.full((n, w, n), -1, **i32),
        "last_wave": torch.full((n,), -1, **i32),    # last committed anchor
        "eval_wave": torch.full((n,), -1, **i32),    # last evaluated wave
        "commit_counter": torch.zeros((n,), **i32),
        # the DAG's slot->round map at the last commit call
        "slot_round": torch.arange(w, **i32),
    }


def commit_view(cfg: DagConfig, dag_state: State, cstate: State,
                node: int | None = None, seed: int = 0,
                steps: int | None = None) -> State:
    """Run the Tusk commit rule for every node's view: evaluate up to
    ``steps`` (default: a full window of waves) newly-complete waves per
    view, in one ``tusk_commit`` kernel launch. Returns a new commit
    state; ``cstate`` is left as it was. ``node`` is accepted for API
    compatibility and ignored."""
    del node
    n_steps = steps if steps is not None else max(1, cfg.num_rounds // 2)
    com, seq, lw, ew, cnt = kernels.tusk_commit(cfg, dag_state, cstate, seed,
                                                n_steps)
    return {
        "committed": com,
        "commit_seq": seq,
        "last_wave": lw,
        "eval_wave": ew,
        "commit_counter": cnt,
        "slot_round": dag_state["slot_round"],
    }


def recycle_commit(cfg: DagConfig, cstate: State, new_base) -> State:
    """Clear commit rows for slots below the new GC frontier."""
    sr = cstate["slot_round"]
    dead = sr < torch.as_tensor(new_base, dtype=torch.int32, device=sr.device)
    out = dict(cstate)
    out["committed"] = cstate["committed"] & ~dead[None, :, None]
    out["commit_seq"] = torch.where(dead[None, :, None], -1, cstate["commit_seq"])
    out["slot_round"] = torch.where(dead, sr + cfg.num_rounds, sr)
    return out


def ordered_blocks(cfg: DagConfig, cstate: State, node: int) -> list[Tuple[int, int]]:
    """Host-side: the node's committed blocks of the live window in total
    order — ascending (commit_seq, logical round, source)."""
    com = cstate["committed"][node].cpu().numpy()
    seq = cstate["commit_seq"][node].cpu().numpy()
    rounds = cstate["slot_round"].cpu().numpy()
    ss_slot, ss = np.nonzero(com)
    rr = rounds[ss_slot]
    order = np.lexsort((ss, rr, seq[ss_slot, ss]))
    return [(int(rr[i]), int(ss[i])) for i in order]


def order_key(cfg: DagConfig, cstate: State, base=None) -> torch.Tensor:
    """Device-side total-order key per (node, slot, source):
    seq * W * N + (round - base) * N + source in int32 (wrapping as in
    JAX), INT32_MAX where uncommitted."""
    w, n = cfg.num_rounds, cfg.num_nodes
    sr = cstate["slot_round"]
    b = sr.min() if base is None else base
    rel = (sr - b)[None, :, None]
    srcs = torch.arange(n, dtype=torch.int32, device=sr.device)[None, None, :]
    key = cstate["commit_seq"] * (w * n) + rel * n + srcs
    return torch.where(cstate["committed"], key, INT32_MAX)

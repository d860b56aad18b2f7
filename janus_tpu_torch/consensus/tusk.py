"""Tusk wave commit over the ring-buffered DAG tensors
(counterpart: janus_tpu/consensus/tusk.py).

Wave = 2 rounds; the leader of a wave commits with >=2f+1 support in the
next round; skipped leaders are back-chained by reachability; traversal
never descends through committed certificates. The JAX package runs one
view's commit as nested ``lax.scan``/``fori_loop`` under ``vmap``; here
the view axis is a batch dimension of every tensor and the scans are
Python loops of a fixed trip count over tensor ops, so a commit reads no
tensor value on the host.

Leaders come from the murmur3 finalizer on uint32. torch has no uint32
right shift on the CPU, so the mix runs in int64 masked to 32 bits, with
products split so no intermediate leaves int64.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.device import resolve_device

State = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF
INT32_MAX = torch.iinfo(torch.int32).max


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``, without any intermediate above 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 ``x``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def leader_of(cfg: DagConfig, wave: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """int32 leader node id for each (unbounded) wave number; the wave is
    read as uint32, as the JAX package's ``astype(uint32)`` does. The
    seed constant is reduced to 32 bits, as ``leaders`` does."""
    w = wave.to(torch.int64) & _M32
    h = _mix32((_mul32(w, 2654435761) + ((seed * 0x9E3779B9 + 1) & _M32)) & _M32)
    return (h % cfg.num_nodes).to(torch.int32)


def leaders(cfg: DagConfig, seed: int = 0) -> np.ndarray:
    """int32[W//2]: leader per wave for the first window (host-side)."""
    waves = torch.arange(cfg.num_rounds // 2, dtype=torch.int64)
    return leader_of(cfg, waves, seed).numpy()


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


def _closure(cfg: DagConfig, edges, certs, com, base, anchor_r, src):
    """bool[V, W, N]: per view, the uncommitted certificates reachable
    from (anchor_r[v], src[v]) following prev-certificate edges downward
    through held uncommitted certs (committed certs stop the traversal).
    ``certs``/``com``: bool[V, W, N]; ``anchor_r``/``src``: int[V]."""
    w, n = cfg.num_rounds, cfg.num_nodes
    views = torch.arange(certs.shape[0], device=certs.device)
    nodes = torch.arange(n, device=certs.device)
    s0 = anchor_r % w
    start = (nodes[None, :] == src[:, None]) & certs[views, s0] & ~com[views, s0]
    reach = torch.zeros_like(certs)
    reach[views, s0] = start
    for j in range(w - 1):
        r = anchor_r - j
        s = r % w
        sp = (r - 1) % w
        frontier = reach[views, s]                                  # [V, N]
        prev = (frontier[:, :, None] & edges[s]).any(1)             # [V, N]
        ok = ((r >= 1) & (r - 1 >= base))[:, None]
        grow = prev & certs[views, sp] & ~com[views, sp] & ok
        reach[views, sp] = reach[views, sp] | grow
    return reach


def _support(cfg: DagConfig, edges, seen, wv, leader):
    """bool[V]: >=2f+1 seen round-(2wv+1) blocks reference the leader's
    round-2wv certificate."""
    views = torch.arange(seen.shape[0], device=seen.device)
    s_sup = (2 * wv + 1) % cfg.num_rounds
    votes = seen[views, s_sup] & edges[s_sup, :, leader]           # [V, N]
    return votes.sum(-1) >= cfg.quorum


def _commit_views(cfg: DagConfig, edges, base, seed: int, steps: int,
                  seen, certs, nr, com, seq, lw, ew, cnt):
    """Process up to ``steps`` newly-complete waves for every view at
    once: the JAX package's ``_commit_one_view`` with the view axis as a
    batch dimension."""
    w = cfg.num_rounds
    lb = max(1, w // 2)  # back-chain window (waves live in the ring)
    views = torch.arange(seen.shape[0], device=seen.device)
    i32 = torch.int32

    for _ in range(steps):
        wv = ew + 1
        s_sup_c = (2 * wv + 1) % w
        have_sup = certs[views, s_sup_c].sum(-1)
        complete = (nr > 2 * wv + 1) | ((nr == 2 * wv + 1) & (have_sup >= cfg.quorum))
        l = leader_of(cfg, wv, seed)
        s_anchor = (2 * wv) % w
        anchor_ok = (complete & (2 * wv >= base)
                     & certs[views, s_anchor, l]
                     & _support(cfg, edges, seen, wv, l))
        com0 = com

        # back-chain discovery, newest to oldest
        head_r, head_src = 2 * wv, l
        chain = []
        for j in range(lb):
            wp = wv - 1 - j
            lp = leader_of(cfg, wp, seed)
            sp = (2 * wp) % w
            in_range = (wp > lw) & (2 * wp >= base)
            cand_ok = anchor_ok & in_range & certs[views, sp, lp] & ~com0[views, sp, lp]
            head_cl = _closure(cfg, edges, certs, com0, base, head_r, head_src)
            chained = cand_ok & head_cl[views, sp, lp]
            head_r = torch.where(chained, 2 * wp, head_r)
            head_src = torch.where(chained, lp, head_src)
            chain.append((chained, lp, wp))

        # commit oldest first: each chained leader anchors its own closure
        # with its own sequence number, then the wave anchor commits
        for chained, lp, wp in reversed(chain):
            cl = _closure(cfg, edges, certs, com, base, 2 * wp, lp)
            new = cl & chained[:, None, None]
            com = com | new
            seq = torch.where(new, cnt[:, None, None], seq)
            cnt = cnt + chained.to(i32)
        cl = _closure(cfg, edges, certs, com, base, 2 * wv, l)
        new = cl & anchor_ok[:, None, None]
        com = com | new
        seq = torch.where(new, cnt[:, None, None], seq)
        cnt = cnt + anchor_ok.to(i32)

        lw = torch.where(anchor_ok, wv, lw)
        ew = torch.where(complete, wv, ew)
    return com, seq, lw, ew, cnt


def commit_view(cfg: DagConfig, dag_state: State, cstate: State,
                node: int | None = None, seed: int = 0,
                steps: int | None = None) -> State:
    """Run the Tusk commit rule for every node's view: evaluate up to
    ``steps`` (default: a full window of waves) newly-complete waves per
    view. ``node`` is accepted for API compatibility and ignored."""
    del node
    n_steps = steps if steps is not None else max(1, cfg.num_rounds // 2)
    com, seq, lw, ew, cnt = _commit_views(
        cfg, dag_state["edges"], dag_state["base_round"], seed, n_steps,
        dag_state["block_seen"], dag_state["cert_seen"],
        dag_state["node_round"], cstate["committed"], cstate["commit_seq"],
        cstate["last_wave"], cstate["eval_wave"], cstate["commit_counter"])
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

"""``tusk_commit``: the Tusk commit rule for every view in one launch
(kernel source: csrc/tusk_commit.cu).

Replaces janus_tpu/consensus/tusk.py ``commit_view`` (``_commit_one_view``
vmapped over views, with ``_closure`` and ``_support``). The plain version
is the JAX package's scan with the view axis as a batch dimension and the
scans as Python loops of a fixed trip count; it reads no tensor value on
the host.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``tusk_commit_plain`` only for tensors that lie on the CPU. Both return
new tensors and leave their inputs as they were.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, leader, operands

_DAG_FIELDS = ("edges", "block_seen", "cert_seen", "node_round", "base_round")
_COMMIT_FIELDS = ("committed", "commit_seq", "last_wave", "eval_wave",
                  "commit_counter")


def _closure(cfg, edges, certs, com, base, anchor_r, src):
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


def _support(cfg, edges, seen, wv, leader_id):
    """bool[V]: >=2f+1 seen round-(2wv+1) blocks reference the leader's
    round-2wv certificate."""
    views = torch.arange(seen.shape[0], device=seen.device)
    s_sup = (2 * wv + 1) % cfg.num_rounds
    votes = seen[views, s_sup] & edges[s_sup, :, leader_id]        # [V, N]
    return votes.sum(-1) >= cfg.quorum


def tusk_commit_plain(cfg, dag_state, cstate, seed: int, steps: int):
    """Plain PyTorch version: process up to ``steps`` newly-complete waves
    for every view at once; returns ``(committed, commit_seq, last_wave,
    eval_wave, commit_counter)``."""
    edges, base = dag_state["edges"], dag_state["base_round"]
    seen, certs, nr = (dag_state[f] for f in ("block_seen", "cert_seen",
                                              "node_round"))
    com, seq, lw, ew, cnt = (cstate[f] for f in _COMMIT_FIELDS)
    w = cfg.num_rounds
    lb = max(1, w // 2)  # back-chain window (waves live in the ring)
    views = torch.arange(seen.shape[0], device=seen.device)
    i32 = torch.int32

    for _ in range(steps):
        wv = ew + 1
        s_sup_c = (2 * wv + 1) % w
        have_sup = certs[views, s_sup_c].sum(-1)
        complete = (nr > 2 * wv + 1) | ((nr == 2 * wv + 1) & (have_sup >= cfg.quorum))
        l = leader.leader_of(cfg, wv, seed)
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
            lp = leader.leader_of(cfg, wp, seed)
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


def _lib():
    lib = build.load("tusk_commit")
    if lib.tusk_commit_launch.argtypes is None:
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.tusk_commit_launch.argtypes = [ptr] * 15 + [
            c_int, c_int, c_int, ctypes.c_uint32, c_int, ptr]
        lib.tusk_commit_launch.restype = c_int
    return lib


def shared_bytes(n: int, w: int) -> int:
    """Dynamic shared memory of one block (csrc/tusk_commit.cu)."""
    return 8 * (w * n + 4 * w) + 4 * 3 * max(1, w // 2)


def tusk_commit(cfg, dag_state, cstate, seed: int, steps: int):
    """Evaluate up to ``steps`` newly-complete waves in every node's view
    (the Tusk commit rule); returns new ``(committed, commit_seq,
    last_wave, eval_wave, commit_counter)``. ``dag_state``: edges
    bool[W,N,N], block_seen and cert_seen bool[N,W,N], node_round
    int32[N], base_round int32[]; ``cstate``: committed bool[N,W,N],
    commit_seq int32[N,W,N], last_wave, eval_wave and commit_counter
    int32[N]."""
    n, w = cfg.num_nodes, cfg.num_rounds
    b, i32 = torch.bool, torch.int32
    shapes = {"edges": (b, (w, n, n)), "block_seen": (b, (n, w, n)),
              "cert_seen": (b, (n, w, n)), "node_round": (i32, (n,)),
              "base_round": (i32, ()), "committed": (b, (n, w, n)),
              "commit_seq": (i32, (n, w, n)), "last_wave": (i32, (n,)),
              "eval_wave": (i32, (n,)), "commit_counter": (i32, (n,))}
    tensors = {**{f: dag_state[f] for f in _DAG_FIELDS},
               **{f: cstate[f] for f in _COMMIT_FIELDS}}
    dev = operands.placement("tusk_commit", [
        (f, t, *shapes[f]) for f, t in tensors.items()])
    if dev is None:
        return tusk_commit_plain(cfg, dag_state, cstate, seed, steps)
    operands.check_fits("tusk_commit", n, shared_bytes(n, w))
    outs = [torch.empty_like(cstate[f]) for f in _COMMIT_FIELDS]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tusk_commit_launch(
            *(t.data_ptr() for t in tensors.values()),
            *(t.data_ptr() for t in outs), n, w, cfg.quorum,
            leader.seed_constant(seed), steps, stream)
    build.check_launch("tusk_commit", rc)
    tusk_commit.launches += 1
    return tuple(outs)


tusk_commit.launches = 0

"""``dag_ingest``: a batch of DAG messages received over the wire merged
into the DAG state, with the op payloads of fresh blocks written into
SafeKV's ring, in one launch (kernel source: csrc/dag_ingest.cu).

Replaces janus_tpu/consensus/dag.py ``ingest_batch`` (the device part;
its counters, dedupe and int32 conversion stay on the host) and the
``ops_buffer`` / ``buffer_filled`` writes of janus_tpu/net/splitnode.py
``SplitNode._ingest``. The batch travels as one packed int32 tensor
(``pack``); its layout is the kernel source's.

Semantics: a message lands only where ``slot_round[r % W] == r``; every
bool field only gains true; a block's edges land only where it is ok and
did not exist before the batch (first write wins); ``node_round[src]``
takes the max of every block's round, ok or not; a scatter index follows
JAX's rule (``[-N, 0)`` counts from the end, the rest out of range is
dropped) and the gather behind "fresh" clamps, so a source or signer out
of range changes nothing. A listed payload is written at ``[r % W,
src]`` whether or not its block is ok, as JAX's ``.at[].set`` does.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``dag_ingest_plain`` only for tensors that lie on the CPU. Both update
the state (and the ring) in place and return None.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.models.base import gather_index, scatter_index

MAX_FIELDS = 16
_FIELDS = ("edges", "block_exists", "block_seen", "acks", "cert_exists",
           "cert_seen", "node_round")


def edge_words(n: int) -> int:
    return (n + 31) // 32


def pack(n: int, blocks=(), sigs=(), certs=(), seen_by=(),
         payloads: Sequence = ()):
    """The batch as the kernel reads it: ``(int32 array, counts)`` with
    ``counts = (blocks, sigs, certs, seen, payload rows)``. ``blocks``:
    ``(r, src, bool[N] edges)``; ``sigs``: ``(r, src, signer)``;
    ``certs``: ``(r, src)``; ``seen_by``: node ids; ``payloads``: ``(block
    index, int32 row)`` pairs, each row the block's op fields flattened in
    ring order. Values outside int32 raise, as numpy's conversion does."""
    ew = edge_words(n)
    parts = []
    m = len(blocks)
    if m:
        head = np.asarray([(b[0], b[1]) for b in blocks], np.int32)
        rows = np.zeros((m, 32 * ew), bool)
        rows[:, :n] = np.stack([np.asarray(b[2], bool) for b in blocks])
        words = np.packbits(rows, axis=1, bitorder="little").view("<i4")
        parts.append(np.concatenate([head, words.astype(np.int32)], 1).ravel())
    for rows, cols in ((sigs, 3), (certs, 2)):
        if len(rows):
            parts.append(np.asarray(rows, np.int32).reshape(-1, cols).ravel())
    seen = np.asarray(seen_by, np.int32).reshape(-1)
    parts.append(seen)
    for k, row in payloads:
        parts.append(np.asarray([k], np.int32))
        parts.append(np.asarray(row, np.int32).reshape(-1))
    flat = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return flat, (m, len(sigs), len(certs), seen.size, len(payloads))


def _layout(n: int, counts, row: int):
    """Offsets of the five sections and the total length."""
    m, s, c, v, p = counts
    offs = [0, m * (2 + edge_words(n))]
    offs.append(offs[-1] + 3 * s)
    offs.append(offs[-1] + 2 * c)
    offs.append(offs[-1] + v)
    return offs, offs[-1] + p * (1 + row)


def _or_true(x: torch.Tensor, index, where: torch.Tensor) -> None:
    """``x[index] = True`` where ``where`` holds (bool, in place)."""
    x[tuple(i[where] for i in index)] = True


def dag_ingest_plain(cfg, state, msgs: torch.Tensor, counts,
                     ring: Optional[tuple] = None) -> None:
    """Plain PyTorch version, in place. ``ring``: ``(fields, filled)``,
    the ring's int32 tensors ``[W, N, ...]`` in payload order and its
    ``buffer_filled``; needed only when payload rows are given."""
    n, w = cfg.num_nodes, cfg.num_rounds
    m, s, c, v, p = counts
    per = [x[0, 0].numel() for x in ring[0]] if ring else []
    offs, _ = _layout(n, counts, sum(per))
    seen_i, seen_ok = scatter_index(msgs[offs[3]: offs[4]], n)
    slot_round = state["slot_round"]

    def owned(r):
        ss = (r % w).long()
        return ss, slot_round[ss] == r

    def seen_pairs(ss, src_i, ok):
        """Index tuple over (seen node, message) pairs, and where they land."""
        vv = seen_i[:, None].expand(-1, ss.numel())
        where = seen_ok[:, None] & ok[None, :]
        return (vv, ss[None, :].expand_as(vv), src_i[None, :].expand_as(vv)), where

    if m:
        ew = edge_words(n)
        blk = msgs[: offs[1]].view(m, 2 + ew)
        r, src = blk[:, 0], blk[:, 1]
        ss, ok = owned(r)
        src_i, src_ok = scatter_index(src, n)
        fresh = ok & ~state["block_exists"][ss, gather_index(src, n)]
        t = torch.arange(n, device=msgs.device)
        words = blk[:, 2:].long() & 0xFFFFFFFF
        bits = ((words[:, t // 32] >> (t % 32)) & 1).bool()  # [M, N]
        land = src_ok & ok
        _or_true(state["block_exists"], (ss, src_i), land)
        kk, tt = torch.nonzero(bits & (land & fresh)[:, None], as_tuple=True)
        state["edges"][ss[kk], src_i[kk], tt] = True
        _or_true(state["block_seen"], *seen_pairs(ss, src_i, land))
        state["node_round"].scatter_reduce_(0, src_i[src_ok], r[src_ok], "amax")
    if s:
        g = msgs[offs[1]: offs[2]].view(s, 3)
        ss, ok = owned(g[:, 0])
        src_i, src_ok = scatter_index(g[:, 1], n)
        sig_i, sig_ok = scatter_index(g[:, 2], n)
        _or_true(state["acks"], (ss, src_i, sig_i), ok & src_ok & sig_ok)
    if c:
        g = msgs[offs[2]: offs[3]].view(c, 2)
        ss, ok = owned(g[:, 0])
        src_i, src_ok = scatter_index(g[:, 1], n)
        _or_true(state["cert_exists"], (ss, src_i), ok & src_ok)
        _or_true(state["cert_seen"], *seen_pairs(ss, src_i, ok & src_ok))
    if p:
        fields, filled = ring
        rows = msgs[offs[4]:].view(p, 1 + sum(per))
        blk = msgs[: offs[1]].view(m, 2 + edge_words(n))[rows[:, 0].long()]
        ss = (blk[:, 0] % w).long()
        src_i, src_ok = scatter_index(blk[:, 1], n)
        ss, src_i, data = ss[src_ok], src_i[src_ok], rows[src_ok, 1:]
        off = 0
        for x, width in zip(fields, per):
            x[ss, src_i] = data[:, off: off + width].reshape(
                (-1,) + tuple(x.shape[2:]))
            off += width
        filled[ss, src_i] = True


def _lib():
    lib = build.load("dag_ingest")
    if lib.dag_ingest_launch.argtypes is None:
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.dag_ingest_launch.argtypes = (
            [ptr] * 9 + [c_int] * 5
            + [ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_longlong), c_int, ptr, c_int, c_int,
               ptr])
        lib.dag_ingest_launch.restype = c_int
    return lib


def dag_ingest(cfg, state, msgs: torch.Tensor, counts,
               ring: Optional[tuple] = None) -> None:
    """Merge a packed batch (``pack``; its int32 tensor ``msgs`` and its
    ``counts``) into ``state`` in place, and its payload rows into
    ``ring = (fields, filled)``. Nothing is launched for a batch with no
    block, signature or certificate."""
    n, w = cfg.num_nodes, cfg.num_rounds
    m, s, c, v, p = counts
    if p and ring is None:
        raise ValueError("dag_ingest: payload rows need the ring")
    fields, filled = ring if ring is not None else ((), None)
    if len(fields) > MAX_FIELDS:
        raise ValueError(f"dag_ingest: {len(fields)} ring fields, at most "
                         f"{MAX_FIELDS}")
    per = [x[0, 0].numel() for x in fields]
    _, total = _layout(n, counts, sum(per))
    b, i32 = torch.bool, torch.int32
    shapes = {"edges": (w, n, n), "block_exists": (w, n),
              "block_seen": (n, w, n), "acks": (w, n, n),
              "cert_exists": (w, n), "cert_seen": (n, w, n),
              "node_round": (n,)}
    dev = operands.placement("dag_ingest", [
        *((f, state[f], i32 if f == "node_round" else b, shapes[f])
          for f in _FIELDS),
        ("slot_round", state["slot_round"], i32, (w,)),
        ("msgs", msgs, i32, (total,)),
        *((f"ring field {i}", x, i32, (w, n) + tuple(x.shape[2:]))
          for i, x in enumerate(fields)),
        ("buffer_filled", filled, b, (w, n))])
    if dev is None:
        return dag_ingest_plain(cfg, state, msgs, counts, ring)
    operands.check_shared("dag_ingest", w * n)
    if not (m or s or c):
        return None
    lib = _lib()
    ptrs = (ctypes.c_void_p * MAX_FIELDS)(*(x.data_ptr() for x in fields))
    per_c = (ctypes.c_longlong * MAX_FIELDS)(*per)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dag_ingest_launch(
            *(state[f].data_ptr() for f in _FIELDS),
            state["slot_round"].data_ptr(), msgs.data_ptr(), m, s, c, v, p,
            ptrs, per_c, len(fields),
            None if filled is None else filled.data_ptr(), n, w, stream)
    build.check_launch("dag_ingest", rc)
    dag_ingest.launches += 1
    return None


dag_ingest.launches = 0

"""``orset_replay``: batched replay of effect-captured OR-Set ops, the
consensus path's apply (kernel source: csrc/orset_replay.cu).

Replaces janus_tpu/models/orset.py ``_apply_captured_batch`` (vmapped over
the views). Captured ops commute, so a batch folds as one set union per
key: the valid state slots of row k and the op records whose raw key is k
(an add is one record at lane 0 of its capture lanes, a remove/clear one
tombstone record per captured tag that is not SENTINEL) are grouped by
tag; a tag keeps the elem of its first record in (state, then op lane)
order and ORs the tombstones of all of them; the C smallest distinct tags
form the canonical row. ``dropped`` counts distinct tags beyond C, in rows
``[0, K)`` and in the groups of negative raw keys (whose records are
lost, as in JAX); records with raw keys ``>= K`` are ignored.

The wrapper launches the CUDA kernels for CUDA tensors (or raises) and
runs ``orset_replay_plain`` only for tensors that lie on the CPU. Both
return new tensors.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.orset_rows import (
    CAPTURE_FIELDS, DTYPES, FIELDS, OP_ADD, OP_CLEAR, OP_REMOVE, op_operands,
    slot_operands)
from janus_tpu_torch.models.base import OP_NOOP
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order


def orset_replay_plain(state, ops):
    """Plain PyTorch version: the JAX function's record soup with the view
    axis as a batch dimension (one lexicographic sort, segment folds by
    cumulative sums, a compaction sort and a binary search per row).
    ``state``: ``[V, K, C]`` fields; op fields ``[V, B]``; captured fields
    ``[V, B, R]``. Returns ``(new state fields, dropped int32[V])``."""
    V, K, C = state["valid"].shape
    B = ops["op"].shape[-1]
    R = ops["rm_rep"].shape[-1]
    dev = state["valid"].device
    i32 = torch.int32
    en = ops["op"] != OP_NOOP
    is_add = en & (ops["op"] == OP_ADD)
    is_tomb = en & ((ops["op"] == OP_REMOVE) | (ops["op"] == OP_CLEAR))

    # op records share lanes: an add is lane 0 of its capture lanes, a
    # remove/clear its captured tombstones
    lane0 = torch.zeros((B, R), dtype=torch.bool, device=dev)
    lane0[:, :1] = True
    add_l = is_add[..., None] & lane0
    tomb_l = is_tomb[..., None] & (ops["rm_rep"] != SENTINEL)
    op_valid = add_l | tomb_l
    op_rep = torch.where(add_l, ops["a1"][..., None], ops["rm_rep"])
    op_ctr = torch.where(add_l, ops["a2"][..., None], ops["rm_ctr"])
    op_elem = torch.where(add_l, ops["a0"][..., None], ops["rm_elem"])

    st_key = torch.arange(K, dtype=i32, device=dev)[:, None].expand(K, C)
    key = torch.cat([st_key.reshape(1, -1).expand(V, -1),
                     ops["key"][..., None].expand(V, B, R).reshape(V, -1)], -1)

    def soup(s, o):
        return torch.cat([s.reshape(V, -1), o.reshape(V, -1)], -1)

    rep = soup(state["tag_rep"], op_rep)
    ctr = soup(state["tag_ctr"], op_ctr)
    elem = soup(state["elem"], op_elem)
    rm = soup(state["removed"], tomb_l)
    valid = soup(state["valid"], op_valid)
    T = key.shape[-1]

    # invalid records sort last: key K marks them from here on
    key = torch.where(valid, key, K)
    rep = torch.where(valid, rep, SENTINEL)
    ctr = torch.where(valid, ctr, SENTINEL)
    order = lex_order([key, rep, ctr])
    key, rep, ctr, elem, rm = (x.gather(-1, order)
                               for x in (key, rep, ctr, elem, rm))
    valid = key < K

    # segment folds over duplicate tags: tombstone OR by cumulative sums
    first = torch.ones_like(valid)
    first[:, 1:] = ((key[:, 1:] != key[:, :-1]) | (rep[:, 1:] != rep[:, :-1])
                    | (ctr[:, 1:] != ctr[:, :-1]))
    idx = torch.arange(T, dtype=torch.int64, device=dev).expand(V, T)
    rm_int = rm.to(torch.int64)
    csum = torch.cumsum(rm_int, -1)
    csum_prev = csum - rm_int
    nxt_first = torch.cummin(torch.where(first, idx, T).flip(-1), -1).values.flip(-1)
    seg_end = torch.cat([nxt_first[:, 1:],
                         torch.full((V, 1), T, dtype=torch.int64, device=dev)],
                        -1) - 1
    rm_k = (csum.gather(-1, seg_end.clamp(0, T - 1)) - csum_prev) > 0
    keep = valid & first

    # rank among kept records within each key group -> output slot
    inc = keep.to(torch.int64)
    excl = torch.cumsum(inc, -1) - inc
    key_first = torch.ones_like(valid)
    key_first[:, 1:] = key[:, 1:] != key[:, :-1]
    last_kfirst = torch.cummax(torch.where(key_first, idx, 0), -1).values
    rank = excl - excl.gather(-1, last_kfirst)
    ok = keep & (rank < C)

    # kept records to the front in (key, tag) order; each row reads its
    # span, found by binary search
    key_c = torch.where(ok, key, K).to(torch.int64)
    comp = torch.sort(key_c, dim=-1, stable=True).indices
    ckey = key_c.gather(-1, comp).contiguous()
    crep, cctr, celem = (x.gather(-1, comp) for x in (rep, ctr, elem))
    crm = (ok & rm_k).gather(-1, comp)
    ks = torch.arange(K, dtype=torch.int64, device=dev).expand(V, K).contiguous()
    lo = torch.searchsorted(ckey, ks)
    hi = torch.searchsorted(ckey, ks, right=True)
    pos = lo[..., None] + torch.arange(C, device=dev)
    out_valid = pos < hi[..., None]
    pos = pos.clamp(0, T - 1).reshape(V, K * C)

    def take(x):
        return x.gather(-1, pos).reshape(V, K, C)

    dropped = (keep & ~ok).sum(-1).to(i32)
    return {
        "tag_rep": torch.where(out_valid, take(crep), SENTINEL),
        "tag_ctr": torch.where(out_valid, take(cctr), SENTINEL),
        "elem": torch.where(out_valid, take(celem), 0),
        "removed": out_valid & take(crm),
        "valid": out_valid,
    }, dropped


def _lib():
    lib = build.load("orset_replay")
    if lib.orset_replay_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.orset_replay_launch.argtypes = [ptr] * 23 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.orset_replay_launch.restype = ctypes.c_int
    return lib


def orset_replay(state, ops):
    """Replay a captured op batch into every view's rows: returns ``(new
    state fields [V, K, C], dropped int32[V])``. ``state``: the five slot
    fields ``[V, K, C]``; op fields int32 ``[V, B]``; captured fields
    ``rm_rep``/``rm_ctr``/``rm_elem`` int32 ``[V, B, R]``."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("orset_replay: state must be [V, K, C] and op "
                         "fields [V, B]")
    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    R = ops["rm_rep"].shape[-1] if ops["rm_rep"].dim() == 3 else -1
    dev = operands.placement("orset_replay", [
        *slot_operands("state.", state, (V, K, C)), *op_operands(ops, (V, B)),
        *op_operands(ops, (V, B, R), CAPTURE_FIELDS)])
    if dev is None:
        return orset_replay_plain(state, ops)
    per_view = K * C + B * R
    if per_view >= 2**31:
        raise ValueError(f"orset_replay: {per_view} records per view do not "
                         f"fit int32 record ids")
    out = {f: torch.empty((V, K, C), dtype=DTYPES[f], device=dev)
           for f in FIELDS}
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    if V * K * C == 0 and V * B * R == 0:
        return out, dropped
    # bucket scratch: per view K+1 counts (rows, then negative raw keys),
    # K+2 offsets, K+1 cursors, and 16 bytes per record
    counts = torch.zeros((V, K + 1), dtype=torch.int32, device=dev)
    offsets = torch.empty((V, K + 2), dtype=torch.int32, device=dev)
    cursor = torch.empty((V, K + 1), dtype=torch.int32, device=dev)
    records = torch.empty((V * per_view, 4), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.orset_replay_launch(
            *(state[f].data_ptr() for f in FIELDS),
            *(ops[f].data_ptr() for f in ("op", "key", "a0", "a1", "a2")),
            *(ops[f].data_ptr() for f in CAPTURE_FIELDS),
            *(out[f].data_ptr() for f in FIELDS), dropped.data_ptr(),
            counts.data_ptr(), offsets.data_ptr(), cursor.data_ptr(),
            records.data_ptr(), V, K, C, B, R, stream)
    build.check_launch("orset_replay", rc)
    orset_replay.launches += 1
    return out, dropped


orset_replay.launches = 0

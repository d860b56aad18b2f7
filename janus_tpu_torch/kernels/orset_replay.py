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
return new tensors. On the card one call is two launches: the op records
grouped by (view, row), then a warp a group (a block where rows take
hundreds of records) merges its sorted records into its sorted row
(csrc/orset_replay.cu).
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


# csrc/orset_replay.cu: the most records a group's bucket holds and the
# widest row the walk takes
MAX_BUCKET = 2048
MAX_SLOTS = 2048

_LAUNCH = build.LeanLaunch(
    "orset_replay", "orset_replay_launch",
    [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6)

# (device index, stream) -> [count int32 (zero between calls), work int32]
_SCRATCH: dict = {}


def bucket_records(K: int, B: int) -> int:
    """Records a group's bucket holds at K rows and B op lanes a view:
    twice the lanes a row on average plus 32, a multiple of 32, at most
    ``MAX_BUCKET`` (a group past it is gathered again from the op fields;
    the recorded consensus and harness calls hold at most 1.3 times the
    mean, and under 900 records a group)."""
    mean = -(-B // max(K, 1))
    return min(MAX_BUCKET, (2 * mean + 32 + 31) // 32 * 32)


def scratch_ints(V: int, K: int, B: int, R: int, cap: int):
    """int32 words of a call's two scratch buffers (csrc/orset_replay.cu):
    the groups' counts, and the work area (the views' spill cursors, the
    buckets of 16-byte records, the spill's records and counts)."""
    span = B * R + K + 1
    return V * (K + 1), 4 * ((V + 3) // 4) + 4 * V * (K + 1) * cap \
        + 5 * V * span


def scratch(dev: torch.device, count: int, work: int):
    """The cached scratch of the current stream on ``dev``, grown to at
    least ``count`` and ``work`` int32 words. The counts come zeroed and
    every launch leaves them so; the work area needs no initialisation.
    Returns (key, count, work)."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    held = _SCRATCH.get(key)
    if held is None:
        held = _SCRATCH[key] = [torch.zeros(0, dtype=torch.int32, device=dev)] * 2
    if held[0].numel() < count:
        held[0] = torch.zeros(count, dtype=torch.int32, device=dev)
    if held[1].numel() < work:
        held[1] = torch.empty(work, dtype=torch.int32, device=dev)
    return key, held[0], held[1]


def orset_replay(state, ops):
    """Replay a captured op batch into every view's rows: returns ``(new
    state fields [V, K, C], dropped int32[V])``. ``state``: the five slot
    fields ``[V, K, C]``; op fields int32 ``[V, B]``; captured fields
    ``rm_rep``/``rm_ctr``/``rm_elem`` int32 ``[V, B, R]``. On the card:
    two launches (csrc/orset_replay.cu) on the lean launch path
    (``operands.lean_placement``, ``build.LeanLaunch``), the scratch
    cached per device and stream; rows of at most ``MAX_SLOTS`` slots."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("orset_replay: state must be [V, K, C] and op "
                         "fields [V, B]")
    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    R = ops["rm_rep"].shape[-1] if ops["rm_rep"].dim() == 3 else -1
    dev = operands.lean_placement("orset_replay", [
        *slot_operands("state.", state, (V, K, C)), *op_operands(ops, (V, B)),
        *op_operands(ops, (V, B, R), CAPTURE_FIELDS)])
    if dev is None:
        return orset_replay_plain(state, ops)
    if C > MAX_SLOTS:
        raise ValueError(f"orset_replay: the kernel takes rows of at most "
                         f"{MAX_SLOTS} slots, got {C}")
    if B * R >= 2**30 or V > 65535:
        raise ValueError(f"orset_replay: the kernel takes B * R < 2^30 and "
                         f"V <= 65,535, got B={B}, R={R}, V={V}")
    out = {f: torch.empty((V, K, C), dtype=DTYPES[f], device=dev)
           for f in FIELDS}
    dropped = torch.empty((V,), dtype=torch.int32, device=dev)
    if V == 0:
        return out, dropped
    cap = bucket_records(K, B)
    key, count, work = scratch(dev, *scratch_ints(V, K, B, R, cap))
    try:
        _LAUNCH(dev, *(state[f].data_ptr() for f in FIELDS),
                *(ops[f].data_ptr() for f in ("op", "key", "a0", "a1", "a2")),
                *(ops[f].data_ptr() for f in CAPTURE_FIELDS),
                *(out[f].data_ptr() for f in FIELDS), dropped.data_ptr(),
                count.data_ptr(), work.data_ptr(), V, K, C, B, R, cap)
    except RuntimeError:
        _SCRATCH.pop(key, None)  # the counts may not be zero any more
        raise
    orset_replay.launches += 1
    return out, dropped


orset_replay.launches = 0

"""``orset_apply``: the OR-Set's sequential apply of ops, per replica, in
place (kernel source: csrc/orset_apply.cu).

Replaces the ``lax.scan`` of janus_tpu/models/orset.py ``_apply_ops_impl``
(vmapped over the replicas): uncaptured, and captured (the scan JAX runs
for a one-lane captured batch). Ops apply in lane order,
each to the row of its key (gathered by JAX's gather rule, written back by
its scatter rule, so an op whose key is out of range after negative
normalisation changes nothing but may count a drop):

- add (a0=elem, a1/a2=tag): fold into the slot holding the tag (first
  hit), setting its elem; else append it and keep the C smallest tags, a
  full row evicting the largest (possibly the newcomer) and counting one
  drop;
- remove: tombstone the valid slots of elem a0; clear: every valid slot;
  with captured ``rm_rep``/``rm_ctr``/``rm_elem`` (``[R, B, r_cap]``) a
  remove or clear instead unions its row with the captured tags as dead
  records (``setops.slot_union`` with the OR-Set's fold, capacity C; the
  records beyond C count as drops, even for a key out of range);
- every op with an in-range key leaves its row canonical.

On the card one call is two CUDA launches: the lanes grouped by (replica,
gathered row), then only the groups with lanes walked, no row that no
lane gathers read (csrc/orset_apply.cu); it adds one to
``orset_apply.launches``. The wrapper launches the kernels for CUDA
tensors (or raises) and runs ``orset_apply_plain`` only for tensors that
lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.lane_buckets import (bucket_records,
                                                  forget_scratch, scratch)
from janus_tpu_torch.kernels.orset_rows import (
    CAPTURE_FIELDS, FIELDS, KEY_FIELDS, OP_ADD, OP_CLEAR, OP_REMOVE,
    canonical_row, fold_duplicate, op_operands, slot_operands)
from janus_tpu_torch.models.base import OP_NOOP, gather_index, scatter_index
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import row_find, slot_union


def orset_apply_plain(state, ops) -> torch.Tensor:
    """Plain PyTorch version: the JAX scan as a Python loop over the op
    lanes with the replica axis as a batch dimension. ``state``: the
    five slot fields ``[R, K, C]``, updated in place; op fields
    ``[R, B]``, with the captured fields ``[R, B, r_cap]`` for captured
    ops. Returns the drop count per replica, int32 ``[R]``."""
    R, K, C = state["valid"].shape
    B = ops["op"].shape[-1]
    dev = state["valid"].device
    rr = torch.arange(R, device=dev)
    gi = gather_index(ops["key"], K)
    wi, wok = scatter_index(ops["key"], K)
    dropped = torch.zeros((R,), dtype=torch.int32, device=dev)
    for b in range(B):
        row = {f: state[f][rr, gi[:, b]] for f in FIELDS}          # [R, C]
        op, a0, a1, a2 = (ops[f][:, b] for f in ("op", "a0", "a1", "a2"))
        en = op != OP_NOOP
        do_add = en & (op == OP_ADD)
        found, fidx = row_find(row, KEY_FIELDS, (a1, a2))
        dropped += (do_add & ~found & row["valid"].all(-1)).to(torch.int32)
        folded = dict(row)
        folded["elem"] = row["elem"].scatter(-1, fidx.long()[:, None],
                                             a0[:, None])
        appended = canonical_row({
            "tag_rep": torch.cat([row["tag_rep"], a1[:, None]], -1),
            "tag_ctr": torch.cat([row["tag_ctr"], a2[:, None]], -1),
            "elem": torch.cat([row["elem"], a0[:, None]], -1),
            "removed": torch.cat([row["removed"],
                                  torch.zeros_like(row["removed"][:, :1])], -1),
            "valid": torch.cat([row["valid"],
                                torch.ones_like(row["valid"][:, :1])], -1),
        })
        add, fnd = do_add[:, None], found[:, None]
        added = {f: torch.where(add, torch.where(fnd, folded[f],
                                                 appended[f][:, :C]), row[f])
                 for f in FIELDS}
        if "rm_rep" in ops:
            is_tomb = en & ((op == OP_REMOVE) | (op == OP_CLEAR))
            rm_rep = ops["rm_rep"][:, b]
            cap = {"valid": (rm_rep != SENTINEL) & is_tomb[:, None],
                   "tag_rep": rm_rep, "tag_ctr": ops["rm_ctr"][:, b],
                   "elem": ops["rm_elem"][:, b],
                   "removed": torch.ones_like(rm_rep, dtype=torch.bool)}
            merged, ovf = slot_union(added, cap, KEY_FIELDS, fold_duplicate,
                                     capacity=C)
            dropped += torch.where(is_tomb, ovf, 0).to(torch.int32)
            new_row = canonical_row({f: torch.where(is_tomb[:, None], merged[f],
                                                    added[f]) for f in FIELDS})
        else:
            rm_mask = row["valid"] & (row["elem"] == a0[:, None])
            tomb = torch.where((en & (op == OP_REMOVE))[:, None], rm_mask,
                               (en & (op == OP_CLEAR))[:, None] & row["valid"])
            added["removed"] = added["removed"] | tomb
            new_row = canonical_row(added)
        ok = wok[:, b]
        for f in FIELDS:
            state[f][rr[ok], wi[ok, b]] = new_row[f][ok]
    return dropped


# csrc/orset_apply.cu: the widest row the warp walk holds (wider rows, and
# the captured mode, take the block walk) and the most lanes a replica
MAX_WARP_SLOTS = 512
MAX_LANES = 2**21

_PTRS = ctypes.POINTER(ctypes.c_void_p)
_LAUNCH = build.LeanLaunch(
    "orset_apply", "orset_apply_launch",
    (_PTRS, _PTRS, _PTRS, ctypes.c_int, ctypes.c_void_p, _PTRS,
     *(ctypes.c_int,) * 6))


def shared_bytes(c: int, r_cap: int = 0) -> int:
    """Shared memory of one block of the block walk (csrc/orset_apply.cu,
    the captured mode and rows over ``MAX_WARP_SLOTS``): a 16-byte sort
    record per slot and captured tag, two 14-byte row copies per slot, the
    lane list of a tile of 128 ops, a flag byte per record and a few
    words."""
    return 17 * (c + r_cap) + 2 * (-(-14 * c // 16) * 16) + 4 * 128 + 256


def orset_apply(state, ops) -> torch.Tensor:
    """Apply op lanes in order to every replica's rows, in place.
    ``state``: the five slot fields ``[R, K, C]``; op fields int32 ``[R,
    B]``, with ``rm_rep``/``rm_ctr``/``rm_elem`` int32 ``[R, B, r_cap]``
    for captured ops. Returns the drop count per replica, int32 ``[R]``.
    On the card: two launches (csrc/orset_apply.cu: the lanes bucketed by
    (replica, gathered row), then only those groups walked, a warp's
    threads holding a row in registers) on the lean launch path
    (``operands.lean_placement``, ``build.LeanLaunch``), the groups'
    scratch cached per device and stream (``lane_buckets.scratch``)."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("orset_apply: state must be [R, K, C] and op "
                         "fields [R, B]")
    R, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    captured = "rm_rep" in ops
    r_cap = ops["rm_rep"].shape[-1] if captured else 0
    dev = operands.lean_placement("orset_apply", [
        *slot_operands("state.", state, (R, K, C)), *op_operands(ops, (R, B)),
        *(op_operands(ops, (R, B, r_cap), CAPTURE_FIELDS) if captured else ())])
    if dev is None:
        return orset_apply_plain(state, ops)
    if captured or C > MAX_WARP_SLOTS:
        operands.check_shared("orset_apply", shared_bytes(C, r_cap))
    if (K == 0 or C == 0) and R * B > 0:
        raise ValueError("orset_apply: no slot rows to gather from")
    if B >= MAX_LANES or R > 65535:
        raise ValueError(f"orset_apply: the kernel takes fewer than "
                         f"{MAX_LANES} lanes a replica and at most 65,535 "
                         f"replicas, got B={B}, R={R}")
    if R * B == 0:
        return torch.zeros((R,), dtype=torch.int32, device=dev)
    dropped = torch.empty((R,), dtype=torch.int32, device=dev)
    cap = bucket_records(K, B)
    key, sc = scratch("orset_apply", dev, R * K, R * K * cap,
                      R * K + R * B // (cap + 1) + 1)
    st = (ctypes.c_void_p * 5)(*(state[f].data_ptr() for f in FIELDS))
    op = (ctypes.c_void_p * 5)(*(ops[f].data_ptr() for f in
                                 ("op", "key", "a0", "a1", "a2")))
    rm = ((ctypes.c_void_p * 3)(*(ops[f].data_ptr() for f in CAPTURE_FIELDS))
          if captured else None)
    try:
        _LAUNCH(dev, st, op, rm, r_cap, dropped.data_ptr(), sc.ptrs, R, K, C,
                B, cap, sc.parity)
    except RuntimeError:
        forget_scratch(key)  # the counts may not be zero any more
        raise
    sc.parity ^= 1
    orset_apply.launches += 1
    return dropped


orset_apply.launches = 0

"""``rga_apply``: the RGA's sequential apply of insert/delete ops, per
replica, in place (kernel source: csrc/rga_apply.cu).

Replaces the ``lax.scan`` of janus_tpu/models/rga.py ``_apply_ops_impl``
(vmapped over the replicas), uncaptured and captured. Ops apply in lane
order, each to the row of its key (gathered by JAX's gather rule, written
back with the document's Lamport floor by its scatter rule, so an op whose
key is out of range after negative normalisation changes nothing but may
count a drop):

- insert (a0=chr, a1/a2=parent rep/ctr): the counter is the op's
  ``eff_ctr``, or one more than the larger of the row's greatest valid
  ``id_ctr`` (at least 0) and ``ctr_floor[k]``; then an upsert of id
  ``(ctr, writer)``: an existing slot takes the max of its parent and chr
  with the op's, else a fresh live slot lands in the first free one;
- delete (a1/a2=target rep/ctr): an upsert of id ``(a2, a1)`` that sets
  ``dead``, or lands a dead placeholder;
- an upsert of an absent id into a full row counts one drop;
- ``ctr_floor[k]`` takes the max with the counter the op carries.

``rga_capture`` is the kernel's capture mode, a wrapper with its own
counter: the uncaptured walk, which also returns each lane's minted
counter as ``eff_ctr`` (0 for a lane that is not an insert). It replaces
the sequential capture of janus_tpu/models/base.py ``capture_and_apply``
with janus_tpu/models/rga.py ``prepare_ops``: each lane's prepare observes
the state the earlier lanes left, which is what the uncaptured mint
reads.

On the card the live lanes are bucketed by gathered row first and a warp
walks each row's in lane order, so no-op lanes (most of SafeKV's delta
applies: 16,384 lanes a view) are never walked; their one effect, the
floor's clamp at 0, is applied where the first live lane after the
lowest of them would see it. The wrappers launch the CUDA kernel for CUDA
tensors (or raise) and run the plain versions only for tensors that lie
on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.rga_rows import (
    FIELDS, KEY_FIELDS, OP_DELETE, OP_FIELDS, OP_INSERT, slot_operands)
from janus_tpu_torch.models.base import OP_NOOP, gather_index, scatter_index
from janus_tpu_torch.ops.setops import row_upsert


def _fold_insert(old, new):
    """Redelivery and ordering fold of an insert into an existing id: the
    tombstone is sticky, the insert's edge and payload win over a
    placeholder's zeros."""
    return {"par_rep": torch.maximum(old["par_rep"], new["par_rep"]),
            "par_ctr": torch.maximum(old["par_ctr"], new["par_ctr"]),
            "chr": torch.maximum(old["chr"], new["chr"]),
            "dead": old["dead"]}


def _fold_delete(old, new):
    return {"par_rep": old["par_rep"], "par_ctr": old["par_ctr"],
            "chr": old["chr"], "dead": torch.ones_like(old["dead"])}


def rga_apply_plain(state, ops, minted=None) -> torch.Tensor:
    """Plain PyTorch version: the JAX scan as a Python loop over the op
    lanes with the replica axis as a batch dimension. ``state``: the seven
    slot fields ``[R, K, C]`` and ``ctr_floor`` ``[R, K]``, updated in
    place; op fields int32 ``[R, B]`` (``eff_ctr`` ``[R, B, 1]`` when
    captured). ``minted`` (int32 ``[R, B, 1]``, uncaptured ops only), when
    given, receives each lane's counter, 0 where the lane is not an
    insert. Returns the drop count per replica, int32 ``[R]``."""
    R, K, C = state["valid"].shape
    B = ops["op"].shape[-1]
    dev = state["valid"].device
    rr = torch.arange(R, device=dev)
    gi = gather_index(ops["key"], K)
    wi, wok = scatter_index(ops["key"], K)
    stats = {"slots_dropped": torch.zeros((R,), dtype=torch.int32, device=dev)}
    zero = torch.zeros((R,), dtype=torch.int32, device=dev)
    for b in range(B):
        floor = state["ctr_floor"][rr, gi[:, b]]                     # [R]
        op, a0, a1, a2, wr = (ops[f][:, b]
                              for f in ("op", "a0", "a1", "a2", "writer"))
        en = op != OP_NOOP
        is_ins = en & (op == OP_INSERT)
        is_del = en & (op == OP_DELETE)
        ok = wok[:, b]
        if not bool((is_ins | is_del).any()):
            # no upsert in any replica: only the floor's max with 0
            state["ctr_floor"][rr[ok], wi[ok, b]] = floor[ok].clamp(min=0)
            continue
        row = {f: state[f][rr, gi[:, b]] for f in FIELDS}          # [R, C]
        if "eff_ctr" in ops:
            ctr = ops["eff_ctr"][:, b, 0]
        else:
            top = torch.where(row["valid"], row["id_ctr"], 0).amax(-1)
            ctr = torch.maximum(top, floor) + 1
        if minted is not None:
            minted[:, b, 0] = torch.where(is_ins, ctr, 0)
        inserted = row_upsert(
            row, KEY_FIELDS, (ctr, wr),
            {"par_rep": a1, "par_ctr": a2, "chr": a0, "dead": False},
            _fold_insert, enabled=is_ins, stats=stats)
        deleted = row_upsert(
            inserted, KEY_FIELDS, (a2, a1),
            {"par_rep": zero, "par_ctr": zero, "chr": zero, "dead": True},
            _fold_delete, enabled=is_del, stats=stats)
        seen = torch.maximum(torch.where(is_ins, ctr, 0),
                             torch.where(is_del, a2, 0))
        new_floor = torch.maximum(floor, torch.where(en, seen, 0))
        for f in FIELDS:
            state[f][rr[ok], wi[ok, b]] = deleted[f][ok]
        state["ctr_floor"][rr[ok], wi[ok, b]] = new_floor[ok]
    return stats["slots_dropped"]


def _lib():
    lib = build.load("rga_apply")
    if lib.rga_apply_launch.argtypes is None:
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        dims = [ctypes.c_int] * 4
        lib.rga_apply_launch.argtypes = [arr, ptr, arr, ptr, ptr, *dims, ptr]
        lib.rga_apply_launch.restype = ctypes.c_int
        lib.rga_capture_launch.argtypes = [arr, ptr, arr, ptr, ptr, ptr,
                                           *dims, ptr]
        lib.rga_capture_launch.restype = ctypes.c_int
        lib.rga_apply_scratch_ints.argtypes = [ctypes.c_int] * 3
        lib.rga_apply_scratch_ints.restype = ctypes.c_longlong
    return lib


def _scratch(lib, R, K, B, dev):
    """The lane buckets a call at (R, K, B) walks from (csrc/rga_apply.cu),
    uninitialised: the launch zeroes their counts."""
    n = lib.rga_apply_scratch_ints(R, K, B)
    if R * K >= 2**31:
        raise ValueError(f"rga_apply: the walk takes R * K < 2^31, got "
                         f"R={R}, K={K}")
    return torch.empty((n,), dtype=torch.int32, device=dev)


def shared_bytes(c: int) -> int:
    """Shared memory of one block (csrc/rga_apply.cu): the row's 22 bytes
    a slot and a bucket's 128 lanes and their fields (32 bytes each)."""
    return 22 * c + 32 * 128


def rga_apply(state, ops) -> torch.Tensor:
    """Apply op lanes in order to every replica's rows, in place.
    ``state``: the seven slot fields ``[R, K, C]`` and ``ctr_floor``
    ``[R, K]``; op fields int32 ``[R, B]``, with ``eff_ctr`` ``[R, B, 1]``
    for captured ops. Returns the drop count per replica, int32 ``[R]``."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("rga_apply: state must be [R, K, C] and op fields "
                         "[R, B]")
    R, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    eff = ops.get("eff_ctr")
    dev = operands.placement("rga_apply", [
        *slot_operands("state.", state, (R, K, C)),
        ("state.ctr_floor", state["ctr_floor"], torch.int32, (R, K)),
        *[(f"op field {f!r}", ops[f], torch.int32, (R, B)) for f in OP_FIELDS],
        ("op field 'eff_ctr'", eff, torch.int32, (R, B, 1))])
    if dev is None:
        return rga_apply_plain(state, ops)
    operands.check_shared("rga_apply", shared_bytes(C))
    if (K == 0 or C == 0) and R * B > 0:
        raise ValueError("rga_apply: no slot rows to gather from")
    dropped = torch.zeros((R,), dtype=torch.int32, device=dev)
    if R * K * B == 0:
        return dropped
    lib = _lib()
    scratch = _scratch(lib, R, K, B, dev)
    st = (ctypes.c_void_p * 7)(*(state[f].data_ptr() for f in FIELDS))
    op = (ctypes.c_void_p * 7)(*(ops[f].data_ptr() for f in OP_FIELDS),
                               None if eff is None else eff.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rga_apply_launch(
            st, state["ctr_floor"].data_ptr(), op, dropped.data_ptr(),
            None if scratch is None else scratch.data_ptr(), R, K, C, B,
            stream)
    build.check_launch("rga_apply", rc)
    rga_apply.launches += 1
    return dropped


rga_apply.launches = 0


def rga_capture_plain(state, ops):
    """Plain PyTorch version of the capture mode: ``rga_apply_plain`` on
    uncaptured ops, recording the counters. Returns ``(eff_ctr int32 [R,
    B, 1], dropped int32 [R])``."""
    R, B = ops["op"].shape
    eff = torch.zeros((R, B, 1), dtype=torch.int32, device=ops["op"].device)
    dropped = rga_apply_plain(state, ops, minted=eff)
    return eff, dropped


def rga_capture(state, ops):
    """Capture and apply uncaptured op lanes in order, in place: the
    ``rga_apply`` walk, minting each insert's Lamport counter against the
    state the earlier lanes left. ``state`` as for ``rga_apply``; op
    fields int32 ``[R, B]`` (no ``eff_ctr``). Returns ``(eff_ctr int32 [R,
    B, 1], dropped int32 [R])``: the minted counter of each insert (a
    dropped one included), 0 for other lanes."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("rga_capture: state must be [R, K, C] and op "
                         "fields [R, B]")
    if "eff_ctr" in ops:
        raise ValueError("rga_capture: the ops are already captured")
    R, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    dev = operands.placement("rga_capture", [
        *slot_operands("state.", state, (R, K, C)),
        ("state.ctr_floor", state["ctr_floor"], torch.int32, (R, K)),
        *[(f"op field {f!r}", ops[f], torch.int32, (R, B)) for f in OP_FIELDS]])
    if dev is None:
        return rga_capture_plain(state, ops)
    operands.check_shared("rga_capture", shared_bytes(C))
    if (K == 0 or C == 0) and R * B > 0:
        raise ValueError("rga_capture: no slot rows to gather from")
    dropped = torch.zeros((R,), dtype=torch.int32, device=dev)
    eff = torch.empty((R, B, 1), dtype=torch.int32, device=dev)
    if R * B == 0:
        return eff, dropped
    lib = _lib()
    scratch = _scratch(lib, R, K, B, dev)
    st = (ctypes.c_void_p * 7)(*(state[f].data_ptr() for f in FIELDS))
    op = (ctypes.c_void_p * 7)(*(ops[f].data_ptr() for f in OP_FIELDS), None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rga_capture_launch(
            st, state["ctr_floor"].data_ptr(), op, eff.data_ptr(),
            dropped.data_ptr(), None if scratch is None else
            scratch.data_ptr(), R, K, C, B, stream)
    build.check_launch("rga_capture", rc)
    rga_capture.launches += 1
    return eff, dropped


rga_capture.launches = 0

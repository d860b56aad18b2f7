"""``orset_compact``: the OR-Set's compaction of tombstoned slots per row,
behind the GC fence's counter watermark (kernel source:
csrc/orset_compact.cu).

Replaces janus_tpu/models/orset.py ``compact`` and ``compact_fence``
(vmapped over the views). Three entry points, all counted on
``orset_compact.launches``:

- ``orset_watermark(live_op, live_a2)``: the least ``a2`` of the live
  ring's adds (SENTINEL when there is none), as an int32 ``[1]`` tensor on
  the device; the host never reads it, so a round stays free of syncs;
- ``orset_compact(rows, wm, protect, out)``: keep the valid slots that are
  live, pinned by ``protect`` or at or above the watermark, in their
  order, and fill the rest canonically; in place when ``out`` is ``rows``
  (then a row that would not change is not written);
- ``orset_compact_fences(states, live_op, live_a2)``: one GC advance, in
  place: the watermark of the ring and the compaction of every state
  behind it, one call on the lean launch path and two CUDA launches (the
  compaction by programmatic dependent launch). SafeKV's GC fence calls
  it once an advance, for its prospective and stable states.

The wrappers launch the CUDA kernels for CUDA tensors (or raise) and run
the plain versions only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.orset_rows import (
    DTYPES, FIELDS, KEY_FIELDS, OP_ADD, slot_operands)
from janus_tpu_torch.ops.lattice import SENTINEL

# a zeroed ticket counter per device, which the watermark's last block
# leaves at 0 (csrc/orset_compact.cu)
_TICKETS: dict = {}
# rows up to this many slots are held in a warp's registers; longer ones
# are staged in shared memory (csrc/orset_compact.cu)
MAX_WARP_SLOTS = 256
# the states one fused call takes (csrc/orset_compact.cu MAX_STATES)
MAX_STATES = 4


def orset_watermark_plain(live_op, live_a2) -> torch.Tensor:
    """Plain PyTorch version: ``min(where(op == OP_ADD, a2, SENTINEL))``
    over every lane, as int32 ``[1]``."""
    wm = torch.where(live_op == OP_ADD, live_a2, SENTINEL).reshape(-1)
    if wm.numel() == 0:
        return torch.full((1,), SENTINEL, dtype=torch.int32,
                          device=live_op.device)
    return wm.min().reshape(1).to(torch.int32)


def orset_compact_plain(rows, wm=None, protect=None, out=None):
    """Plain PyTorch version. ``rows``: the five slot fields ``[..., C]``;
    ``wm``: int32 ``[1]`` or None; ``protect``: bool ``[..., C]`` or None.
    Returns the compacted fields, written into ``out`` when given (which
    may be ``rows``)."""
    keep = ~rows["removed"]
    if protect is not None:
        keep = keep | protect
    if wm is not None:
        keep = keep | (rows["tag_ctr"] >= wm[0])
    keep = rows["valid"] & keep
    order = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices
    res = {f: torch.where(keep, rows[f], SENTINEL if f in KEY_FIELDS else 0)
           .to(DTYPES[f]).gather(-1, order) for f in FIELDS}
    res["valid"] = keep.gather(-1, order)
    if out is None:
        return res
    for f in FIELDS:
        out[f].copy_(res[f])
    return out


def orset_compact_fences_plain(states, live_op, live_a2):
    """Plain PyTorch version of one GC advance: ``orset_watermark_plain``,
    then ``orset_compact_plain`` of each state in place behind it.
    Returns the states."""
    wm = orset_watermark_plain(live_op, live_a2)
    for st in states:
        orset_compact_plain(st, wm, out=st)
    return states


def _lib():
    lib = build.load("orset_compact")
    if lib.orset_compact_launch.argtypes is None:
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        lib.orset_watermark_launch.argtypes = [ptr, ptr, ctypes.c_longlong,
                                               ptr, ptr, ptr, ptr]
        lib.orset_watermark_launch.restype = ctypes.c_int
        lib.orset_watermark_blocks.restype = ctypes.c_int
        lib.orset_compact_launch.argtypes = [arr, arr, ptr, ptr,
                                             ctypes.c_longlong, ctypes.c_int,
                                             ptr]
        lib.orset_compact_launch.restype = ctypes.c_int
    return lib


def shared_bytes(c: int) -> int:
    """Shared memory of one warp of the staged compaction, the kernel of
    rows over 256 slots (csrc/orset_compact.cu): the three int32 of a
    slot and a byte of its flags."""
    return 4 * (3 * c + -(-c // 4))


def orset_watermark(live_op, live_a2) -> torch.Tensor:
    """The GC fence's counter watermark: the least ``a2`` over the lanes
    whose ``op`` is an add (int32, any shape, the same for both), or
    SENTINEL; int32 ``[1]`` on the device."""
    shape = tuple(live_op.shape)
    dev = operands.placement("orset_watermark", [
        ("live_op", live_op, torch.int32, shape),
        ("live_a2", live_a2, torch.int32, shape)])
    if dev is None:
        return orset_watermark_plain(live_op, live_a2)
    lib = _lib()
    ticket = _TICKETS.get(dev)
    if ticket is None:
        ticket = _TICKETS[dev] = torch.zeros((1,), dtype=torch.int32,
                                             device=dev)
    partial = torch.empty((lib.orset_watermark_blocks(),), dtype=torch.int32,
                          device=dev)
    wm = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.orset_watermark_launch(
            live_op.data_ptr(), live_a2.data_ptr(), live_op.numel(),
            partial.data_ptr(), ticket.data_ptr(), wm.data_ptr(), stream)
    build.check_launch("orset_watermark", rc)
    orset_compact.launches += 1
    return wm


def orset_compact(rows, wm=None, protect=None, out=None):
    """Compact every ``[C]`` row of ``rows`` (the five slot fields ``[...,
    C]``): keep the valid slots that are live, pinned by ``protect`` (bool
    ``[..., C]``, optional) or whose ``tag_ctr`` is at least ``wm[0]``
    (int32 ``[1]`` from ``orset_watermark``, optional), in their order,
    and fill the rest canonically. Returns fresh tensors, or writes into
    ``out`` (which may be ``rows``: in place)."""
    shape = tuple(rows["valid"].shape)
    dev = operands.placement("orset_compact", [
        *slot_operands("rows.", rows, shape),
        ("wm", wm, torch.int32, (1,)),
        ("protect", protect, torch.bool, shape),
        *([] if out is None else slot_operands("out.", out, shape))])
    if dev is None:
        return orset_compact_plain(rows, wm, protect, out)
    C = shape[-1] if shape else 0
    if C > MAX_WARP_SLOTS:
        operands.check_shared("orset_compact", shared_bytes(C))
    if out is None:
        out = {f: torch.empty(shape, dtype=DTYPES[f], device=dev)
               for f in FIELDS}
    n = math.prod(shape[:-1]) if shape else 0
    if n * C == 0:
        return out
    lib = _lib()
    src = (ctypes.c_void_p * 5)(*(rows[f].data_ptr() for f in FIELDS))
    dst = (ctypes.c_void_p * 5)(*(out[f].data_ptr() for f in FIELDS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.orset_compact_launch(
            src, dst, None if protect is None else protect.data_ptr(),
            None if wm is None else wm.data_ptr(), n, C, stream)
    build.check_launch("orset_compact", rc)
    orset_compact.launches += 1
    return out


orset_compact.launches = 0

_ptr = ctypes.c_void_p
_FENCES = build.LeanLaunch(
    "orset_compact", "orset_compact_fences_launch",
    [ctypes.POINTER(_ptr), ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
     _ptr, _ptr, ctypes.c_longlong, _ptr, ctypes.c_int])
# the fused call's field pointers and rows a state, refilled by each call
_FIELDS = (_ptr * (5 * MAX_STATES))()
_ROWS = (ctypes.c_longlong * MAX_STATES)()
# (device index, stream) -> the fused call's scratch: the watermark
# grid's minima a block
_SCRATCH: dict = {}


def _scratch(dev: torch.device):
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    held = _SCRATCH.get(key)
    if held is None:
        held = _SCRATCH[key] = torch.empty(
            (_lib().orset_watermark_blocks(),), dtype=torch.int32, device=dev)
    return held


def orset_compact_fences(states, live_op, live_a2):
    """One GC advance of the OR-Set, in place: the counter watermark of
    the live ring (``live_op``, ``live_a2``: int32 of one shape) and the
    compaction behind it of every state of ``states`` (up to four, each
    the five slot fields ``[..., C]`` of one shape), as
    ``orset_watermark`` then ``orset_compact(st, wm, out=st)`` each.
    Returns the states. On the card one call, two CUDA launches."""
    states = tuple(states)
    if not states:
        return states
    shape = states[0]["valid"].shape
    ring = live_op.shape
    dev = operands.lean_placement("orset_compact_fences", [
        *(op for i, st in enumerate(states)
          for op in slot_operands(f"states[{i}].", st, shape)),
        ("live_op", live_op, torch.int32, ring),
        ("live_a2", live_a2, torch.int32, ring)])
    if dev is None:
        return orset_compact_fences_plain(states, live_op, live_a2)
    if len(states) > MAX_STATES:
        raise ValueError(f"orset_compact_fences: {len(states)} states, at "
                         f"most {MAX_STATES}")
    C = shape[-1] if len(shape) else 0
    if C > MAX_WARP_SLOTS:
        operands.check_shared("orset_compact_fences", shared_bytes(C))
    rows = math.prod(shape[:-1]) if len(shape) else 0
    fields, counts = _FIELDS, _ROWS
    fields[:5 * len(states)] = [st[f].data_ptr() for st in states
                                for f in FIELDS]
    counts[:len(states)] = [rows] * len(states)
    _FENCES(dev, fields, counts, len(states), live_op.data_ptr(),
            live_a2.data_ptr(), live_op.numel(), _scratch(dev).data_ptr(), C)
    orset_compact.launches += 1
    return states

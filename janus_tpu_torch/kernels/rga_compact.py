"""``rga_compact``: the RGA's compaction of tombstoned leaves per row
(kernel source: csrc/rga_compact.cu).

Replaces janus_tpu/models/rga.py ``compact`` (vmapped over replicas): a
slot is kept when it is valid and live, or valid and the parent of some
valid slot, or valid and pinned by ``protect``; kept slots move to the
front in their order, the rest are filled canonically. Bound on the H100 by
bytes (each slot read and written once); JAX's ``[C, C]`` parent compare
becomes, on a row whose ids are sorted, one search of each valid slot's
parent reference among the ids, and on any other row a sort of the
parent references and one search per slot. See the source note.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``rga_compact_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.rga_rows import (
    DTYPES, FIELDS, KEY_FIELDS, slot_operands)
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order, pack_pair


def is_parent(rows) -> torch.Tensor:
    """bool ``[..., C]``: some valid slot of the row references the slot's
    id as its parent (JAX's ``[C, C]`` compare, as a sort of the parent
    references and a search: within equal references valid ones first)."""
    ref = pack_pair(rows["par_ctr"], rows["par_rep"])
    order = lex_order([ref, ~rows["valid"]])
    sref = ref.gather(-1, order).contiguous()
    svalid = rows["valid"].gather(-1, order)
    ids = pack_pair(rows["id_ctr"], rows["id_rep"]).contiguous()
    pos = torch.searchsorted(sref, ids)
    at = pos.clamp(max=max(ref.shape[-1] - 1, 0))
    return ((pos < ref.shape[-1]) & (sref.gather(-1, at) == ids)
            & svalid.gather(-1, at))


def rga_compact_plain(rows, protect=None, out=None):
    """Plain PyTorch version. ``rows``: the seven slot fields ``[..., C]``;
    ``protect``: bool ``[..., C]`` or None. Returns the compacted fields,
    written into ``out`` when given (which may be ``rows``)."""
    keep = rows["valid"] & (~rows["dead"] | is_parent(rows))
    if protect is not None:
        keep = keep | (rows["valid"] & protect)
    order = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices
    res = {}
    for f in FIELDS:
        fill = SENTINEL if f in KEY_FIELDS else 0
        kept = torch.where(keep, rows[f], fill).to(DTYPES[f])
        res[f] = kept.gather(-1, order)
    res["valid"] = keep.gather(-1, order)
    if out is None:
        return res
    for f in FIELDS:
        out[f].copy_(res[f])
    return out


def _lib():
    lib = build.load("rga_compact")
    if lib.rga_compact_launch.argtypes is None:
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        lib.rga_compact_launch.argtypes = [arr, arr, ptr, ctypes.c_longlong,
                                           ctypes.c_int, ptr]
        lib.rga_compact_launch.restype = ctypes.c_int
    return lib


def shared_bytes(c: int) -> int:
    """Shared memory of one block (csrc/rga_compact.cu): the staged row
    (22 bytes a slot and a protect byte), a keep byte a slot, and the
    kept counts of each warp's share of every 256 slots, with their
    total; and the 34 words of an unsorted row's ballot prefix sums."""
    def r16(x):
        return (x + 15) & ~15
    return r16(23 * c) + r16(c) + 4 * (8 * -(-c // 256) + 1) + 4 * 34


def rga_compact(rows, protect=None, out=None):
    """Compact every ``[C]`` row of ``rows`` (the seven slot fields
    ``[..., C]``): keep the valid slots that are live, parents of a valid
    slot, or pinned by ``protect`` (bool ``[..., C]``, optional), in their
    order, and fill the rest canonically. Returns fresh tensors, or writes
    into ``out`` (which may be ``rows``: in place)."""
    shape = tuple(rows["valid"].shape)
    dev = operands.placement("rga_compact", [
        *slot_operands("rows.", rows, shape),
        ("protect", protect, torch.bool, shape),
        *([] if out is None else slot_operands("out.", out, shape))])
    if dev is None:
        return rga_compact_plain(rows, protect, out)
    C = shape[-1] if shape else 0
    operands.check_shared("rga_compact", shared_bytes(C))
    if out is None:
        out = {f: torch.empty(shape, dtype=DTYPES[f], device=dev)
               for f in FIELDS}
    n = math.prod(shape[:-1]) if shape else 0
    if n * C == 0:
        return out
    lib = _lib()
    src = (ctypes.c_void_p * 7)(*(rows[f].data_ptr() for f in FIELDS))
    dst = (ctypes.c_void_p * 7)(*(out[f].data_ptr() for f in FIELDS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rga_compact_launch(
            src, dst, None if protect is None else protect.data_ptr(), n, C,
            stream)
    build.check_launch("rga_compact", rc)
    rga_compact.launches += 1
    return out


rga_compact.launches = 0

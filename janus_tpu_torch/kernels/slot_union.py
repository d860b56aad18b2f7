"""``slot_union``: the sorted union of two OR-Set slot sets per row
(kernel source: csrc/slot_union.cu).

Replaces janus_tpu/ops/setops.py ``slot_union`` with the OR-Set's fold
(janus_tpu/models/orset.py ``_combine``), the join behind ``merge`` and
the replica-axis converge. Bound on the H100 by bytes: every input slot is
read once and every output slot written once; see the source note.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``slot_union_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.orset_rows import (
    DTYPES, FIELDS, KEY_FIELDS, fold_duplicate, slot_operands)
from janus_tpu_torch.ops.setops import slot_union as _generic_union


def slot_union_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version: ``ops.setops.slot_union`` on the OR-Set's
    fields with its fold. ``a``: ``[..., Ca]``, ``b``: ``[..., Cb]`` slot
    sets (the five fields of ``orset_rows.FIELDS``, leading axes equal).
    Returns ``(out, overflow int32[...])``; with ``out`` (tensors
    ``[P, ..., cap]``) the union is written into each of its P rows."""
    sa = {"valid": a["valid"], **{f: a[f] for f in FIELDS if f != "valid"}}
    sb = {"valid": b["valid"], **{f: b[f] for f in FIELDS if f != "valid"}}
    res, overflow = _generic_union(sa, sb, KEY_FIELDS, fold_duplicate, capacity)
    if out is None:
        return {f: res[f] for f in FIELDS}, overflow
    for f in FIELDS:
        out[f].copy_(res[f].expand_as(out[f]))
    return out, overflow


def _lib():
    lib = build.load("slot_union")
    if lib.slot_union_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.slot_union_launch.argtypes = [ptr] * 16 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.slot_union_launch.restype = ctypes.c_int
    return lib


def shared_bytes(ca: int, cb: int) -> int:
    """Shared memory of one block (csrc/slot_union.cu): 24 bytes per input
    record, and the prefix sum's 4 KB."""
    return 24 * (ca + cb) + 16 + operands.SCAN_SHARED_BYTES


def slot_union(a, b, capacity: int | None = None, out=None):
    """Union of ``a`` ``[..., Ca]`` and ``b`` ``[..., Cb]`` by tag, per
    row: a duplicate tag keeps its first copy's elem and ORs its
    tombstone with the copy after it, the kept tags are cut to the
    ``capacity`` smallest, and invalid slots are filled canonically.
    Returns ``(out, overflow int32[...])`` with ``out`` fresh tensors
    ``[..., capacity]``, or written into ``out`` (``[P, ..., capacity]``,
    every one of its P rows; it may alias ``a`` or ``b``)."""
    lead = tuple(a["valid"].shape[:-1])
    ca, cb = a["valid"].shape[-1], b["valid"].shape[-1]
    cap = capacity if capacity is not None else max(ca, cb)
    out_shape = None if out is None else tuple(out["valid"].shape)
    if out_shape is not None and (len(out_shape) != len(lead) + 2
                                  or out_shape[1:] != lead + (cap,)):
        raise ValueError(f"slot_union: out has shape {out_shape}, expected "
                         f"[P, {', '.join(map(str, lead + (cap,)))}]")
    dev = operands.placement("slot_union", [
        *slot_operands("a.", a, lead + (ca,)),
        *slot_operands("b.", b, lead + (cb,)),
        *([] if out is None else slot_operands("out.", out, out_shape))])
    if dev is None:
        return slot_union_plain(a, b, cap, out)
    operands.check_shared("slot_union", shared_bytes(ca, cb))
    rows = math.prod(lead)
    repeat = 1 if out is None else out_shape[0]
    if out is None:
        out = {f: torch.empty(lead + (cap,), dtype=DTYPES[f], device=dev)
               for f in FIELDS}
    overflow = torch.empty(lead, dtype=torch.int32, device=dev)
    if rows == 0 or repeat == 0:
        return out, overflow.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slot_union_launch(
            *(a[f].data_ptr() for f in FIELDS),
            *(b[f].data_ptr() for f in FIELDS),
            *(out[f].data_ptr() for f in FIELDS), overflow.data_ptr(),
            rows, ca, cb, cap, repeat, stream)
    build.check_launch("slot_union", rc)
    slot_union.launches += 1
    return out, overflow


slot_union.launches = 0

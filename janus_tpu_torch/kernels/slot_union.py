"""``slot_union``: the sorted union of two OR-Set slot sets per row
(kernel source: csrc/slot_union.cu).

Replaces janus_tpu/ops/setops.py ``slot_union`` with the OR-Set's fold
(janus_tpu/models/orset.py ``_combine``), the join behind ``merge`` and
the replica-axis converge. Bound on the H100 by bytes: every input slot is
read once and every output slot written once; see the source note.

``slot_union_rows`` is the kernel's row-list mode: one level of the
converge's halving tree over listed key rows only, the count of rows read
from device memory. ``models.orset.join_replica_rows`` runs the tree with
it in place of the slab gather, ``join_all`` and scatter of
janus_tpu/runtime/store.py ``converge_delta``.

The wrappers launch the CUDA kernel for CUDA tensors (or raise) and run
their plain versions only for tensors that lie on the CPU.
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
        lib.slot_union_rows_launch.argtypes = [ptr] * 15 + [
            ptr, ctypes.c_int, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        lib.slot_union_rows_launch.restype = ctypes.c_int
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


def slot_union_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                          scatter: bool = False):
    """Plain PyTorch version: gather the listed rows, ``slot_union_plain``,
    write the result back. Arguments as for ``slot_union_rows``."""
    m = int(n_rows)
    keys = rows[:m].long()
    src = keys if gather else torch.arange(keys.numel(), device=keys.device)
    res, _ = slot_union_plain({f: a[f][:, src] for f in FIELDS},
                              {f: b[f][:, src] for f in FIELDS},
                              a["valid"].shape[-1])
    for f in FIELDS:
        if scatter:
            out[f][:, keys] = res[f]
        else:
            out[f][:, :keys.numel()] = res[f]
    return out


def slot_union_rows(a, b, out, rows, n_rows, gather: bool = True,
                    scatter: bool = False):
    """One level of the converge's halving tree over listed key rows: for
    ``j < n_rows`` (int32[] on the device, read there; at most L counted)
    and each pair ``r``, the union of ``a[r, x]`` and ``b[r, x]`` with
    ``x = rows[j]`` (``gather``: a and b are views of the state) or ``x =
    j`` (scratch of an earlier level). Without ``scatter`` it is written at
    ``out[r, j]``; with it (one pair) at ``out[p, rows[j]]`` for every
    replica p of the state ``out`` (which may then alias a and b). ``a``,
    ``b``: ``[P, K, C]`` slot sets, ``out`` ``[P, K, C]`` or ``[R, K, C]``;
    ``rows``: int32[L] distinct keys in [0, K). Returns ``out``."""
    if a["valid"].dim() != 3:
        raise ValueError(f"slot_union_rows: a has shape "
                         f"{tuple(a['valid'].shape)}, expected [P, K, C]")
    P, K, C = a["valid"].shape
    L = rows.shape[0] if rows.dim() == 1 else -1
    out_lead = tuple(out["valid"].shape[:1]) if scatter else (P,)
    if scatter and P != 1:
        raise ValueError(f"slot_union_rows: scatter takes one pair, got {P}")
    dev = operands.placement("slot_union_rows", [
        *slot_operands("a.", a, (P, K, C)), *slot_operands("b.", b, (P, K, C)),
        *slot_operands("out.", out, out_lead + (K, C)),
        ("rows", rows, torch.int32, (L,)), ("n_rows", n_rows, torch.int32, ())])
    if dev is None:
        return slot_union_rows_plain(a, b, out, rows, n_rows, gather, scatter)
    operands.check_shared("slot_union_rows", shared_bytes(C, C))
    repeat = out_lead[0]
    if P * K * C * L * repeat == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.slot_union_rows_launch(
            *(a[f].data_ptr() for f in FIELDS),
            *(b[f].data_ptr() for f in FIELDS),
            *(out[f].data_ptr() for f in FIELDS), rows.data_ptr(), L,
            n_rows.data_ptr(), P, K, C, int(gather), int(scatter), repeat,
            stream)
    build.check_launch("slot_union_rows", rc)
    slot_union_rows.launches += 1
    return out


slot_union_rows.launches = 0

"""``mvr_merge``: the MVRegister's join of two states per key row, and its
row-list mode ``mvr_merge_rows`` (kernel source: csrc/mvr_merge.cu).

Replaces janus_tpu/models/mvregister.py ``merge_with_stats``: per row the
entries of both states reduced to their causal frontier (strictly
dominated values and later exact (val, clock) twins dropped, the kept
ordered by (val, clock lanes), cut to the capacity; ``kernels.mvr_rows.
frontier``), the join of ``merge`` and of the replica-axis converge.
``mvr_merge_rows`` is one level of ``converge_delta``'s tree over listed
key rows, as ``slot_union_rows`` is for the OR-Set; both run through
``kernels.replica_tree.join_tree`` / ``join_tree_rows``, which pair rows as
janus_tpu/runtime/store.py ``join_all`` does (the capacity cut makes the
join order-sensitive once a frontier overflows).

The wrappers launch the CUDA kernel for CUDA tensors (or raise) and run
their plain versions only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.mvr_rows import FIELDS, frontier, slot_operands

WARPS = 4  # warps a block (csrc/mvr_merge.cu), one row each


def _lib():
    lib = build.load("mvr_merge")
    if lib.mvr_merge_launch.argtypes is None:
        ptr, arr, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.c_int
        lib.mvr_merge_launch.argtypes = [arr, arr, arr, ptr,
                                         ctypes.c_longlong, i32, i32, i32,
                                         i32, i32, ptr]
        lib.mvr_merge_launch.restype = ctypes.c_int
        lib.mvr_merge_rows_launch.argtypes = [arr, arr, arr, ptr, i32, ptr,
                                              i32, i32, i32, i32, i32, i32,
                                              i32, ptr]
        lib.mvr_merge_rows_launch.restype = ctypes.c_int
    return lib


def _ptrs(slots):
    return (ctypes.c_void_p * 3)(*(slots[f].data_ptr() for f in FIELDS))


def shared_bytes(n: int, w: int) -> int:
    """Shared memory of one block (csrc/mvr_merge.cu): per warp, n entries
    of ``w | 1`` clock ints, val and the output map (4 bytes each), valid
    and keep (1 each), rounded to 16 bytes."""
    per = 4 * (n * (w | 1) + 2 * n) + 2 * n
    return WARPS * ((per + 15) & ~15)


def mvr_merge_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version of ``mvr_merge``."""
    cap = a["val"].shape[-1] if capacity is None else capacity
    res, overflow = frontier(torch.cat([a["val"], b["val"]], -1),
                             torch.cat([a["valid"], b["valid"]], -1),
                             torch.cat([a["clock"], b["clock"]], -2), cap)
    if out is None:
        return res, overflow
    for f in FIELDS:
        out[f].copy_(res[f].expand_as(out[f]))
    return out, overflow


def mvr_merge(a, b, capacity: int | None = None, out=None):
    """Join of MVRegister rows ``a`` (``val``, ``valid`` ``[..., Va]``,
    ``clock`` ``[..., Va, W]``) and ``b`` (``[..., Vb]``) per row: the
    causal frontier of the Va + Vb entries in ``capacity`` slots (default
    Va; at most Va + Vb). Returns ``(out, overflow int32[...])``, the kept
    values that did not fit counted in ``overflow``; ``out`` is fresh
    tensors, or written into ``out`` (``[P, ..., capacity]``, every one of
    its P rows; it may alias ``a`` or ``b``)."""
    lead = tuple(a["val"].shape[:-1])
    va, vb = a["val"].shape[-1], b["val"].shape[-1]
    w = a["clock"].shape[-1]
    cap = va if capacity is None else capacity
    if cap > va + vb:
        raise ValueError(f"mvr_merge: capacity {cap} exceeds the {va + vb} "
                         "entries of a row")
    out_lead = None if out is None else tuple(out["val"].shape[:-1])
    if out_lead is not None and (len(out_lead) != len(lead) + 1
                                 or out_lead[1:] != lead):
        raise ValueError(f"mvr_merge: out has shape {out_lead + (cap,)}, "
                         f"expected [P, {', '.join(map(str, lead + (cap,)))}]")
    dev = operands.placement("mvr_merge", [
        *slot_operands("a.", a, lead, va, w),
        *slot_operands("b.", b, lead, vb, w),
        *([] if out is None else slot_operands("out.", out, out_lead, cap, w))])
    if dev is None:
        return mvr_merge_plain(a, b, cap, out)
    operands.check_shared("mvr_merge", shared_bytes(va + vb, w))
    rows = math.prod(lead)
    repeat = 1 if out is None else out_lead[0]
    if out is None:
        out = {"val": torch.empty(lead + (cap,), dtype=torch.int32, device=dev),
               "valid": torch.empty(lead + (cap,), dtype=torch.bool,
                                    device=dev),
               "clock": torch.empty(lead + (cap, w), dtype=torch.int32,
                                    device=dev)}
    overflow = torch.empty(lead, dtype=torch.int32, device=dev)
    if rows == 0 or repeat == 0:
        return out, overflow.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mvr_merge_launch(_ptrs(a), _ptrs(b), _ptrs(out),
                                  overflow.data_ptr(), rows, va, vb, cap, w,
                                  repeat, stream)
    build.check_launch("mvr_merge", rc)
    mvr_merge.launches += 1
    return out, overflow


mvr_merge.launches = 0


def mvr_merge_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                         scatter: bool = False):
    """Plain PyTorch version of ``mvr_merge_rows``: gather the listed rows,
    ``mvr_merge_plain``, write the result back."""
    m = int(n_rows)
    keys = rows[:m].long()
    src = keys if gather else torch.arange(keys.numel(), device=keys.device)
    res, _ = mvr_merge_plain({f: a[f][:, src] for f in FIELDS},
                             {f: b[f][:, src] for f in FIELDS},
                             a["val"].shape[-1])
    for f in FIELDS:
        if scatter:
            out[f][:, keys] = res[f]
        else:
            out[f][:, :keys.numel()] = res[f]
    return out


def mvr_merge_rows(a, b, out, rows, n_rows, gather: bool = True,
                   scatter: bool = False):
    """One level of the converge's halving tree over listed key rows: for
    ``j < n_rows`` (int32[] on the device, read there; at most L counted)
    and each pair ``r``, the join of ``a[r, x]`` and ``b[r, x]`` with ``x
    = rows[j]`` (``gather``: a and b are views of the state) or ``x = j``
    (scratch of an earlier level). Without ``scatter`` it is written at
    ``out[r, j]``; with it (one pair) at ``out[p, rows[j]]`` for every
    replica p of the state ``out`` (which may then alias a and b). ``a``,
    ``b``: ``val``/``valid`` ``[P, K, V]``, ``clock`` ``[P, K, V, W]``;
    ``out`` ``[P, K, V]`` or ``[R, K, V]``; ``rows``: int32[L] distinct
    keys in [0, K). Returns ``out``."""
    if a["val"].dim() != 3:
        raise ValueError(f"mvr_merge_rows: a has shape "
                         f"{tuple(a['val'].shape)}, expected [P, K, V]")
    P, K, V = a["val"].shape
    w = a["clock"].shape[-1]
    L = rows.shape[0] if rows.dim() == 1 else -1
    out_lead = tuple(out["val"].shape[:1]) if scatter else (P,)
    if scatter and P != 1:
        raise ValueError(f"mvr_merge_rows: scatter takes one pair, got {P}")
    dev = operands.placement("mvr_merge_rows", [
        *slot_operands("a.", a, (P, K), V, w),
        *slot_operands("b.", b, (P, K), V, w),
        *slot_operands("out.", out, out_lead + (K,), V, w),
        ("rows", rows, torch.int32, (L,)), ("n_rows", n_rows, torch.int32, ())])
    if dev is None:
        return mvr_merge_rows_plain(a, b, out, rows, n_rows, gather, scatter)
    operands.check_shared("mvr_merge_rows", shared_bytes(2 * V, w))
    repeat = out_lead[0]
    if P * K * V * L * repeat == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mvr_merge_rows_launch(
            _ptrs(a), _ptrs(b), _ptrs(out), rows.data_ptr(), L,
            n_rows.data_ptr(), P, K, V, w, int(gather), int(scatter), repeat,
            stream)
    build.check_launch("mvr_merge_rows", rc)
    mvr_merge_rows.launches += 1
    return out


mvr_merge_rows.launches = 0

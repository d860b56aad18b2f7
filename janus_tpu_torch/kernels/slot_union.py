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

The source takes the slot layout and its duplicate fold as template
parameters; ``Layout`` is its Python side, and ``union`` / ``union_rows``
the launch of any layout (``kernels.rga_union`` is the RGA's,
``kernels.lww_union`` the LWW-Set's, ``tp_union`` the 2P-Set's and the
Graph vertices', ``edge_union`` the Graph edges'); ``kernels.replica_tree``
runs the converge's halving tree through them.

The wrappers launch the CUDA kernel for CUDA tensors (or raise) and run
their plain versions only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch

from janus_tpu_torch.kernels import (build, lww_rows, operands, orset_rows,
                                     tp_rows)
from janus_tpu_torch.ops.setops import slot_union as _generic_union


class Layout(NamedTuple):
    """A slot layout of ``csrc/slot_union.cu``: its fields in the C entry
    points' order (``keys`` int32 keys, int32 payloads, a bool flag if the
    layout has one, valid), their dtypes, the duplicate fold of the plain
    version, the count of int32 payload fields, the two C entry points
    and the count of key fields. Every layout joins by a merge of sorted
    rows (``merge_row``)."""
    fields: tuple
    dtypes: dict
    fold: Callable
    payloads: int
    launch: str
    rows_launch: str
    keys: int = 2

    @property
    def key_fields(self):
        return self.fields[:self.keys]

    def operands(self, prefix, slots, shape):
        """``operands.placement`` entries for the fields of a slot set."""
        return [(f"{prefix}{f}", slots[f], self.dtypes[f], shape)
                for f in self.fields]


ORSET = Layout(orset_rows.FIELDS, orset_rows.DTYPES,
               orset_rows.fold_duplicate, 1, "slot_union_launch",
               "slot_union_rows_launch")
LWW = Layout(lww_rows.FIELDS, lww_rows.DTYPES, lww_rows.fold_duplicate, 4,
             "lww_union_launch", "lww_union_rows_launch", keys=1)
TP = Layout(tp_rows.TP_FIELDS, tp_rows.DTYPES, tp_rows.fold_duplicate, 0,
            "tp_union_launch", "tp_union_rows_launch", keys=1)
EDGE = Layout(tp_rows.EDGE_FIELDS, tp_rows.DTYPES, tp_rows.fold_duplicate, 0,
              "edge_union_launch", "edge_union_rows_launch")


def union_plain(layout: Layout, a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version: ``ops.setops.slot_union`` on the layout's
    fields with its fold. ``a``: ``[..., Ca]``, ``b``: ``[..., Cb]`` slot
    sets (leading axes equal). Returns ``(out, overflow int32[...])``; with
    ``out`` (tensors ``[P, ..., cap]``) the union is written into each of
    its P rows."""
    fields = layout.fields
    sa = {"valid": a["valid"], **{f: a[f] for f in fields if f != "valid"}}
    sb = {"valid": b["valid"], **{f: b[f] for f in fields if f != "valid"}}
    res, overflow = _generic_union(sa, sb, layout.key_fields, layout.fold,
                                   capacity)
    if out is None:
        return {f: res[f] for f in fields}, overflow
    for f in fields:
        out[f].copy_(res[f].expand_as(out[f]))
    return out, overflow


def _lib():
    lib = build.load("slot_union")
    if lib.slot_union_launch.argtypes is None:
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        for name in ("slot_union_launch", "rga_union_launch",
                     "lww_union_launch", "tp_union_launch",
                     "edge_union_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [arr, arr, arr, ptr, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        for name in ("slot_union_rows_launch", "rga_union_rows_launch",
                     "lww_union_rows_launch", "tp_union_rows_launch",
                     "edge_union_rows_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [arr, arr, arr, ptr, ctypes.c_int, ptr,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
    return lib


def _ptrs(layout: Layout, slots):
    return (ctypes.c_void_p * len(layout.fields))(
        *(slots[f].data_ptr() for f in layout.fields))


def shared_bytes(ca: int, cb: int, layout: Layout = ORSET) -> int:
    """Shared memory of one block joining one row (csrc/slot_union.cu):
    per input record 4 bytes per key field, 4 per payload field, 2 + 2 of
    orders and 1 of flags (25 for the RGA and the LWW-Set, 17 for the
    OR-Set, 13 for edges, 9 for the TP layout), and the prefix sum's 4 KB.
    The most rows a block holds follow: Ca + Cb <= 25,355 records for the
    TP layout (a full join of rows up to 12,677 slots), 17,553 for edges
    (8,776 slots), 13,423 for the OR-Set (6,711 slots), 9,128 for the RGA
    and the LWW-Set (4,564 slots). (The warp merge puts up to
    ``WARP_ROWS`` rows in a block, as many as fit.)"""
    per = 4 * layout.keys + 5 + 4 * layout.payloads
    return per * (ca + cb) + 16 + operands.SCAN_SHARED_BYTES


def union(layout: Layout, wrapper, a, b, capacity: int | None = None,
          out=None):
    """The union of ``a`` ``[..., Ca]`` and ``b`` ``[..., Cb]`` per row in
    ``layout``, on the card through the kernel (counted on ``wrapper``),
    or through ``union_plain`` for tensors on the CPU. Arguments and
    result as for ``slot_union``."""
    name = wrapper.__name__
    lead = tuple(a["valid"].shape[:-1])
    ca, cb = a["valid"].shape[-1], b["valid"].shape[-1]
    cap = capacity if capacity is not None else max(ca, cb)
    out_shape = None if out is None else tuple(out["valid"].shape)
    if out_shape is not None and (len(out_shape) != len(lead) + 2
                                  or out_shape[1:] != lead + (cap,)):
        raise ValueError(f"{name}: out has shape {out_shape}, expected "
                         f"[P, {', '.join(map(str, lead + (cap,)))}]")
    dev = operands.placement(name, [
        *layout.operands("a.", a, lead + (ca,)),
        *layout.operands("b.", b, lead + (cb,)),
        *([] if out is None else layout.operands("out.", out, out_shape))])
    if dev is None:
        return union_plain(layout, a, b, cap, out)
    operands.check_shared(name, shared_bytes(ca, cb, layout))
    rows = math.prod(lead)
    repeat = 1 if out is None else out_shape[0]
    if out is None:
        out = {f: torch.empty(lead + (cap,), dtype=layout.dtypes[f],
                              device=dev) for f in layout.fields}
    overflow = torch.empty(lead, dtype=torch.int32, device=dev)
    if rows == 0 or repeat == 0:
        return out, overflow.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, layout.launch)(
            _ptrs(layout, a), _ptrs(layout, b), _ptrs(layout, out),
            overflow.data_ptr(), rows, ca, cb, cap, repeat, stream)
    build.check_launch(name, rc)
    wrapper.launches += 1
    return out, overflow


def union_rows_plain(layout: Layout, a, b, out, rows, n_rows,
                     gather: bool = True, scatter: bool = False):
    """Plain PyTorch version of the row-list mode: gather the listed rows,
    ``union_plain``, write the result back. Arguments as for
    ``slot_union_rows``."""
    m = int(n_rows)
    keys = rows[:m].long()
    src = keys if gather else torch.arange(keys.numel(), device=keys.device)
    res, _ = union_plain(layout, {f: a[f][:, src] for f in layout.fields},
                         {f: b[f][:, src] for f in layout.fields},
                         a["valid"].shape[-1])
    for f in layout.fields:
        if scatter:
            out[f][:, keys] = res[f]
        else:
            out[f][:, :keys.numel()] = res[f]
    return out


def union_rows(layout: Layout, wrapper, a, b, out, rows, n_rows,
               gather: bool = True, scatter: bool = False):
    """One level of the converge's halving tree over listed key rows in
    ``layout``, through the kernel (counted on ``wrapper``) or, for CPU
    tensors, ``union_rows_plain``. Arguments as for ``slot_union_rows``."""
    name = wrapper.__name__
    if a["valid"].dim() != 3:
        raise ValueError(f"{name}: a has shape {tuple(a['valid'].shape)}, "
                         f"expected [P, K, C]")
    P, K, C = a["valid"].shape
    L = rows.shape[0] if rows.dim() == 1 else -1
    out_lead = tuple(out["valid"].shape[:1]) if scatter else (P,)
    if scatter and P != 1:
        raise ValueError(f"{name}: scatter takes one pair, got {P}")
    dev = operands.placement(name, [
        *layout.operands("a.", a, (P, K, C)),
        *layout.operands("b.", b, (P, K, C)),
        *layout.operands("out.", out, out_lead + (K, C)),
        ("rows", rows, torch.int32, (L,)), ("n_rows", n_rows, torch.int32, ())])
    if dev is None:
        return union_rows_plain(layout, a, b, out, rows, n_rows, gather,
                                scatter)
    operands.check_shared(name, shared_bytes(C, C, layout))
    if L * P >= 1 << 30:
        raise ValueError(f"{name}: {L} listed rows x {P} pairs, the kernel "
                         f"takes fewer than 2^30")
    repeat = out_lead[0]
    if P * K * C * L * repeat == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, layout.rows_launch)(
            _ptrs(layout, a), _ptrs(layout, b), _ptrs(layout, out),
            rows.data_ptr(), L, n_rows.data_ptr(), P, K, C, int(gather),
            int(scatter), repeat, stream)
    build.check_launch(name, rc)
    wrapper.launches += 1
    return out


def slot_union_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version of ``slot_union``: ``ops.setops.slot_union``
    on the OR-Set's fields (``orset_rows.FIELDS``) with its fold."""
    return union_plain(ORSET, a, b, capacity, out)


def slot_union(a, b, capacity: int | None = None, out=None):
    """Union of ``a`` ``[..., Ca]`` and ``b`` ``[..., Cb]`` by tag, per
    row: a duplicate tag keeps its first copy's elem and ORs its
    tombstone with the copy after it, the kept tags are cut to the
    ``capacity`` smallest, and invalid slots are filled canonically.
    Returns ``(out, overflow int32[...])`` with ``out`` fresh tensors
    ``[..., capacity]``, or written into ``out`` (``[P, ..., capacity]``,
    every one of its P rows; it may alias ``a`` or ``b``)."""
    return union(ORSET, slot_union, a, b, capacity, out)


slot_union.launches = 0


def slot_union_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                          scatter: bool = False):
    """Plain PyTorch version of ``slot_union_rows``."""
    return union_rows_plain(ORSET, a, b, out, rows, n_rows, gather, scatter)


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
    return union_rows(ORSET, slot_union_rows, a, b, out, rows, n_rows, gather,
                      scatter)


slot_union_rows.launches = 0


def lww_union_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version of ``lww_union``: ``ops.setops.slot_union``
    on the LWW-Set's fields (``lww_rows.FIELDS``) with its fold."""
    return union_plain(LWW, a, b, capacity, out)


def lww_union(a, b, capacity: int | None = None, out=None):
    """Union of LWW-Set slot sets ``a`` ``[..., Ca]`` and ``b`` ``[...,
    Cb]`` by elem, per row (the LWW instantiation of csrc/slot_union.cu;
    replaces janus_tpu/ops/setops.py ``slot_union`` with
    janus_tpu/models/lwwset.py ``_combine``): a duplicate elem keeps the
    lexicographic max of each stamp pair, the low word unsigned (the kept
    copy's on a tie), the kept elems are cut to the ``capacity``
    smallest, and invalid slots are filled canonically. Returns ``(out,
    overflow int32[...])`` with ``out`` fresh tensors ``[..., capacity]``,
    or written into ``out`` (``[P, ..., capacity]``, every one of its P
    rows; it may alias ``a`` or ``b``). Bound on the H100 by bytes: 21 a
    slot, each read and written once."""
    return union(LWW, lww_union, a, b, capacity, out)


lww_union.launches = 0


def lww_union_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                         scatter: bool = False):
    """Plain PyTorch version of ``lww_union_rows``."""
    return union_rows_plain(LWW, a, b, out, rows, n_rows, gather, scatter)


def lww_union_rows(a, b, out, rows, n_rows, gather: bool = True,
                   scatter: bool = False):
    """One level of the converge's halving tree over listed key rows
    ``rows[:n_rows]`` (``n_rows`` int32[] on the device, read there), as
    ``slot_union_rows`` does for the OR-Set: ``a``, ``b`` ``[P, K, C]``
    LWW-Set slot sets, ``out`` ``[P, K, C]`` scratch or, with ``scatter``
    (one pair), the ``[R, K, C]`` state. Returns ``out``."""
    return union_rows(LWW, lww_union_rows, a, b, out, rows, n_rows, gather,
                      scatter)


lww_union_rows.launches = 0


def tp_union_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version of ``tp_union``: ``ops.setops.slot_union`` on
    the TP layout's fields (``tp_rows.TP_FIELDS``) with the tombstone OR."""
    return union_plain(TP, a, b, capacity, out)


def tp_union(a, b, capacity: int | None = None, out=None):
    """Union of 2P slot sets ``a`` ``[..., Ca]`` and ``b`` ``[..., Cb]`` by
    elem, per row (the TP instantiation of csrc/slot_union.cu; replaces
    janus_tpu/ops/setops.py ``slot_union`` with janus_tpu/models/tpset.py
    ``_combine``, and the vertex union of janus_tpu/models/graph.py
    ``merge``): a duplicate elem ORs its tombstones, the kept elems are cut
    to the ``capacity`` smallest, and invalid slots are filled canonically.
    Returns ``(out, overflow int32[...])`` with ``out`` fresh tensors
    ``[..., capacity]``, or written into ``out`` (``[P, ..., capacity]``,
    every one of its P rows; it may alias ``a`` or ``b``). Bound on the H100
    by bytes: 6 a slot, each read and written once."""
    return union(TP, tp_union, a, b, capacity, out)


tp_union.launches = 0


def tp_union_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                        scatter: bool = False):
    """Plain PyTorch version of ``tp_union_rows``."""
    return union_rows_plain(TP, a, b, out, rows, n_rows, gather, scatter)


def tp_union_rows(a, b, out, rows, n_rows, gather: bool = True,
                  scatter: bool = False):
    """One level of the converge's halving tree over listed key rows
    ``rows[:n_rows]`` (``n_rows`` int32[] on the device, read there), as
    ``slot_union_rows`` does for the OR-Set: ``a``, ``b`` ``[P, K, C]`` 2P
    slot sets, ``out`` ``[P, K, C]`` scratch or, with ``scatter`` (one
    pair), the ``[R, K, C]`` state. Returns ``out``."""
    return union_rows(TP, tp_union_rows, a, b, out, rows, n_rows, gather,
                      scatter)


tp_union_rows.launches = 0


def edge_union_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version of ``edge_union``: ``ops.setops.slot_union``
    on the EDGE layout's fields (``tp_rows.EDGE_FIELDS``) with the
    tombstone OR."""
    return union_plain(EDGE, a, b, capacity, out)


def edge_union(a, b, capacity: int | None = None, out=None):
    """Union of edge slot sets ``a`` ``[..., Ca]`` and ``b`` ``[..., Cb]``
    by (src, dst), per row (the EDGE instantiation of csrc/slot_union.cu;
    replaces the edge union of janus_tpu/models/graph.py ``merge``): a
    duplicate edge ORs its tombstones, the kept edges are cut to the
    ``capacity`` smallest, invalid slots are filled canonically. Arguments
    and result as for ``tp_union``. Bound on the H100 by bytes: 10 a slot,
    each read and written once."""
    return union(EDGE, edge_union, a, b, capacity, out)


edge_union.launches = 0


def edge_union_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                          scatter: bool = False):
    """Plain PyTorch version of ``edge_union_rows``."""
    return union_rows_plain(EDGE, a, b, out, rows, n_rows, gather, scatter)


def edge_union_rows(a, b, out, rows, n_rows, gather: bool = True,
                    scatter: bool = False):
    """One level of the converge's halving tree over listed key rows of
    edge slot sets, as ``tp_union_rows`` does for the TP layout. Returns
    ``out``."""
    return union_rows(EDGE, edge_union_rows, a, b, out, rows, n_rows, gather,
                      scatter)


edge_union_rows.launches = 0

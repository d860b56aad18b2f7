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

The source takes the slot layout and its duplicate fold as a template
parameter; ``Layout`` is its Python side, and ``union`` / ``union_rows``
the launch of either layout (``kernels.rga_union`` is the RGA's).
``join_tree`` / ``join_tree_rows`` run the converge's halving tree of
either layout through the wrapper a model passes.

The wrappers launch the CUDA kernel for CUDA tensors (or raise) and run
their plain versions only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple

import torch

from janus_tpu_torch.kernels import build, operands, orset_rows
from janus_tpu_torch.ops.setops import slot_union as _generic_union


class Layout(NamedTuple):
    """A slot layout of ``csrc/slot_union.cu``: its fields in the C entry
    points' order (two int32 keys, int32 payloads, a bool flag, valid),
    their dtypes, the duplicate fold of the plain version, the count of
    int32 payload fields and the two C entry points."""
    fields: tuple
    dtypes: dict
    fold: Callable
    payloads: int
    launch: str
    rows_launch: str

    @property
    def key_fields(self):
        return self.fields[:2]

    def operands(self, prefix, slots, shape):
        """``operands.placement`` entries for the fields of a slot set."""
        return [(f"{prefix}{f}", slots[f], self.dtypes[f], shape)
                for f in self.fields]


ORSET = Layout(orset_rows.FIELDS, orset_rows.DTYPES,
               orset_rows.fold_duplicate, 1, "slot_union_launch",
               "slot_union_rows_launch")


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
        for name in ("slot_union_launch", "rga_union_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [arr, arr, arr, ptr, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        for name in ("slot_union_rows_launch", "rga_union_rows_launch"):
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
    """Shared memory of one block (csrc/slot_union.cu): per input record
    a 16-byte sort record, 4 bytes per int32 payload field and 4 of prefix
    sum (24 for the OR-Set, 32 for the RGA), and the prefix sum's 4 KB."""
    per = 16 + 4 * (layout.payloads + 1)
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


_SCRATCH: Dict[tuple, dict] = {}


def tree_scratch(layout: Layout, state, half: int) -> dict:
    """The ``[half, K, C]`` scratch of one level of the converge's halving
    tree for this layout, geometry and device, made at the first call. A
    level reads its input scratch before it writes its output, and the
    levels of one tree have distinct sizes, so calls on one stream may
    share it (the full and the row-list tree included)."""
    K, C = state["valid"].shape[-2:]
    dev = state["valid"].device
    key = (dev, half, K, C, layout.fields)
    if key not in _SCRATCH:
        _SCRATCH[key] = {f: torch.empty((half, K, C), dtype=layout.dtypes[f],
                                        device=dev) for f in layout.fields}
    return _SCRATCH[key]


def join_tree(layout: Layout, union_fn, state) -> None:
    """Set every row of the leading replica axis of ``state``'s slot
    fields to the join of all rows, in place: the halving tree of
    janus_tpu/runtime/store.py ``join_all`` (the middle row joins both
    halves when the count is odd), one ``union_fn`` launch per level into
    ``tree_scratch``, the last level writing its row into all R rows.
    ``union_fn`` is the layout's wrapper (``slot_union``, ``rga_union``)."""
    cap = state["valid"].shape[-1]
    cur = {f: state[f] for f in layout.fields}
    n = state["valid"].shape[0]
    while n > 2:
        half = (n + 1) // 2
        nxt = tree_scratch(layout, state, half)
        union_fn({f: x[:half] for f, x in cur.items()},
                 {f: x[n - half:n] for f, x in cur.items()}, cap,
                 out={f: x.unsqueeze(0) for f, x in nxt.items()})
        cur, n = nxt, half
    if n == 2:
        union_fn({f: x[:1] for f, x in cur.items()},
                 {f: x[1:2] for f, x in cur.items()}, cap,
                 out={f: state[f].unsqueeze(1) for f in layout.fields})


def join_tree_rows(layout: Layout, union_rows_fn, state, rows,
                   n_rows) -> None:
    """``join_tree`` over key rows ``rows[:n_rows]`` only, in place, one
    ``union_rows_fn`` launch per level (the layout's row-list wrapper):
    level 1 reads the listed rows from the state, the middle levels work
    in ``tree_scratch`` (only the listed rows of it are written and read),
    and the last writes each joined row into all R replicas at its key.
    Leaves outside the layout are never indexed."""
    cur = {f: state[f] for f in layout.fields}
    listed = True
    n = state["valid"].shape[0]
    while n > 2:
        half = (n + 1) // 2
        nxt = tree_scratch(layout, state, half)
        union_rows_fn({f: x[:half] for f, x in cur.items()},
                      {f: x[n - half:n] for f, x in cur.items()},
                      nxt, rows, n_rows, gather=listed)
        cur, listed, n = nxt, False, half
    if n == 2:
        union_rows_fn({f: x[:1] for f, x in cur.items()},
                      {f: x[1:2] for f, x in cur.items()},
                      {f: state[f] for f in layout.fields}, rows, n_rows,
                      gather=listed, scatter=True)


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

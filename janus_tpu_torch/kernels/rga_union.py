"""``rga_union``: the sorted union of two RGA slot sets per row, the RGA
instantiation of csrc/slot_union.cu.

Replaces janus_tpu/ops/setops.py ``slot_union`` with the RGA's fold
(janus_tpu/models/rga.py ``_combine``): rows are united by element id
``(id_ctr, id_rep)``, sorted lexicographically in that order as signed
int32 (invalid slots keyed SENTINEL); a kept record folds with the record
right after it when that one repeats its id: ``par_ctr``, ``par_rep`` and
``chr`` take the fieldwise max, ``dead`` the OR. The kept ids are cut to
the ``capacity`` smallest and invalid slots filled canonically. Bound on
the H100 by bytes (22 per slot, each read and written once); see the
source note. The kernel merges the two rows (each already sorted by id
when it comes from a union, a compaction or an apply; a row that is not
is sorted alone first) instead of sorting their concatenation: the
source's ``merge_row``.

``rga_union_rows`` is the kernel's row-list mode, one level of the
converge's halving tree over listed document rows
(``models.rga.join_replica_rows``).

The wrappers launch the CUDA kernel for CUDA tensors (or raise) and run
their plain versions (``ops.setops.slot_union`` with the fold) only for
tensors that lie on the CPU.
"""
from __future__ import annotations

from janus_tpu_torch.kernels import rga_rows
from janus_tpu_torch.kernels.slot_union import (
    Layout, union, union_plain, union_rows, union_rows_plain)

RGA = Layout(rga_rows.FIELDS, rga_rows.DTYPES, rga_rows.fold_duplicate, 3,
             "rga_union_launch", "rga_union_rows_launch")


def rga_union_plain(a, b, capacity: int | None = None, out=None):
    """Plain PyTorch version of ``rga_union``."""
    return union_plain(RGA, a, b, capacity, out)


def rga_union(a, b, capacity: int | None = None, out=None):
    """Union of RGA slot sets ``a`` ``[..., Ca]`` and ``b`` ``[..., Cb]``
    (the seven fields of ``rga_rows.FIELDS``) by element id, per row.
    Returns ``(out, overflow int32[...])``, the kept ids that did not fit
    counted in ``overflow``; ``out`` is fresh tensors ``[..., capacity]``,
    or written into ``out`` (``[P, ..., capacity]``, every one of its P
    rows; it may alias ``a`` or ``b``)."""
    return union(RGA, rga_union, a, b, capacity, out)


rga_union.launches = 0


def rga_union_rows_plain(a, b, out, rows, n_rows, gather: bool = True,
                         scatter: bool = False):
    """Plain PyTorch version of ``rga_union_rows``."""
    return union_rows_plain(RGA, a, b, out, rows, n_rows, gather, scatter)


def rga_union_rows(a, b, out, rows, n_rows, gather: bool = True,
                   scatter: bool = False):
    """One level of the converge's halving tree over listed document rows
    ``rows[:n_rows]`` (``n_rows`` int32[] on the device, read there), as
    ``kernels.slot_union_rows`` does for the OR-Set: ``a``, ``b``
    ``[P, K, C]`` RGA slot sets, ``out`` ``[P, K, C]`` scratch or, with
    ``scatter`` (one pair), the ``[R, K, C]`` state. Returns ``out``."""
    return union_rows(RGA, rga_union_rows, a, b, out, rows, n_rows, gather,
                      scatter)


rga_union_rows.launches = 0

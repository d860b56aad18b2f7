"""The RGA slot layout shared by its hand kernels' plain versions
(``rga_union``, ``rga_apply``, ``rga_compact``, ``rga_order``).

Per document a row of C slots, one element each: ``id_ctr``/``id_rep``
(the element id, int32 keys: Lamport counter, writer replica),
``par_ctr``/``par_rep`` (the id of the element it was inserted after; the
root is (0, 0)), ``chr`` (int32 payload), ``dead`` (bool tombstone) and
``valid`` (bool). A canonical row is sorted by id with invalid slots last,
holding SENTINEL keys and zero payloads (counterpart:
janus_tpu/models/rga.py ``_combine``).
"""
from __future__ import annotations

from typing import Dict

import torch

OP_INSERT = 1   # a0=chr, (a1, a2)=(parent_rep, parent_ctr), writer=replica
OP_DELETE = 2   # (a1, a2)=(target_rep, target_ctr)

KEY_FIELDS = ("id_ctr", "id_rep")
# every per-slot field, in the order the C entry points take them
FIELDS = ("id_ctr", "id_rep", "par_ctr", "par_rep", "chr", "dead", "valid")
DTYPES = {f: torch.bool if f in ("dead", "valid") else torch.int32
          for f in FIELDS}
# the op fields the apply reads, in the C entry point's order
OP_FIELDS = ("op", "key", "a0", "a1", "a2", "writer")

Row = Dict[str, torch.Tensor]


def fold_duplicate(p: Row, q: Row) -> Row:
    """Duplicate id fold: the tombstone is sticky; the tree edge and the
    payload are id-determined, and a tombstone-only record (a delete seen
    before its insert) carries zeros, so the fieldwise max recovers the
    real values."""
    return {"par_ctr": torch.maximum(p["par_ctr"], q["par_ctr"]),
            "par_rep": torch.maximum(p["par_rep"], q["par_rep"]),
            "chr": torch.maximum(p["chr"], q["chr"]),
            "dead": p["dead"] | q["dead"]}


def slot_operands(prefix: str, slots: Row, shape, fields=FIELDS):
    """``operands.placement`` entries for the fields of an RGA slot set."""
    return [(f"{prefix}{f}", slots[f], DTYPES[f], shape) for f in fields]

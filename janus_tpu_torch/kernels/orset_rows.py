"""The OR-Set slot layout shared by its four hand kernels' plain versions
(``slot_union``, ``orset_capture``, ``orset_replay``, ``orset_apply``).

Per key a row of C slots: ``tag_rep``/``tag_ctr`` (the tag, int32 keys),
``elem`` (int32), ``removed`` (bool tombstone) and ``valid`` (bool). A
canonical row is sorted by tag with invalid slots last, holding SENTINEL
keys and zero payloads (counterpart: janus_tpu/models/orset.py
``_canonical_row`` and ``_combine``).
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order

OP_ADD = 1     # reference opId 1 = Add
OP_REMOVE = 2
OP_CLEAR = 3

KEY_FIELDS = ("tag_rep", "tag_ctr")
# every per-slot field, in the order the C entry points take them
FIELDS = ("tag_rep", "tag_ctr", "elem", "removed", "valid")
DTYPES = {"tag_rep": torch.int32, "tag_ctr": torch.int32,
          "elem": torch.int32, "removed": torch.bool, "valid": torch.bool}
# the captured fields of a remove/clear op, each [..., B, r_cap]
CAPTURE_FIELDS = ("rm_rep", "rm_ctr", "rm_elem")

Row = Dict[str, torch.Tensor]


def fold_duplicate(p: Row, q: Row) -> Row:
    """Duplicate tag fold: the tombstone is sticky, elem is the first
    copy's (a tag determines its element)."""
    return {"removed": p["removed"] | q["removed"], "elem": p["elem"]}


def canonical_row(row: Row) -> Row:
    """Sort ``[..., C]`` rows by tag, stably, with invalid slots holding
    SENTINEL keys and zero payloads: set-equal rows become bit-equal."""
    valid = row["valid"]
    rep = torch.where(valid, row["tag_rep"], SENTINEL)
    ctr = torch.where(valid, row["tag_ctr"], SENTINEL)
    order = lex_order([rep, ctr])
    return {"tag_rep": rep.gather(-1, order), "tag_ctr": ctr.gather(-1, order),
            "valid": valid.gather(-1, order),
            "elem": torch.where(valid, row["elem"], 0).gather(-1, order),
            "removed": (row["removed"] & valid).gather(-1, order)}


def slot_operands(prefix: str, slots: Row, shape):
    """``operands.placement`` entries for the five fields of a slot set."""
    return [(f"{prefix}{f}", slots[f], DTYPES[f], shape) for f in FIELDS]


def op_operands(ops, shape, fields=("op", "key", "a0", "a1", "a2")):
    """``operands.placement`` entries for int32 op fields."""
    return [(f"op field {f!r}", ops[f], torch.int32, shape) for f in fields]

"""The LWW-Set slot layout shared by its hand kernels' plain versions
(``lww_union``, ``lww_apply``, ``lww_capture``).

Per key a row of C slots, one element each: ``elem`` (the int32 key),
the add stamp ``add_hi``/``add_lo`` and the remove stamp ``rm_hi``/
``rm_lo`` (64-bit timestamps as int32 (hi, lo) pairs, the low word
unsigned; (0, 0) is "never stamped") and ``valid`` (bool). A canonical
row is sorted by elem with invalid slots last, holding SENTINEL keys and
zero payloads (counterpart: janus_tpu/models/lwwset.py ``_combine`` and
``_slot_live``).
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch.ops.lattice import SENTINEL, ts_after, ts_max

OP_ADD = 1      # a0=elem, (a1, a2)=(ts_hi, ts_lo)
OP_REMOVE = 2   # the same arguments

KEY_FIELDS = ("elem",)
PAYLOADS = ("add_hi", "add_lo", "rm_hi", "rm_lo")
# every per-slot field, in the order the C entry points take them
FIELDS = ("elem",) + PAYLOADS + ("valid",)
DTYPES = {f: torch.bool if f == "valid" else torch.int32 for f in FIELDS}
# the op fields the apply reads, in the C entry point's order
OP_FIELDS = ("op", "key", "a0", "a1", "a2")

Row = Dict[str, torch.Tensor]


def fold_duplicate(p: Row, q: Row) -> Row:
    """Duplicate elem fold: per polarity the lexicographic timestamp max
    (the first operand's on a tie)."""
    add_hi, add_lo = ts_max(p["add_hi"], p["add_lo"], q["add_hi"], q["add_lo"])
    rm_hi, rm_lo = ts_max(p["rm_hi"], p["rm_lo"], q["rm_hi"], q["rm_lo"])
    return {"add_hi": add_hi, "add_lo": add_lo, "rm_hi": rm_hi, "rm_lo": rm_lo}


def slot_live(valid, add_hi, add_lo, rm_hi, rm_lo):
    """Contained: has an add stamp and add >= remove (add wins ties)."""
    has_add = (add_hi != 0) | (add_lo != 0)
    return valid & has_add & ts_after(add_hi, add_lo, rm_hi, rm_lo)


def canonical_row(row: Row) -> Row:
    """Sort ``[..., C]`` rows by elem, stably, with invalid slots holding
    SENTINEL keys and zero payloads: rows that hold the same elements in
    other slots become bit-equal (a row that only an apply wrote keeps its
    slots in apply order)."""
    valid = row["valid"]
    elem = torch.where(valid, row["elem"], SENTINEL)
    order = torch.sort(elem, dim=-1, stable=True).indices
    out = {"elem": elem.gather(-1, order), "valid": valid.gather(-1, order)}
    for f in PAYLOADS:
        out[f] = torch.where(valid, row[f], 0).gather(-1, order)
    return out


def slot_operands(prefix: str, slots: Row, shape, fields=FIELDS):
    """``operands.placement`` entries for the fields of an LWW slot set."""
    return [(f"{prefix}{f}", slots[f], DTYPES[f], shape) for f in fields]

"""The two tombstone slot layouts of the 2P-Set and the 2P2P Graph, shared
by their hand kernels' plain versions (``tp_union``, ``edge_union``,
``tpset_apply``, ``graph_apply``, ``edge_mask``).

``TP``: per key a row of C slots, one element each: ``elem`` (the int32
key), ``removed`` (bool, the sticky tombstone) and ``valid`` (bool). The
2P-Set's state is this layout; the Graph's vertex block is too, under its
own leaf names (``v``, ``v_removed``, ``v_valid``). ``EDGE``: two int32
keys ``src`` and ``dst``, ``removed`` and ``valid``: the Graph's edge block
(leaves ``src``, ``dst``, ``e_removed``, ``e_valid``). Neither has an int32
payload; a duplicate key folds its tombstones by OR. A canonical row is
sorted by its keys with invalid slots last, holding SENTINEL keys and a
false tombstone (counterpart: janus_tpu/models/tpset.py ``_combine``,
janus_tpu/models/graph.py ``merge``).
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order

# every per-slot field of each layout, in the order the C entry points
# take them
TP_FIELDS = ("elem", "removed", "valid")
EDGE_FIELDS = ("src", "dst", "removed", "valid")
DTYPES = {"elem": torch.int32, "src": torch.int32, "dst": torch.int32,
          "removed": torch.bool, "valid": torch.bool}
# the Graph's leaves of each block, in the layout's field order
VERTEX_LEAVES = ("v", "v_removed", "v_valid")
EDGE_LEAVES = ("src", "dst", "e_removed", "e_valid")
GRAPH_FIELDS = VERTEX_LEAVES + EDGE_LEAVES
GRAPH_DTYPES = {leaf: DTYPES[f] for leaf, f in
                zip(GRAPH_FIELDS, TP_FIELDS + EDGE_FIELDS)}

Row = Dict[str, torch.Tensor]


def fold_duplicate(p: Row, q: Row) -> Row:
    """Duplicate key fold: the tombstone is sticky (the remove-set
    union)."""
    return {"removed": p["removed"] | q["removed"]}


def canonical_row(row: Row, keys=("elem",)) -> Row:
    """Sort ``[..., C]`` rows by ``keys`` (``("elem",)`` for the TP layout,
    ``("src", "dst")`` for edges), stably, with invalid slots holding
    SENTINEL keys and a false tombstone: rows that hold the same records in
    other slots become bit-equal (a row that only an apply wrote keeps its
    slots in apply order)."""
    valid = row["valid"]
    ks = [torch.where(valid, row[f], SENTINEL) for f in keys]
    order = lex_order(ks)
    out = {f: k.gather(-1, order) for f, k in zip(keys, ks)}
    out["removed"] = (row["removed"] & valid).gather(-1, order)
    out["valid"] = valid.gather(-1, order)
    return out


def vertex_view(state: Row) -> Row:
    """The Graph's vertex block under the TP layout's field names: the
    same tensors (views sharing storage), not copies."""
    return dict(zip(TP_FIELDS, (state[f] for f in VERTEX_LEAVES)))


def edge_view(state: Row) -> Row:
    """The Graph's edge block under the EDGE layout's field names, sharing
    storage."""
    return dict(zip(EDGE_FIELDS, (state[f] for f in EDGE_LEAVES)))


def graph_of(vertices: Row, edges: Row) -> Row:
    """The Graph's leaves of a vertex block and an edge block given under
    the layouts' field names (the inverse of the two views)."""
    return {**{leaf: vertices[f] for leaf, f in zip(VERTEX_LEAVES, TP_FIELDS)},
            **{leaf: edges[f] for leaf, f in zip(EDGE_LEAVES, EDGE_FIELDS)}}


def slot_operands(prefix: str, slots: Row, shape, fields=TP_FIELDS):
    """``operands.placement`` entries for the fields of a slot set."""
    return [(f"{prefix}{f}", slots[f], DTYPES[f], shape) for f in fields]

"""Last-Writer-Wins element set over per-element timestamp slots
(counterpart: janus_tpu/models/lwwset.py).

Per key a row of C slots, one element each: ``elem`` (interned element
id), the add stamp ``add_hi``/``add_lo`` and the remove stamp ``rm_hi``/
``rm_lo`` (64-bit timestamps as int32 (hi, lo) pairs in lexicographic
order, the low word unsigned: ``ops.lattice.ts_after``); ``valid`` marks
used slots. "Never stamped" is (0, 0), below every real stamp and the
canonical zero fill of an invalid slot. An element is contained iff it has
an add stamp and add >= remove (add wins ties). The join is the sorted
slot union with the per-polarity timestamp max.

The device work runs through hand kernels (``janus_tpu_torch.kernels``):

- ``lww_apply``    the sequential apply of adds and removes, in place:
                   uncaptured (a remove stamps only a contained element)
                   and captured (gated on the op's ``ok``)
- ``lww_capture``  its capture mode: the origin's sequential capture and
                   apply at submit (``capture_apply``), each remove's
                   ``ok`` taken against the earlier lanes' state
- ``lww_union``    the join (``merge``) and the replica-axis converge
                   (``join_replicas``; its row-list mode ``lww_union_rows``
                   for ``join_replica_rows``)

Every function batches over leading axes of the state (``[..., K, C]``
with op fields ``[..., B]``). A row that only an apply wrote keeps its
elements in apply order (the apply fills the first free slot); a merge
makes it canonical (sorted by elem, ``kernels.lww_rows.canonical_row``).
``prepare_ops`` is plain PyTorch: ``models.base.capture_scan`` runs it op
by op, the plain version of ``capture_apply``.
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.lww_rows import (  # noqa: F401
    FIELDS, KEY_FIELDS, OP_ADD, OP_FIELDS, OP_REMOVE, canonical_row,
    slot_live)
from janus_tpu_torch.kernels.replica_tree import join_tree, join_tree_rows
from janus_tpu_torch.kernels.slot_union import LWW
from janus_tpu_torch.models import base
from janus_tpu_torch.models.base import flat_views, gather_index, key_rows
from janus_tpu_torch.ops.setops import make_slots

State = Dict[str, torch.Tensor]  # fields [..., K, C]


def init(num_keys: int, capacity: int, device=None) -> State:
    """Empty state of ``num_keys`` rows of ``capacity`` slots."""
    return make_slots(capacity,
                      {"elem": torch.int32, "add_hi": torch.int32,
                       "add_lo": torch.int32, "rm_hi": torch.int32,
                       "rm_lo": torch.int32},
                      batch=(num_keys,), key_fields=KEY_FIELDS,
                      device=resolve_device(device))


def apply_ops_dropped(state: State, ops: base.OpBatch):
    """Apply add/remove ops in lane order (the ``lww_apply`` kernel), in
    place. Returns ``(state, dropped int32[...])``: the slot records each
    replica dropped into full rows."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    keep = OP_FIELDS + (("ok",) if "ok" in fops else ())
    dropped = kernels.lww_apply(flat, {f: fops[f] for f in keep})
    return state, dropped.reshape(lead)


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """add: a0=elem, (a1, a2)=(ts_hi, ts_lo): upsert the add stamp (max
    fold). remove: the same arguments: with a captured ``ok`` ([..., B,
    1]) the stamp applies where ``ok`` is set; without, only where the
    element is contained locally. In place; returns the state."""
    return apply_ops_dropped(state, ops)[0]


def prepare_ops(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Effect capture of op batches ``[..., B]`` against states ``[..., K,
    C]``, each against the state as given: a remove records whether its
    element is contained (``ok`` ``[..., B, 1]``), every other op 1. Plain
    PyTorch; ``base.capture_scan`` calls it op by op."""
    K, C = state["valid"].shape[-2:]
    k = gather_index(ops["key"], K)                            # [..., B]
    rows = k[..., None].expand(k.shape + (C,))

    def row(f):
        return state[f].gather(-2, rows)                       # [..., B, C]

    hit = row("valid") & (row("elem") == ops["a0"][..., None])
    contained = slot_live(hit, row("add_hi"), row("add_lo"), row("rm_hi"),
                          row("rm_lo")).any(-1)
    ok = torch.where(ops["op"] == OP_REMOVE, contained, True)
    return {**ops, "ok": ok[..., None].to(torch.int32)}


def capture_apply(state: State, ops: base.OpBatch):
    """The sequential capture and apply of uncaptured op batches (the
    ``lww_capture`` kernel), in place: lane by lane, each remove's ``ok``
    is its element's containment in the state the earlier lanes left,
    and the op applies. Returns ``(state, prepared)``, the ops with
    ``ok`` ``[..., B, 1]``."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    ok, _ = kernels.lww_capture(flat, {f: fops[f] for f in OP_FIELDS})
    return state, {**ops, "ok": ok.view(lead + (ops["op"].shape[-1], 1))}


def merge(a: State, b: State) -> State:
    out, _ = merge_with_stats(a, b)
    return out


def merge_with_stats(a: State, b: State):
    """Join = per-key union of element slots with the per-polarity stamp
    max (the ``lww_union`` kernel). Returns ``(state, overflow int32[...,
    K])``, the elements dropped by capacity."""
    return kernels.lww_union(a, b, a["elem"].shape[-1])


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place: ``kernels.replica_tree.join_tree``, the halving tree of
    ``runtime.store.join_all`` with one ``lww_union`` launch per level,
    the last level writing its row into all R rows."""
    join_tree(LWW.fields, kernels.lww_union, state)
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over key rows ``rows[:n_rows]`` only, in place:
    ``kernels.replica_tree.join_tree_rows``, one ``lww_union_rows`` launch
    per level."""
    join_tree_rows(LWW.fields, kernels.lww_union_rows, state, rows, n_rows)
    return state


def contains(state: State, key, elem) -> torch.Tensor:
    """Presence of ``elem`` at ``key`` (gathered on the key axis by JAX's
    gather rule)."""
    hit = key_rows(state["valid"], key) & (
        key_rows(state["elem"], key)
        == torch.as_tensor(elem, device=state["elem"].device))
    return slot_live(hit, *(key_rows(state[f], key) for f in
                            ("add_hi", "add_lo", "rm_hi", "rm_lo"))).any(-1)


def lookup_mask(state: State) -> torch.Tensor:
    """[..., K, C] mask of contained slots (one slot per element)."""
    return slot_live(state["valid"], state["add_hi"], state["add_lo"],
                     state["rm_hi"], state["rm_lo"])


def live_count(state: State) -> torch.Tensor:
    """Contained elements per key."""
    return lookup_mask(state).sum(-1).to(torch.int32)


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="LWWSet",
        type_code="lww",
        init=init,
        apply_ops=apply_ops,
        merge=merge,
        queries={"contains": contains, "live_count": live_count},
        op_codes={"a": OP_ADD, "r": OP_REMOVE},
        op_extras={"ok": 1},
        prepare_ops=prepare_ops,
        capture_apply=capture_apply,
        apply_ops_dropped=apply_ops_dropped,
        join_replicas=join_replicas,
        join_replica_rows=join_replica_rows,
    )
)

apply_ops_delta = SPEC.apply_ops_delta

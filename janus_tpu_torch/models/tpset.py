"""Two-Phase Set (2P-Set) over element slots with sticky tombstones
(counterpart: janus_tpu/models/tpset.py).

Per key a row of C slots, one element each: ``elem`` (interned element
id), ``removed`` (the tombstone: "in the remove set") and ``valid``. A
removal is permanent: a tombstone is never cleared and a removed element
is never added back. An element is contained iff it has a valid slot with
no tombstone. The join is the sorted slot union with the tombstone OR.

The device work runs through hand kernels (``janus_tpu_torch.kernels``):

- ``tpset_apply``    the sequential apply of adds and removes, in place
                     (csrc/graph_apply.cu's walk with no edge block):
                     uncaptured (a remove tombstones only a present
                     element) and captured (a remove upserts a sticky
                     tombstone where the op's ``ok`` is set)
- ``tpset_capture``  its capture mode: the origin's sequential capture and
                     apply at submit (``capture_apply``), each remove's
                     ``ok`` taken against the earlier lanes' state
- ``tp_union``       the join (``merge``) and the replica-axis converge
                     (``join_replicas``; its row-list mode
                     ``tp_union_rows`` for ``join_replica_rows``)

Every function batches over leading axes of the state (``[..., K, C]``
with op fields ``[..., B]``). A row that only an apply wrote keeps its
elements in apply order (the apply fills the first free slot); a merge
makes it canonical (sorted by elem, ``kernels.tp_rows.canonical_row``).
``prepare_ops`` is plain PyTorch: ``models.base.capture_scan`` runs it op
by op, the plain version of ``capture_apply``.
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.replica_tree import join_tree, join_tree_rows
from janus_tpu_torch.kernels.slot_union import TP
from janus_tpu_torch.kernels.tp_rows import TP_FIELDS as FIELDS
from janus_tpu_torch.kernels.graph_apply import (  # noqa: F401
    OP_ADD, OP_REMOVE, TP_OP_FIELDS as OP_FIELDS)
from janus_tpu_torch.models import base
from janus_tpu_torch.models.base import flat_views, gather_index, key_rows
from janus_tpu_torch.ops.setops import make_slots

KEY_FIELDS = ("elem",)
State = Dict[str, torch.Tensor]  # fields [..., K, C]


def init(num_keys: int, capacity: int, device=None) -> State:
    """Empty state of ``num_keys`` rows of ``capacity`` slots."""
    return make_slots(capacity, {"elem": torch.int32, "removed": torch.bool},
                      batch=(num_keys,), key_fields=KEY_FIELDS,
                      device=resolve_device(device))


def apply_ops_dropped(state: State, ops: base.OpBatch):
    """Apply add/remove ops in lane order (the ``tpset_apply`` kernel), in
    place. Returns ``(state, dropped int32[...])``: the slot records each
    replica dropped into full rows."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    keep = OP_FIELDS + (("ok",) if "ok" in fops else ())
    dropped = kernels.tpset_apply(flat, {f: fops[f] for f in keep})
    return state, dropped.reshape(lead)


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """add: a0=elem, inserted if absent (an elem present keeps its
    tombstone: no re-add). remove: a0=elem; with a captured ``ok``
    ([..., B, 1]) a sticky tombstone is upserted where ``ok`` is set
    (inserted if absent, so a late add cannot bring it back); without, the
    elem is tombstoned only where it is present. In place; returns the
    state."""
    return apply_ops_dropped(state, ops)[0]


def prepare_ops(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Effect capture of op batches ``[..., B]`` against states ``[..., K,
    C]``, each against the state as given: a remove records whether its
    element is present (``ok`` ``[..., B, 1]``), every other op 1. Plain
    PyTorch; ``base.capture_scan`` calls it op by op."""
    K, C = state["valid"].shape[-2:]
    k = gather_index(ops["key"], K)                            # [..., B]
    rows = k[..., None].expand(k.shape + (C,))

    def row(f):
        return state[f].gather(-2, rows)                       # [..., B, C]

    hit = row("valid") & (row("elem") == ops["a0"][..., None])
    present = (hit & ~row("removed")).any(-1)
    ok = torch.where(ops["op"] == OP_REMOVE, present, True)
    return {**ops, "ok": ok[..., None].to(torch.int32)}


def capture_apply(state: State, ops: base.OpBatch):
    """The sequential capture and apply of uncaptured op batches (the
    ``tpset_capture`` kernel), in place: lane by lane, each remove's
    ``ok`` is its element's presence in the state the earlier lanes left,
    and the op applies captured. Returns ``(state, prepared)``, the ops
    with ``ok`` ``[..., B, 1]``."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    ok, _ = kernels.tpset_capture(flat, {f: fops[f] for f in OP_FIELDS})
    return state, {**ops, "ok": ok.view(lead + (ops["op"].shape[-1], 1))}


def merge(a: State, b: State) -> State:
    out, _ = merge_with_stats(a, b)
    return out


def merge_with_stats(a: State, b: State):
    """Join = per-key union of element slots with the tombstone OR (the
    ``tp_union`` kernel). Returns ``(state, overflow int32[..., K])``, the
    elements dropped by capacity."""
    return kernels.tp_union(a, b, a["elem"].shape[-1])


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place: ``kernels.replica_tree.join_tree``, one ``tp_union`` launch
    per level, the last level writing its row into all R rows."""
    join_tree(TP.fields, kernels.tp_union, state)
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over key rows ``rows[:n_rows]`` only, in place:
    ``kernels.replica_tree.join_tree_rows``, one ``tp_union_rows`` launch
    per level."""
    join_tree_rows(TP.fields, kernels.tp_union_rows, state, rows, n_rows)
    return state


def lookup_mask(state: State) -> torch.Tensor:
    """[..., K, C] mask of contained slots (add-set minus remove-set)."""
    return state["valid"] & ~state["removed"]


def contains(state: State, key, elem) -> torch.Tensor:
    """Presence of ``elem`` at ``key``."""
    hit = key_rows(lookup_mask(state), key) & (
        key_rows(state["elem"], key)
        == torch.as_tensor(elem, device=state["elem"].device))
    return hit.any(-1)


def live_count(state: State) -> torch.Tensor:
    """Contained elements per key."""
    return lookup_mask(state).sum(-1).to(torch.int32)


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="TPSet",
        type_code="tpset",
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

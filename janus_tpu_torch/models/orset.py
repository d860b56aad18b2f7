"""Observed-Remove Set over fixed-capacity tag-slot tensors
(counterpart: janus_tpu/models/orset.py).

Per key a block of C slots, each slot one tag: ``tag_rep``/``tag_ctr``
(minting replica x per-replica counter), ``elem`` (interned element id)
and a ``removed`` tombstone bit; ``valid`` marks used slots. An element is
present iff some valid slot of it is not tombstoned. Rows stay canonical
(sorted by tag, invalid slots last with SENTINEL keys and zero payloads),
so set-equal states are bit-equal tensors. ``_rm_cap``, a zero-width
``[r_cap, 0]`` int32 leaf, carries the capture width of remove/clear ops.

The device work runs through five hand kernels (``janus_tpu_torch.kernels``):

- ``orset_capture``  batched effect capture at submit (``prepare_ops_batch``)
- ``orset_replay``   captured batches of two lanes or more: the consensus
                     path's apply
- ``orset_apply``    the sequential per-op apply, in place: uncaptured
                     batches, and captured batches of one lane (JAX's scan)
- ``slot_union``     the join (``merge``) and the replica-axis converge
                     (``join_replicas``; its row-list mode
                     ``slot_union_rows`` for ``join_replica_rows``)
- ``orset_compact``  the compaction (``compact``) and, through its
                     ``orset_compact_fences`` entry point (the counter
                     watermark and every state's compaction in one call),
                     the GC-fence compaction (``compact_fence(s)``), in
                     place

The dirty rows of a delta apply are the ``dirty_rows`` kernel.

Every function batches over leading axes of the state (``[..., K, C]``
with op fields ``[..., B]``). The duplicate-tag fold (JAX's ``_combine``)
and the canonical row order (``_canonical_row``) are
``kernels.orset_rows.fold_duplicate`` and ``canonical_row``, which the
kernels' plain versions share. The single-op capture ``prepare_ops`` is
plain PyTorch (``base.capture_scan`` runs it); ``capture_and_apply`` takes
the batched capture.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.orset_rows import (  # noqa: F401
    CAPTURE_FIELDS, FIELDS, KEY_FIELDS, OP_ADD, OP_CLEAR, OP_REMOVE)
from janus_tpu_torch.kernels.replica_tree import join_tree, join_tree_rows
from janus_tpu_torch.kernels.slot_union import ORSET
from janus_tpu_torch.models import base
from janus_tpu_torch.models.base import gather_index, key_rows
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import make_slots

State = Dict[str, torch.Tensor]  # fields [..., K, C], plus "_rm_cap"


def init(num_keys: int, capacity: int, rm_capacity: int | None = None,
         device=None) -> State:
    """Empty state of ``num_keys`` rows of ``capacity`` slots.
    ``rm_capacity`` (default ``capacity``) bounds how many observed tags
    one remove/clear captures; a remove observing more tombstones the
    first ``rm_capacity`` in tag order."""
    dev = resolve_device(device)
    st = make_slots(capacity,
                    {"tag_rep": torch.int32, "tag_ctr": torch.int32,
                     "elem": torch.int32, "removed": torch.bool},
                    batch=(num_keys,), key_fields=KEY_FIELDS, device=dev)
    r = capacity if rm_capacity is None else int(rm_capacity)
    st["_rm_cap"] = torch.zeros((r, 0), dtype=torch.int32, device=dev)
    return st


def _views(state: State, ops: base.OpBatch):
    """The state's fields as ``[V, K, C]`` views (V = the leading axes,
    1 for none), the op fields as ``[V, B, ...]``, and the leading axes."""
    lead = tuple(state["valid"].shape[:-2])
    K, C = state["valid"].shape[-2:]
    v = math.prod(lead)
    flat = {f: state[f].view(v, K, C) for f in FIELDS}
    if tuple(ops["op"].shape[:-1]) != lead:
        raise ValueError(f"op batch shape {tuple(ops['op'].shape)} does not "
                         f"match state leading axes {lead}")
    B = ops["op"].shape[-1]
    fops = {f: x.reshape((v, B) + tuple(x.shape[len(lead) + 1:]))
            for f, x in ops.items()}
    return flat, fops, lead


def prepare_ops_batch(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Batched effect capture (the ``orset_capture`` kernel): a remove or
    clear at lane i records the tags it observes in the pre-batch state
    and in the adds of earlier lanes of its batch and key, so replicated
    replay tombstones exactly those tags whatever the delivery order.
    Adds ``rm_rep``/``rm_ctr``/``rm_elem`` (``[..., B, r_cap]``)."""
    flat, fops, lead = _views(state, ops)
    r_cap = state["_rm_cap"].shape[-2]
    B = ops["op"].shape[-1]
    cap = kernels.orset_capture(flat, fops, r_cap)
    return {**ops, **{f: x.reshape(lead + (B, r_cap))
                      for f, x in zip(CAPTURE_FIELDS, cap)}}


def prepare_ops(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Single-op effect capture against the state as given (counterpart:
    janus_tpu/models/orset.py ``prepare_ops``): a remove or clear records
    the valid tags it covers (elem-matched for remove, all for clear), in
    tag order, the first ``r_cap`` of them, SENTINEL tags and zero elems
    in unused lanes; other ops record none. Batches over leading axes
    (state ``[..., K, C]``, op fields ``[..., B]``; adds ``[..., B,
    min(r_cap, C)]``). Plain PyTorch."""
    K, C = state["valid"].shape[-2:]
    k = gather_index(ops["key"], K)
    rows = k[..., None].expand(k.shape + (C,))

    def row(f):
        return state[f].gather(-2, rows)                       # [..., B, C]

    is_rm = ops["op"] == OP_REMOVE
    is_tomb = is_rm | (ops["op"] == OP_CLEAR)
    sel = row("valid") & ((row("elem") == ops["a0"][..., None])
                          | ~is_rm[..., None]) & is_tomb[..., None]
    order = torch.sort((~sel).to(torch.int32), dim=-1, stable=True).indices
    r_cap = state["_rm_cap"].shape[-2]

    def pick(f, fill):  # at most r_cap wide: C when r_cap > C, as in JAX
        return torch.where(sel, row(f), fill).gather(-1, order)[..., :r_cap]

    return {**ops, "rm_rep": pick("tag_rep", SENTINEL),
            "rm_ctr": pick("tag_ctr", SENTINEL), "rm_elem": pick("elem", 0)}


def _apply_ops_impl(state: State, ops: base.OpBatch):
    """``(state, dropped[...])``: captured batches of more than one op
    replay as one set union per key (``orset_replay``, new tensors);
    uncaptured batches and captured ones of one op apply op by op
    (``orset_apply``, in place)."""
    flat, fops, lead = _views(state, ops)
    if "rm_rep" in ops and ops["op"].shape[-1] > 1:
        new, dropped = kernels.orset_replay(flat, fops)
        K, C = state["valid"].shape[-2:]
        out = {f: new[f].view(lead + (K, C)) for f in FIELDS}
        out["_rm_cap"] = state["_rm_cap"]
        return out, dropped.reshape(lead)
    dropped = kernels.orset_apply(flat, fops)
    return state, dropped.reshape(lead)


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """Apply add/remove/clear ops; returns the new state (the same dict,
    updated in place, for uncaptured ops).

    add:    a0=elem, a1=tag_rep, a2=tag_ctr (the host mints unique tags)
    remove: a0=elem. With captured ``rm_rep``/``rm_ctr``/``rm_elem`` the
            op inserts its captured tags as tombstoned slots (a tag not
            yet present lands dead, so a later add of it cannot
            resurrect it); without, it tombstones the matching tags
            present at apply time.
    clear:  the same over every observed tag."""
    return _apply_ops_impl(state, ops)[0]


def merge(a: State, b: State) -> State:
    out, _ = merge_with_stats(a, b)
    return out


def merge_with_stats(a: State, b: State):
    """Join = per-key union of tag slots (the ``slot_union`` kernel);
    returns ``(state, overflow int32[..., K])``."""
    cap = a["tag_rep"].shape[-1]
    out, overflow = kernels.slot_union(a, b, cap)
    out["_rm_cap"] = a["_rm_cap"]
    return out, overflow


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place: ``kernels.replica_tree.join_tree``, the halving tree of
    ``runtime.store.join_all`` with one ``slot_union`` launch per level,
    the last level writing its row into all R rows."""
    join_tree(ORSET.fields, kernels.slot_union, state)
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over key rows ``rows[:n_rows]`` only, in place:
    ``kernels.replica_tree.join_tree_rows``, one ``slot_union_rows`` launch
    per level. ``_rm_cap`` is carried through untouched (a zero-width
    leaf; nothing indexes it)."""
    join_tree_rows(ORSET.fields, kernels.slot_union_rows, state, rows, n_rows)
    return state


def contains(state: State, key, elem) -> torch.Tensor:
    """Presence of ``elem`` at ``key``: some observed add-tag of it is not
    tombstoned. The key is gathered on the key axis (``[..., K, C]``) by
    JAX's gather rule."""
    live = key_rows(state["valid"], key) & ~key_rows(state["removed"], key)
    hit = key_rows(state["elem"], key) == torch.as_tensor(elem,
                                                          device=live.device)
    return (live & hit).any(-1)


def lookup_mask(state: State) -> torch.Tensor:
    """[..., K, C] mask of live (add-surviving) slots."""
    return state["valid"] & ~state["removed"]


def live_count(state: State) -> torch.Tensor:
    """Live tags per key (an upper bound on the set's cardinality)."""
    return lookup_mask(state).sum(-1).to(torch.int32)


def element_count(state: State) -> torch.Tensor:
    """[..., K] occupied slots per key, tombstones included."""
    return state["valid"].sum(-1).to(torch.int32)


def _slots(state: State) -> State:
    return {f: state[f] for f in FIELDS}


def compact(state: State, protect: torch.Tensor | None = None) -> State:
    """Drop tombstoned slots to reclaim capacity (one stable compaction
    per row, the ``orset_compact`` kernel), keeping those ``protect``
    pins; in place, returns the state. Only safe at coordination points
    where every replica has observed the tombstones."""
    rows = _slots(state)
    kernels.orset_compact(rows, protect=protect, out=rows)
    return state


def compact_fences(states, live_ops: base.OpBatch):
    """GC-fence compaction of every state of the tuple ``states``, in
    place: reclaim tombstoned tags except those whose minting add may
    still ride the live window. Protection is a counter watermark: tags
    are minted with increasing counters, so a tag still ridable has ``ctr
    >=`` the least ``a2`` of the live adds (SENTINEL when none is live).
    One ``orset_compact_fences`` call computes it on the device and
    compacts every state behind it. Returns the states."""
    kernels.orset_compact_fences(tuple(_slots(st) for st in states),
                                 live_ops["op"], live_ops["a2"])
    return states


def compact_fence(state: State, live_ops: base.OpBatch) -> State:
    """``compact_fences`` of one state (batched over its leading axes), in
    place; returns it."""
    return compact_fences((state,), live_ops)[0]


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="ORSet",
        type_code="orset",
        init=init,
        apply_ops=apply_ops,
        merge=merge,
        queries={"contains": contains, "live_count": live_count,
                 "element_count": element_count},
        op_codes={"a": OP_ADD, "r": OP_REMOVE, "c": OP_CLEAR},
        op_extras={f: "rm_capacity" for f in CAPTURE_FIELDS},
        dim_defaults={"rm_capacity": "capacity"},
        prepare_ops=prepare_ops,
        prepare_ops_batch=prepare_ops_batch,
        apply_ops_dropped=_apply_ops_impl,
        compact_fences=compact_fences,
        join_replicas=join_replicas,
        join_replica_rows=join_replica_rows,
    )
)

apply_ops_delta = SPEC.apply_ops_delta

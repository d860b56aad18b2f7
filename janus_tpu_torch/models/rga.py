"""RGA (Replicated Growable Array) sequence CRDT over slot tensors
(counterpart: janus_tpu/models/rga.py).

Per document a row of C slots, one element each: its id ``id_ctr`` /
``id_rep`` (Lamport counter, writer replica), the id of the element it was
inserted after (``par_ctr`` / ``par_rep``; the root is (0, 0)), a payload
``chr`` and a ``dead`` tombstone bit; ``valid`` marks used slots. The
document is the depth-first walk of that tree with siblings by descending
id. Two leaves are not slots: ``_depth``, a zero-byte ``[max_depth, 0]``
int32 leaf whose shape carries how many ancestor levels the linearizer
resolves, and ``ctr_floor`` ``[K]``, the highest counter each document has
observed (it survives compaction, so a minted counter never repeats a
compacted element's).

The device work runs through hand kernels (``janus_tpu_torch.kernels``):

- ``rga_apply``   the sequential apply of inserts and deletes, in place
- ``rga_capture`` its capture mode: the origin's sequential capture and
                  apply at submit (``capture_apply``), minting each
                  insert's counter against the earlier lanes' state
- ``rga_union``   the join (``merge``) and the replica-axis converge
                  (``join_replicas``; its row-list mode ``rga_union_rows``
                  for ``join_replica_rows``), with ``replica_join`` /
                  ``replica_join_rows`` on ``ctr_floor``
- ``rga_compact`` the compaction of tombstoned leaves
- ``mark_members`` with ``rga_compact``: the GC-fence compaction
                  (``compact_fence``), which pins the ids and parents of
                  the live window's inserts
- ``rga_order``   the linearization behind ``text``

Every function batches over leading axes of the state (``[..., K, C]``,
``ctr_floor`` ``[..., K]``, with op fields ``[..., B]``). ``prepare_ops``
is plain PyTorch: ``models.base.capture_scan`` runs it op by op, the
plain version of ``capture_apply``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.rga_rows import (  # noqa: F401
    FIELDS, KEY_FIELDS, OP_DELETE, OP_INSERT)
from janus_tpu_torch.kernels.rga_union import RGA
from janus_tpu_torch.kernels.replica_tree import join_tree, join_tree_rows
from janus_tpu_torch.models import base
from janus_tpu_torch.models.base import gather_index
from janus_tpu_torch.ops.setops import make_slots

State = Dict[str, torch.Tensor]  # fields [..., K, C], _depth, ctr_floor


def init(num_keys: int, capacity: int, max_depth: int = 32,
         device=None) -> State:
    """Empty state of ``num_keys`` documents of ``capacity`` slots, read
    to ``max_depth`` ancestor levels."""
    dev = resolve_device(device)
    st = make_slots(capacity,
                    {"id_ctr": torch.int32, "id_rep": torch.int32,
                     "par_ctr": torch.int32, "par_rep": torch.int32,
                     "chr": torch.int32, "dead": torch.bool},
                    batch=(num_keys,), key_fields=KEY_FIELDS, device=dev)
    st["_depth"] = torch.zeros((max_depth, 0), dtype=torch.int32, device=dev)
    st["ctr_floor"] = torch.zeros((num_keys,), dtype=torch.int32, device=dev)
    return st


def _flat(state: State):
    """The slot fields and ``ctr_floor`` as ``[V, K, C]`` / ``[V, K]``
    views (V = the leading axes, 1 for none), and the leading axes."""
    lead = tuple(state["valid"].shape[:-2])
    K, C = state["valid"].shape[-2:]
    v = math.prod(lead)
    flat = {f: state[f].view(v, K, C) for f in FIELDS}
    flat["ctr_floor"] = state["ctr_floor"].view(v, K)
    return flat, lead


def apply_ops_dropped(state: State, ops: base.OpBatch):
    """Apply insert/delete ops in lane order (the ``rga_apply`` kernel),
    in place. Returns ``(state, dropped int32[...])``: the slot records
    each replica dropped into full rows."""
    flat, lead = _flat(state)
    if tuple(ops["op"].shape[:-1]) != lead:
        raise ValueError(f"op batch shape {tuple(ops['op'].shape)} does not "
                         f"match state leading axes {lead}")
    v, B = flat["valid"].shape[0], ops["op"].shape[-1]
    fops = {f: x.reshape((v, B) + tuple(x.shape[len(lead) + 1:]))
            for f, x in ops.items()}
    dropped = kernels.rga_apply(flat, fops)
    return state, dropped.reshape(lead)


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """Apply ops in lane order, in place; returns the state.

    insert: a0=chr, (a1, a2)=(parent_rep, parent_ctr), writer=replica; the
            Lamport counter is the op's ``eff_ctr`` ([..., B, 1]) when the
            batch carries one, else minted here (one more than the row's
            and the floor's greatest counter)
    delete: (a1, a2)=(target_rep, target_ctr); a target not yet present
            lands as a dead placeholder, so its insert cannot resurrect it"""
    return apply_ops_dropped(state, ops)[0]


def merge(a: State, b: State) -> State:
    out, _ = merge_with_stats(a, b)
    return out


def merge_with_stats(a: State, b: State):
    """Join = per-document union of element slots (the ``rga_union``
    kernel); ``ctr_floor`` is the max of both sides. Returns ``(state,
    overflow int32[..., K])``, the elements dropped by capacity."""
    cap = a["id_ctr"].shape[-1]
    out, overflow = kernels.rga_union(a, b, cap)
    out["_depth"] = a["_depth"]
    out["ctr_floor"] = torch.maximum(a["ctr_floor"], b["ctr_floor"])
    return out, overflow


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place: ``kernels.replica_tree.join_tree``, the halving tree of
    ``runtime.store.join_all`` with one ``rga_union`` launch per level,
    the last level writing its row into all R rows; ``ctr_floor`` by one
    ``replica_join`` launch. ``_depth`` is carried through untouched."""
    join_tree(RGA.fields, kernels.rga_union, state)
    kernels.replica_join(state["ctr_floor"], None)
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over document rows ``rows[:n_rows]`` only, in
    place: ``kernels.replica_tree.join_tree_rows``, one ``rga_union_rows``
    launch per level, and ``ctr_floor``'s listed rows by one
    ``replica_join_rows`` launch. ``_depth`` is never indexed."""
    join_tree_rows(RGA.fields, kernels.rga_union_rows, state, rows, n_rows)
    kernels.replica_join_rows(state["ctr_floor"], None, rows, n_rows)
    return state


def compact(state: State, protect: torch.Tensor | None = None) -> State:
    """Reclaim tombstoned LEAF slots (those no valid element anchors on)
    by the ``rga_compact`` kernel, in place; returns the state. Interior
    tombstones stay: they are tree structure. ``protect`` (bool
    ``[..., K, C]``) pins slots regardless. ``_depth`` and ``ctr_floor``
    are unchanged. Only safe at coordination points."""
    rows = {f: state[f] for f in FIELDS}
    kernels.rga_compact(rows, protect, out=rows)
    return state


def compact_fences(states, live_ops: base.OpBatch):
    """GC-fence compaction of every state of the tuple ``states``, in
    place (counterpart: janus_tpu/models/rga.py ``compact_fence`` per
    state): dead leaves are reclaimed except the elements the live window
    still references, each live insert's own id ``(writer, eff_ctr)`` and
    its parent ``(a1, a2)``. The protection is one ``mark_members`` per
    state, over all its views at once (membership is per record), and the
    compaction one ``rga_compact``. ``live_ops``: the flattened op-buffer
    fields ``[T]`` (``eff_ctr`` ``[T, 1]``). Returns the states."""
    is_ins = live_ops["op"] == OP_INSERT
    q_rep = torch.cat([live_ops["writer"], live_ops["a1"]])
    q_ctr = torch.cat([live_ops["eff_ctr"][..., 0], live_ops["a2"]])
    q_valid = torch.cat([is_ins, is_ins])
    for st in states:
        prot = kernels.mark_members((st["id_rep"], st["id_ctr"]),
                                    (q_rep, q_ctr), q_valid)
        compact(st, protect=prot)
    return states


def compact_fence(state: State, live_ops: base.OpBatch) -> State:
    """``compact_fences`` of one state (batched over its leading axes), in
    place; returns it."""
    return compact_fences((state,), live_ops)[0]


def _row(state: State, field: str, key) -> torch.Tensor:
    """``[..., C]``: document ``key`` of every leading index, gathered by
    JAX's gather rule."""
    x = state[field]
    k = gather_index(torch.as_tensor(key, device=x.device), x.shape[-2])
    return x.index_select(-2, k.reshape(1)).squeeze(-2)


def _order(state: State, key):
    """``(order int32 [..., C], depth_of int32 [..., C], overflow
    bool[...])`` of document ``key``: the ``rga_order`` kernel."""
    depth = state["_depth"].shape[-2]
    rows = {f: _row(state, f, key) for f in
            ("id_ctr", "id_rep", "par_ctr", "par_rep", "valid")}
    lead = tuple(rows["valid"].shape[:-1])
    C = rows["valid"].shape[-1]
    flat = {f: x.reshape(-1, C) for f, x in rows.items()}
    o, d, ovf = kernels.rga_order(flat, depth)
    return o.view(lead + (C,)), d.view(lead + (C,)), ovf.view(lead)


def text(state: State, key) -> Dict[str, torch.Tensor]:
    """Materialize document ``key``: {"chr": [..., C] payloads in document
    order, "live": [..., C] mask of visible elements, "id_rep"/"id_ctr":
    [..., C] element ids in the same order, "overflow": the linearizer's
    depth flag}."""
    idx, _, overflow = _order(state, key)
    idx = idx.long()
    live = _row(state, "valid", key) & ~_row(state, "dead", key)
    return {"chr": _row(state, "chr", key).gather(-1, idx),
            "live": live.gather(-1, idx),
            "id_rep": _row(state, "id_rep", key).gather(-1, idx),
            "id_ctr": _row(state, "id_ctr", key).gather(-1, idx),
            "overflow": overflow}


def length(state: State, key) -> torch.Tensor:
    """Visible document length."""
    live = _row(state, "valid", key) & ~_row(state, "dead", key)
    return live.sum(-1).to(torch.int32)


def element_count(state: State) -> torch.Tensor:
    """``[..., K]`` occupied slots per document (tombstones included), the
    capacity-pressure signal."""
    return state["valid"].sum(-1).to(torch.int32)


def prepare_ops(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Effect capture of op batches ``[..., B]`` against states ``[..., K,
    C]``, each against the state as given: each insert records the counter
    it would mint (one more than the greatest valid counter of its
    document and its floor) as ``eff_ctr`` ``[..., B, 1]``; other ops
    record 0. Plain PyTorch; ``base.capture_scan`` calls it op by op."""
    K, C = state["valid"].shape[-2:]
    k = gather_index(ops["key"], K)                            # [..., B]
    rows = k[..., None].expand(k.shape + (C,))

    def row(f):
        return state[f].gather(-2, rows)                       # [..., B, C]

    top = torch.where(row("valid"), row("id_ctr"), 0).amax(-1)
    top = torch.maximum(top, state["ctr_floor"].gather(-1, k))
    eff = torch.where(ops["op"] == OP_INSERT, top + 1, 0)
    return {**ops, "eff_ctr": eff[..., None].to(torch.int32)}


def capture_apply(state: State, ops: base.OpBatch):
    """The sequential capture and apply of uncaptured op batches (the
    ``rga_capture`` kernel), in place: lane by lane, each insert's counter
    is minted against the state the earlier lanes left, and the op
    applies. Returns ``(state, prepared)``, the ops with ``eff_ctr``
    ``[..., B, 1]`` (0 for a lane that is not an insert)."""
    flat, lead = _flat(state)
    if tuple(ops["op"].shape[:-1]) != lead:
        raise ValueError(f"op batch shape {tuple(ops['op'].shape)} does not "
                         f"match state leading axes {lead}")
    v, B = flat["valid"].shape[0], ops["op"].shape[-1]
    fops = {f: ops[f].reshape(v, B) for f in base.OP_FIELDS}
    eff, _ = kernels.rga_capture(flat, fops)
    return state, {**ops, "eff_ctr": eff.view(lead + (B, 1))}


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="RGA",
        type_code="rga",
        init=init,
        apply_ops=apply_ops,
        merge=merge,
        queries={"text": text, "length": length,
                 "element_count": element_count},
        # wire opCodes: a = insert-after, r = remove
        op_codes={"a": OP_INSERT, "r": OP_DELETE},
        op_extras={"eff_ctr": 1},
        prepare_ops=prepare_ops,
        capture_apply=capture_apply,
        compact_fences=compact_fences,
        apply_ops_dropped=apply_ops_dropped,
        join_replicas=join_replicas,
        join_replica_rows=join_replica_rows,
    )
)

apply_ops_delta = SPEC.apply_ops_delta

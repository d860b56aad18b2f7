"""2P2P Graph: a two-phase vertex set and a two-phase edge set per key
(counterpart: janus_tpu/models/graph.py).

Per key (one graph per key) a vertex block of CV slots (``v``,
``v_removed``, ``v_valid``) and an edge block of CE slots (``src``,
``dst``, ``e_removed``, ``e_valid``), each a 2P slot set with sticky
tombstones. ``ae`` needs both endpoints live, ``rv`` no live incident edge
and ``re`` a live edge; ``LookupEdges`` filters edges with a removed
endpoint. The join is two sorted slot unions with the tombstone OR.

The device work runs through hand kernels (``janus_tpu_torch.kernels``):

- ``graph_apply``    the sequential gated apply, in place: uncaptured (the
                     gates read the local row) and captured (the gate is
                     the op's ``ok``)
- ``graph_capture``  its capture mode: the origin's sequential capture and
                     apply at submit (``capture_apply``), each lane's gate
                     taken against the earlier lanes' state
- ``tp_union``       the vertex union and ``edge_union`` the edge union:
                     the join (``merge``) and the replica-axis converge
                     (``join_replicas``; their row-list modes for
                     ``join_replica_rows``), each over views of one block
                     under the layout's field names
- ``edge_mask``      the dangling-edge filter behind ``edge_count`` and
                     ``contains_edge``

Every function batches over leading axes of the state. A row that only an
apply wrote keeps its records in apply order; a merge makes both blocks
canonical. ``prepare_ops`` is plain PyTorch: ``models.base.capture_scan``
runs it op by op, the plain version of ``capture_apply``.
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.graph_apply import (  # noqa: F401
    OP_ADD_EDGE, OP_ADD_VERTEX, OP_FIELDS, OP_REMOVE_EDGE, OP_REMOVE_VERTEX,
    op_gates)
from janus_tpu_torch.kernels.replica_tree import join_tree, join_tree_rows
from janus_tpu_torch.kernels.slot_union import EDGE, TP
from janus_tpu_torch.kernels.tp_rows import (
    GRAPH_FIELDS as FIELDS, edge_view, graph_of, vertex_view)
from janus_tpu_torch.models import base
from janus_tpu_torch.models.base import flat_views, gather_index, key_rows
from janus_tpu_torch.ops.lattice import SENTINEL

State = Dict[str, torch.Tensor]
# {"v", "v_removed", "v_valid": [..., K, CV],
#  "src", "dst", "e_removed", "e_valid": [..., K, CE]}


def init(num_keys: int, v_capacity: int, e_capacity: int,
         device=None) -> State:
    """Empty state of ``num_keys`` graphs of ``v_capacity`` vertex and
    ``e_capacity`` edge slots."""
    dev = resolve_device(device)

    def full(c, value, dtype):
        return torch.full((num_keys, c), value, dtype=dtype, device=dev)

    return {"v": full(v_capacity, SENTINEL, torch.int32),
            "v_removed": full(v_capacity, False, torch.bool),
            "v_valid": full(v_capacity, False, torch.bool),
            "src": full(e_capacity, SENTINEL, torch.int32),
            "dst": full(e_capacity, SENTINEL, torch.int32),
            "e_removed": full(e_capacity, False, torch.bool),
            "e_valid": full(e_capacity, False, torch.bool)}


def apply_ops_dropped(state: State, ops: base.OpBatch):
    """Apply vertex and edge ops in lane order (the ``graph_apply``
    kernel), in place. Returns ``(state, dropped int32[...])``: the slot
    records each replica dropped into full blocks."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    keep = OP_FIELDS + (("ok",) if "ok" in fops else ())
    dropped = kernels.graph_apply(flat, {f: fops[f] for f in keep})
    return state, dropped.reshape(lead)


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """av: a0=v; rv: a0=v (needs v live and no live incident edge); ae:
    a0=src, a1=dst (needs both endpoints live); re: a0=src, a1=dst (needs
    the edge live). With a captured ``ok`` ([..., B, 1]) the gates were
    decided at the origin and removes upsert sticky tombstones (inserted
    if absent); without, the gates read the local state at apply time. In
    place; returns the state."""
    return apply_ops_dropped(state, ops)[0]


def prepare_ops(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Effect capture of op batches ``[..., B]`` against states, each
    against the state as given: every op's precondition gate as ``ok``
    ``[..., B, 1]`` (1 for av and codes outside 1-4). Plain PyTorch;
    ``base.capture_scan`` calls it op by op."""
    K = state["v"].shape[-2]
    k = gather_index(ops["key"], K)                            # [..., B]
    rows = {f: state[f].gather(-2, k[..., None].expand(
        k.shape + state[f].shape[-1:])) for f in FIELDS}       # [..., B, C]
    ok = op_gates(rows, ops["op"], ops["a0"], ops["a1"])
    return {**ops, "ok": ok[..., None].to(torch.int32)}


def capture_apply(state: State, ops: base.OpBatch):
    """The sequential capture and apply of uncaptured op batches (the
    ``graph_capture`` kernel), in place: lane by lane, each op's ``ok`` is
    its gate against the state the earlier lanes left, and the op applies
    captured. Returns ``(state, prepared)``, the ops with ``ok`` ``[...,
    B, 1]``."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    ok, _ = kernels.graph_capture(flat, {f: fops[f] for f in OP_FIELDS})
    return state, {**ops, "ok": ok.view(lead + (ops["op"].shape[-1], 1))}


def merge(a: State, b: State) -> State:
    out, _ = merge_with_stats(a, b)
    return out


def merge_with_stats(a: State, b: State):
    """Join = the vertex union (``tp_union``) and the edge union
    (``edge_union``) per key, each with the tombstone OR. Returns
    ``(state, (vertex overflow, edge overflow))``, int32 ``[..., K]``
    each: the records dropped by capacity."""
    vu, v_ovf = kernels.tp_union(vertex_view(a), vertex_view(b),
                                 a["v"].shape[-1])
    eu, e_ovf = kernels.edge_union(edge_view(a), edge_view(b),
                                   a["src"].shape[-1])
    return graph_of(vu, eu), (v_ovf, e_ovf)


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place: two ``kernels.replica_tree.join_tree`` runs, one over each
    block's view, one ``tp_union`` and one ``edge_union`` launch per
    level."""
    join_tree(TP.fields, kernels.tp_union, vertex_view(state))
    join_tree(EDGE.fields, kernels.edge_union, edge_view(state))
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over key rows ``rows[:n_rows]`` only, in place:
    two ``join_tree_rows`` runs, one ``tp_union_rows`` and one
    ``edge_union_rows`` launch per level."""
    join_tree_rows(TP.fields, kernels.tp_union_rows, vertex_view(state),
                   rows, n_rows)
    join_tree_rows(EDGE.fields, kernels.edge_union_rows, edge_view(state),
                   rows, n_rows)
    return state


def vertex_mask(state: State) -> torch.Tensor:
    """[..., K, CV] live vertices."""
    return state["v_valid"] & ~state["v_removed"]


def edge_mask(state: State) -> torch.Tensor:
    """[..., K, CE] live edges with both endpoints live (the LookupEdges
    dangling-edge filter; the ``edge_mask`` kernel)."""
    return kernels.edge_mask(state)


def contains_vertex(state: State, key, v) -> torch.Tensor:
    """Presence of live vertex ``v`` at ``key``."""
    hit = key_rows(vertex_mask(state), key) & (
        key_rows(state["v"], key) == torch.as_tensor(v, device=state["v"].device))
    return hit.any(-1)


def contains_edge(state: State, key, src, dst) -> torch.Tensor:
    """Presence of edge (src, dst) at ``key`` with both endpoints live."""
    dev = state["src"].device
    hit = (key_rows(edge_mask(state), key)
           & (key_rows(state["src"], key) == torch.as_tensor(src, device=dev))
           & (key_rows(state["dst"], key) == torch.as_tensor(dst, device=dev)))
    return hit.any(-1)


def vertex_count(state: State) -> torch.Tensor:
    """Live vertices per key."""
    return vertex_mask(state).sum(-1).to(torch.int32)


def edge_count(state: State) -> torch.Tensor:
    """Live edges with both endpoints live, per key."""
    return edge_mask(state).sum(-1).to(torch.int32)


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="TPTPGraph",
        type_code="graph",
        init=init,
        apply_ops=apply_ops,
        merge=merge,
        queries={"vertex_count": vertex_count, "edge_count": edge_count,
                 "contains_vertex": contains_vertex,
                 "contains_edge": contains_edge},
        op_codes={"av": OP_ADD_VERTEX, "rv": OP_REMOVE_VERTEX,
                  "ae": OP_ADD_EDGE, "re": OP_REMOVE_EDGE},
        op_extras={"ok": 1},
        prepare_ops=prepare_ops,
        capture_apply=capture_apply,
        apply_ops_dropped=apply_ops_dropped,
        join_replicas=join_replicas,
        join_replica_rows=join_replica_rows,
        key_leaf="v",
    )
)

apply_ops_delta = SPEC.apply_ops_delta

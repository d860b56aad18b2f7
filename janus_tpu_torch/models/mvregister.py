"""Multi-Value Register with per-value vector clocks (counterpart:
janus_tpu/models/mvregister.py).

Per key a row of V value slots:

    val   int32[..., K, V]      value id per slot (SENTINEL when invalid)
    valid bool [..., K, V]
    clock int32[..., K, V, W]   the writing op's vector clock

A write's clock is the pointwise max of the live clocks it observed with
its own lane bumped, so it dominates everything it observed. The join
keeps the causal frontier of the union: every value whose clock another
live value's strictly dominates is dropped, exact (val, clock) twins are
deduplicated, and the survivors, pairwise concurrent, are ordered by (val,
clock lanes) and cut to V (the overflow counted).

The device work runs through hand kernels (``janus_tpu_torch.kernels``):

- ``mvr_apply``       the sequential apply of writes, in place: captured
                      (the join with the singleton (value, wclock)) and
                      uncaptured (observe, bump, replace)
- ``mvr_capture``     its capture mode: the origin's sequential capture and
                      apply at submit (``capture_apply``), each write's
                      ``wclock`` observed against the earlier lanes' state
- ``mvr_merge``       the join (``merge``) and the replica-axis converge
                      (``join_replicas``; its row-list mode
                      ``mvr_merge_rows`` for ``join_replica_rows``)

Both kernels share the frontier (csrc/mvr_frontier.cuh; its plain twin is
``kernels.mvr_rows.frontier``). Every function batches over leading axes
of the state (``[..., K, V]``, ``clock`` ``[..., K, V, W]``, with op
fields ``[..., B]``). ``prepare_ops`` is plain PyTorch:
``models.base.capture_scan`` runs it op by op, the plain version of
``capture_apply``.
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.mvr_rows import (  # noqa: F401
    FIELDS, OP_FIELDS, OP_WRITE, wrap_add_one)
from janus_tpu_torch.kernels.replica_tree import join_tree, join_tree_rows
from janus_tpu_torch.models import base
from janus_tpu_torch.models.base import flat_views, gather_index
from janus_tpu_torch.ops.lattice import SENTINEL

State = Dict[str, torch.Tensor]


def init(num_keys: int, num_writers: int, capacity: int,
         device=None) -> State:
    """Empty state of ``num_keys`` registers of ``capacity`` value slots
    with clocks of ``num_writers`` lanes."""
    dev = resolve_device(device)
    return {
        "val": torch.full((num_keys, capacity), SENTINEL, dtype=torch.int32,
                          device=dev),
        "valid": torch.zeros((num_keys, capacity), dtype=torch.bool,
                             device=dev),
        "clock": torch.zeros((num_keys, capacity, num_writers),
                             dtype=torch.int32, device=dev),
    }


def apply_ops_dropped(state: State, ops: base.OpBatch):
    """Apply writes in lane order (the ``mvr_apply`` kernel), in place.
    Returns ``(state, dropped int32[...])``: the concurrent values each
    replica dropped when a row's frontier overflowed V."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    keep = OP_FIELDS + (("wclock",) if "wclock" in fops else ())
    dropped = kernels.mvr_apply(flat, {f: fops[f] for f in keep})
    return state, dropped.reshape(lead)


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """write: a0=value id, writer=writer lane. With a captured ``wclock``
    (``[..., B, W]``) the apply is the lattice join with the singleton
    (value, clock); without, the write observes every locally live value
    and replaces the value set. In place; returns the state."""
    return apply_ops_dropped(state, ops)[0]


def prepare_ops(state: State, ops: base.OpBatch) -> base.OpBatch:
    """Effect capture of op batches ``[..., B]`` against states ``[..., K,
    V]``, each against the state as given: a write's ``wclock`` ``[..., B,
    W]`` is the max over the live clocks of its row with lane ``writer``
    bumped where ``0 <= writer < W``; other ops record 0. Plain PyTorch;
    ``base.capture_scan`` calls it op by op."""
    K, vc = state["val"].shape[-2:]
    w = state["clock"].shape[-1]
    k = gather_index(ops["key"], K)                                # [..., B]
    valid = state["valid"].gather(-2, k[..., None].expand(k.shape + (vc,)))
    clock = state["clock"].gather(
        -3, k[..., None, None].expand(k.shape + (vc, w)))           # [..., B, V, W]
    observed = torch.where(valid[..., None], clock, 0).amax(-2)    # [..., B, W]
    lane = torch.arange(w, device=k.device) == ops["writer"][..., None]
    wclock = wrap_add_one(observed, lane)
    is_write = (ops["op"] == OP_WRITE)[..., None]
    return {**ops, "wclock": torch.where(is_write, wclock, 0)}


def capture_apply(state: State, ops: base.OpBatch):
    """The sequential capture and apply of uncaptured op batches (the
    ``mvr_capture`` kernel), in place: lane by lane, each write's
    ``wclock`` is observed against the state the earlier lanes left, and
    the write joins its row. Returns ``(state, prepared)``, the ops with
    ``wclock`` ``[..., B, W]`` (0 for a lane that is not a write)."""
    flat, fops, lead = flat_views(state, ops, FIELDS)
    wclock, _ = kernels.mvr_capture(flat, {f: fops[f] for f in OP_FIELDS})
    w = state["clock"].shape[-1]
    return state, {**ops, "wclock": wclock.view(
        lead + (ops["op"].shape[-1], w))}


def merge(a: State, b: State) -> State:
    out, _ = merge_with_stats(a, b)
    return out


def merge_with_stats(a: State, b: State):
    """Causal frontier of the union (the ``mvr_merge`` kernel); returns
    ``(state, overflow int32[..., K])``."""
    return kernels.mvr_merge(a, b, a["val"].shape[-1])


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place: ``kernels.replica_tree.join_tree``, the halving tree of
    ``runtime.store.join_all`` (overlapping halves, as the JAX package
    pairs them) with one ``mvr_merge`` launch per level, the last level
    writing its row into all R rows."""
    join_tree(FIELDS, kernels.mvr_merge, state)
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over key rows ``rows[:n_rows]`` only, in place:
    ``kernels.replica_tree.join_tree_rows``, one ``mvr_merge_rows`` launch
    per level."""
    join_tree_rows(FIELDS, kernels.mvr_merge_rows, state, rows, n_rows)
    return state


def values_mask(state: State) -> torch.Tensor:
    """[..., K, V] mask of current values (more than one live slot iff the
    key has unresolved concurrent writes)."""
    return state["valid"]


def _row(state: State, field: str, key) -> torch.Tensor:
    """Key ``key`` of every leading index, gathered by JAX's gather rule:
    ``[..., V]`` (``clock`` ``[..., V, W]``)."""
    x = state[field]
    axis = -3 if field == "clock" else -2
    k = gather_index(torch.as_tensor(key, device=x.device), x.shape[axis])
    return x.index_select(axis, k.reshape(1)).squeeze(axis)


def read(state: State, key):
    """``(vals [..., V], valid [..., V])`` for one key: the multi-value
    read."""
    return _row(state, "val", key), _row(state, "valid", key)


def key_clock(state: State) -> torch.Tensor:
    """[..., K, W] pointwise max over live value clocks (the register-level
    clock)."""
    return torch.where(state["valid"][..., None], state["clock"], 0).amax(-2)


def num_values(state: State) -> torch.Tensor:
    return state["valid"].sum(-1).to(torch.int32)


def has_value(state: State, key, v) -> torch.Tensor:
    """True iff ``v`` is among the key's current (concurrent) values."""
    vals, valid = read(state, key)
    return (valid & (vals == torch.as_tensor(v, device=vals.device))).any(-1)


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="MVRegister",
        type_code="mvr",
        init=init,
        apply_ops=apply_ops,
        merge=merge,
        queries={"num_values": num_values, "has_value": has_value},
        op_codes={"w": OP_WRITE},
        op_extras={"wclock": "num_writers"},
        prepare_ops=prepare_ops,
        capture_apply=capture_apply,
        apply_ops_dropped=apply_ops_dropped,
        join_replicas=join_replicas,
        join_replica_rows=join_replica_rows,
    )
)

apply_ops_delta = SPEC.apply_ops_delta

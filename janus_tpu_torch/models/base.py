"""CRDT type model contract + registry (counterpart: janus_tpu/models/base.py).

A type model is a set of plain functions over a dict of tensors covering
a whole key space (K keys) at once:

- ``init(num_keys, **dims, device=None) -> state``
- ``apply_ops(state, ops) -> state``   batched local update application;
  updates ``state`` in place and returns it
- ``merge(a, b) -> state``             the lattice join
- type-specific query functions

Ops travel as a uniform structure-of-arrays record (``OP_FIELDS``), each
field an int32 tensor of the same shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

from janus_tpu_torch.device import resolve_device

# Uniform op record fields. op == 0 is reserved padding (no-op).
OP_NOOP = 0
OP_FIELDS = ("op", "key", "a0", "a1", "a2", "writer")

OpBatch = Dict[str, torch.Tensor]  # each field: int32[..., B]


def make_op_batch(op=None, key=None, a0=None, a1=None, a2=None, writer=None,
                  batch: int | None = None, device=None) -> OpBatch:
    """Build a dense op batch on ``device``; missing fields are zero-filled."""
    dev = resolve_device(device)
    given = {
        f: (None if v is None
            else torch.as_tensor(v, dtype=torch.int32, device=dev))
        for f, v in {"op": op, "key": key, "a0": a0, "a1": a1,
                     "a2": a2, "writer": writer}.items()
    }
    present = [v for v in given.values() if v is not None]
    if present:
        shape = tuple(present[0].shape)  # fills match the given fields
    else:
        shape = (batch if batch is not None else 0,)
    out = {}
    for f in OP_FIELDS:
        v = given[f]
        arr = torch.zeros(shape, dtype=torch.int32, device=dev) if v is None else v
        if tuple(arr.shape) != shape:
            raise ValueError(f"op field {f!r} shape {tuple(arr.shape)} != {shape}")
        out[f] = arr
    if batch is not None and present:
        if len(shape) != 1:
            raise ValueError("batch= only applies to 1-D op batches")
        out = pad_op_batch(out, batch)  # no-op-pad up to the static size
    return out


def pad_op_batch(ops: OpBatch, to: int) -> OpBatch:
    """Pad an op batch with no-ops up to a static size ``to``."""
    n = ops["op"].shape[0]
    if n == to:
        return ops
    if n > to:
        raise ValueError(f"op batch of {n} exceeds static size {to}")
    return {f: torch.nn.functional.pad(ops[f], (0, to - n)) for f in OP_FIELDS}


def scatter_index(idx: torch.Tensor, size: int):
    """JAX's scatter index rule (``.at[idx].add/max``): an index in
    ``[-size, 0)`` counts from the end, and an index still out of range
    after that is dropped. Returns ``(index, valid)``: the normalized
    int64 index (0 where invalid, so it is always safe to address) and the
    bool mask of updates that land."""
    idx = torch.where(idx < 0, idx + size, idx)
    valid = (idx >= 0) & (idx < size)
    return torch.where(valid, idx, 0).long(), valid


def gather_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather index rule (``x[idx]``): an index in ``[-size, 0)``
    counts from the end, and what is still out of range after that is
    clamped into ``[0, size)``. Returns the int64 index."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, max(size - 1, 0)).long()


def flat_views(state, ops: OpBatch, fields):
    """The state's ``fields`` as views with their leading (replica or
    view) axes flattened into one axis of V (1 for none), the op fields as
    ``[V, B, ...]``, and the leading axes: the layout the apply kernels
    take. The leading axes are those of ``fields[0]`` before its key and
    slot axes; raises when the op batch's differ."""
    lead = tuple(state[fields[0]].shape[:-2])
    if tuple(ops["op"].shape[:-1]) != lead:
        raise ValueError(f"op batch shape {tuple(ops['op'].shape)} does not "
                         f"match state leading axes {lead}")
    v, B = math.prod(lead), ops["op"].shape[-1]
    flat = {f: state[f].view((v,) + tuple(state[f].shape[len(lead):]))
            for f in fields}
    fops = {f: x.reshape((v, B) + tuple(x.shape[len(lead) + 1:]))
            for f, x in ops.items()}
    return flat, fops, lead


def key_rows(x: torch.Tensor, key) -> torch.Tensor:
    """The rows of a leaf ``x`` ``[..., K, C]`` at ``key`` (gathered on the
    key axis by JAX's gather rule): ``[..., *key.shape, C]``."""
    k = gather_index(torch.as_tensor(key, device=x.device), x.shape[-2])
    rows = x.index_select(-2, k.reshape(-1))
    return rows.reshape(x.shape[:-2] + tuple(k.shape) + x.shape[-1:])


@dataclasses.dataclass(frozen=True)
class CRDTTypeSpec:
    """One replicated type: its state constructor, op application, join,
    and named queries (counterpart: janus_tpu.models.base.CRDTTypeSpec).

    ``apply_ops`` and the queries batch over leading replica axes of the
    state (``[..., K, ...]`` with ops ``[..., B]``), which is what the
    JAX package gets from ``vmap``."""

    name: str
    type_code: str
    init: Callable[..., Any]
    apply_ops: Callable[[Any, OpBatch], Any]
    merge: Callable[[Any, Any], Any]
    queries: Dict[str, Callable]
    op_codes: Dict[str, int]
    # Effect capture: extra per-op payload fields (name -> trailing width,
    # an int or a dim name resolved against the type's init dims) filled
    # at submit time by ``prepare_ops_batch(origin_state, ops) -> ops``.
    op_extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # ``apply_ops_dropped(state, ops) -> (state, dropped int32[...])``: the
    # apply with its per-batch count of slot records dropped by capacity,
    # and no dirty mask (the method ``apply_ops_delta`` adds the mask)
    apply_ops_dropped: "Callable[[Any, OpBatch], Any] | None" = None
    # dim-name defaults for op_extras resolution (e.g. OR-Set
    # rm_capacity -> capacity)
    dim_defaults: Dict[str, str] = dataclasses.field(default_factory=dict)
    # single-op capture: ``prepare_ops(state, ops) -> ops`` on a one-op
    # batch; ``capture_scan`` runs it lane by lane (plain PyTorch)
    prepare_ops: Callable[[Any, OpBatch], OpBatch] | None = None
    # the same sequential capture fused into a hand kernel,
    # ``capture_apply(state, ops) -> (state, prepared)``: what
    # ``capture_and_apply`` runs for a type with ``prepare_ops``
    capture_apply: "Callable[[Any, OpBatch], Any] | None" = None
    # batched exact capture: each op observes the pre-batch state plus the
    # earlier lanes of its own batch; the prepared batch applies at once
    prepare_ops_batch: Callable[[Any, OpBatch], OpBatch] | None = None
    replay_safe: bool = False
    # ``compact_fences(states, live_ops) -> states``: reclaims dead slots
    # at a GC fence, protecting those an op of the live consensus window
    # may still reference (``live_ops``: the flattened op-buffer fields),
    # in every state of the tuple ``states`` (SafeKV's prospective and
    # stable) behind the one fence; JAX's ``compact_fence`` per state
    compact_fences: "Callable[[Any, OpBatch], Any] | None" = None
    # In-place join of the leading replica axis: every replica row set to
    # the join of all rows (a hand kernel); ``runtime.store.converge``
    # needs it.
    join_replicas: Callable[[Any], Any] | None = None
    # ``join_replica_rows(state, rows, n_rows)``: the same join over key
    # rows ``rows[:n_rows]`` only (int32[L] distinct keys, int32[] count on
    # the device, read there), in place; ``runtime.store.converge_delta``
    # needs it.
    join_replica_rows: Callable[[Any, Any, Any], Any] | None = None
    # a state leaf shaped ``[..., K, X]``: its second-last axis is the key
    # axis (every type has one; other leaves, such as the RGA's
    # ``ctr_floor`` ``[..., K]``, need not be shaped so)
    key_leaf: str = "valid"

    def apply_ops_delta(self, state: Any, ops: OpBatch, dirty=None):
        """Delta form of the apply: ``apply_ops_dropped`` plus the mask of
        the key rows the batch's live ops touch (the ``dirty_rows``
        kernel), ORed into ``dirty``, the running ``[..., K]`` mask, in
        place when given. Returns ``(state, {"dirty": mask,
        "slots_dropped": dropped})``."""
        from janus_tpu_torch.kernels import dirty_rows  # kernels import base

        if self.apply_ops_dropped is None:
            raise ValueError(f"{self.name} has no apply_ops_dropped")
        num_keys = state[self.key_leaf].shape[-2]
        st, dropped = self.apply_ops_dropped(state, ops)
        mask = dirty_rows(ops["op"], ops["key"], num_keys, out=dirty)
        return st, {"dirty": mask, "slots_dropped": dropped}


def capture_and_apply(spec: CRDTTypeSpec, state: Any, ops: OpBatch):
    """Origin-side submit: returns ``(post_state, prepared_ops)``; the
    prepared ops are what ships in the consensus payload and what every
    replica replays. A type with batched capture captures the whole batch
    (each op observing the pre-batch state and the earlier lanes of its
    batch) and applies the prepared batch at once; a type with single-op
    capture captures and applies lane by lane through its capture kernel
    (``capture_apply``), and raises without one; a type without capture
    applies the batch as one (its apply reads no local state)."""
    if spec.prepare_ops_batch is not None:
        prepared = spec.prepare_ops_batch(state, ops)
        return spec.apply_ops(state, prepared), prepared
    if spec.prepare_ops is not None:
        if spec.capture_apply is None:
            raise NotImplementedError(
                f"type {spec.name!r} has single-op effect capture but no "
                "capture kernel (capture_apply)")
        return spec.capture_apply(state, ops)
    return spec.apply_ops(state, ops), ops


def capture_scan(spec: CRDTTypeSpec, state: Any, ops: OpBatch):
    """Plain PyTorch version of the single-op capture (the ``lax.scan`` of
    janus_tpu/models/base.py ``capture_and_apply``): per lane in order,
    ``spec.prepare_ops`` on the one-op batch against the state the earlier
    lanes left, then ``spec.apply_ops`` on the prepared op. Batches over
    the leading view axes of the state (op fields ``[..., B]``). Returns
    ``(state, prepared)``, the prepared fields stacked on the lane axis.
    A type's ``capture_apply`` kernel computes the same."""
    axis = ops["op"].dim() - 1
    lanes = []
    for b in range(ops["op"].shape[-1]):
        one = {f: v.narrow(axis, b, 1) for f, v in ops.items()}
        prepared = spec.prepare_ops(state, one)
        state = spec.apply_ops(state, prepared)
        lanes.append(prepared)
    if not lanes:
        return state, spec.prepare_ops(state, ops)
    return state, {f: torch.cat([p[f] for p in lanes], axis)
                   for f in lanes[0]}


_REGISTRY: Dict[str, CRDTTypeSpec] = {}


def register_type(spec: CRDTTypeSpec) -> CRDTTypeSpec:
    """Register a type model. Idempotent per type_code."""
    existing = _REGISTRY.get(spec.type_code)
    if existing is not None and existing is not spec:
        raise ValueError(f"type code {spec.type_code!r} already registered")
    _REGISTRY[spec.type_code] = spec
    return spec


def get_type(type_code: str) -> CRDTTypeSpec:
    return _REGISTRY[type_code]


def registered_types() -> Dict[str, CRDTTypeSpec]:
    return dict(_REGISTRY)

"""Replicated store: R emulated replicas of a typed key space as one
tensor program (counterpart: janus_tpu/runtime/store.py).

A replica is a leading axis of the state dict, updates are batched op
records, and anti-entropy is a lattice join over that axis. The state is
always a materialized ``[R, ...]`` tensor per leaf, never an expanded
view: ``converge`` writes the joined rows into it in place, so the next
in-place apply adds into one replica at a time.
"""
from __future__ import annotations

from typing import Any

import torch

from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.models import base


def replicated_init(spec: base.CRDTTypeSpec, num_replicas: int, device=None,
                    **dims) -> Any:
    """State dict with a leading replica axis; all replicas start empty
    (and therefore bit-identical)."""
    one = spec.init(**dims, device=resolve_device(device))
    return {
        f: x.expand((num_replicas,) + tuple(x.shape)).clone(
            memory_format=torch.contiguous_format)
        for f, x in one.items()
    }


def apply_replica_ops(spec: base.CRDTTypeSpec, state: Any, ops: base.OpBatch) -> Any:
    """Apply per-replica op batches (each field of ``ops`` is [R, B]), in
    place: a type's ``apply_ops`` batches over the leading replica axis."""
    return spec.apply_ops(state, ops)


def apply_replica_ops_delta(spec: base.CRDTTypeSpec, state: Any, ops: base.OpBatch):
    """Delta-tracking apply: ``(state, dirty[R, K], slots_dropped)``."""
    st, info = spec.apply_ops_delta(state, ops)
    return st, info["dirty"], info["slots_dropped"].sum().to(torch.int32)


def gossip_step(spec: base.CRDTTypeSpec, state: Any, distance: int = 1) -> Any:
    """One anti-entropy exchange: every replica merges the state of the
    replica ``distance`` slots behind it (ring topology)."""
    shifted = {f: torch.roll(x, distance, dims=0) for f, x in state.items()}
    return spec.merge(state, shifted)


def join_all(spec: base.CRDTTypeSpec, state: Any) -> Any:
    """Reduce the replica axis to a single global-join state [K, ...] by
    the same overlapping halving tree as the JAX package."""
    n = next(iter(state.values())).shape[0]
    while n > 1:
        half = (n + 1) // 2
        left = {f: x[:half] for f, x in state.items()}
        right = {f: x[n - half: n] for f, x in state.items()}
        state = spec.merge(left, right)
        n = half
    return {f: x[0] for f, x in state.items()}


def converge(spec: base.CRDTTypeSpec, state: Any) -> Any:
    """Full anti-entropy, in place: every replica row ends at the global
    join, bit-equal across the replica axis, by the type's
    ``join_replicas`` (a hand kernel)."""
    return spec.join_replicas(state)

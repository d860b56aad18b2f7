"""The anti-entropy engine tick: apply + converge
(counterpart: janus_tpu/runtime/engine.py).

    tick(state, ops) = converge(apply(state, ops))

Ops arrive as [R, B] batches (R replicas x B ops each, no-op padded). The
JAX package donates the state buffer to the jitted tick; here the tick
updates the state tensors in place and returns the same dict. JAX's
``jit_tick`` / ``jit_delta_tick`` wrap these ticks in ``jax.jit`` and
have no counterpart here.
"""
from __future__ import annotations

from typing import Any

from janus_tpu_torch.device import check_device, resolve_device
from janus_tpu_torch.models import base
from janus_tpu_torch.runtime.store import (
    apply_replica_ops, apply_replica_ops_delta, converge, converge_delta)


def make_tick(spec: base.CRDTTypeSpec, device=None):
    """Build the (state, ops) -> state step for one type on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)

    def tick(state: Any, ops: base.OpBatch) -> Any:
        check_device(dev, state, "state")
        check_device(dev, ops, "ops")
        return converge(spec, apply_replica_ops(spec, state, ops))

    return tick


def make_local_tick(spec: base.CRDTTypeSpec, device=None):
    """Apply-only step (no anti-entropy) — the prospective-state fast path
    when propagation is deferred to a consensus round."""
    dev = resolve_device(device)

    def tick(state: Any, ops: base.OpBatch) -> Any:
        check_device(dev, state, "state")
        check_device(dev, ops, "ops")
        return apply_replica_ops(spec, state, ops)

    return tick


def make_delta_tick(spec: base.CRDTTypeSpec, budget: int, device=None):
    """Delta-converged tick on ``device``: apply with dirty tracking, then
    join only the union-dirty key rows (``store.converge_delta``; all rows,
    counted, past ``budget`` dirty rows). Returns ``(state, overflowed,
    dirty_count, slots_dropped)``, all device tensors: the tick never
    waits for the device."""
    if spec.apply_ops_dropped is None:
        raise ValueError(f"{spec.name} has no apply_ops_delta capability")
    dev = resolve_device(device)

    def tick(state: Any, ops: base.OpBatch):
        check_device(dev, state, "state")
        check_device(dev, ops, "ops")
        st, dirty, dropped = apply_replica_ops_delta(spec, state, ops)
        st, overflowed, count = converge_delta(spec, st, dirty, budget)
        return st, overflowed, count, dropped

    return tick

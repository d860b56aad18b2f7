"""Replicated store: R emulated replicas of a typed key space as one
tensor program (counterpart: janus_tpu/runtime/store.py).

A replica is a leading axis of the state dict, updates are batched op
records, and anti-entropy is a lattice join over that axis. The state is
always a materialized ``[R, ...]`` tensor per leaf, never an expanded
view: ``converge`` writes the joined rows into it in place, so the next
in-place apply adds into one replica at a time.

Delta anti-entropy (``converge_delta``, ``Store`` with a dirty budget)
joins only the key rows some replica changed since the last converge.
Its selection, fallback choice and counters stay on the device: nothing
in ``converge_delta`` or ``Store.fused_tick`` reads back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import check_device, resolve_device
from janus_tpu_torch.models import base
from janus_tpu_torch.models import (  # noqa: F401 (registers)
    graph, lwwset, mvregister, orset, pncounter, rga, tpset)
from janus_tpu_torch.obs.metrics import get_registry


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


def apply_replica_ops_delta(spec: base.CRDTTypeSpec, state: Any,
                            ops: base.OpBatch, dirty: torch.Tensor | None = None):
    """Delta-tracking apply: ``(state, dirty[R, K], slots_dropped)``. With
    ``dirty``, the running mask, the batch's rows are ORed into it in place
    (JAX's ``_apply_and_track``)."""
    st, info = spec.apply_ops_delta(state, ops, dirty=dirty)
    return st, info["dirty"], info["slots_dropped"].sum(dtype=torch.int32)


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


def converge_delta(spec: base.CRDTTypeSpec, state: Any, dirty: torch.Tensor,
                   budget: int, clear: bool = False,
                   acc_count: torch.Tensor | None = None,
                   acc_overflow: torch.Tensor | None = None):
    """Delta anti-entropy, in place: converge only the union-dirty key
    rows. ``dirty`` is bool[R, K], the rows each replica changed since
    the last convergence.

    Rows no replica changed are bit-equal across replicas and canonical
    (``converge`` and an empty init establish it, and an apply changes
    only the rows it marks), so joining one with itself is the identity.
    The ``delta_select`` kernel takes the union and its count, orders the
    rows dirty first and writes how many to join: the count, or all K when
    the count exceeds ``budget`` (JAX's counted full-converge fallback).
    The type's ``join_replica_rows`` joins those rows and reads that
    number on the device, so this function never waits for the device.
    The state equals JAX's ``converge_delta`` bit for bit.

    With ``clear`` the mask is zeroed in the same pass (it is consumed);
    ``acc_count`` / ``acc_overflow`` (int32[]) get the count and the
    overflow flag added in place. Returns ``(state, overflowed bool[],
    count int32[])``, device tensors."""
    sel = kernels.delta_select(dirty, budget, clear=clear,
                               acc_count=acc_count, acc_overflow=acc_overflow)
    spec.join_replica_rows(state, sel.order, sel.n_join)
    return state, sel.overflowed, sel.count


class Store:
    """A host-side handle on R replicas of several typed key spaces
    (counterpart: janus_tpu/runtime/store.py ``Store``).

    ``states[type_code]`` is the state dict with a leading replica axis
    and ``dirty[type_code]`` the bool[R, K] mask of rows changed since
    the last convergence, both on ``device`` (CUDA unless the caller
    passes ``device="cpu"``). With ``dirty_budget=D``, ``sync_delta`` and
    the delta ``fused_tick`` converge only the union-dirty rows
    (``converge_delta``). Every type of the port has ``apply_ops_dropped``
    (and so the spec's ``apply_ops_delta``): every apply tracks dirty rows.

    The JAX package compiles ``fused_tick`` into one program per
    (delta mode, type set); here a tick runs each type's kernels in
    turn, with no host sync. ``fused_trace_count`` counts the builds of
    that per-(mode, types) plan (its accumulators), ``fused_dispatch_count``
    the calls. The accumulators (slots dropped, and per delta-converged
    type the overflows and the summed dirty counts) stay on the device;
    ``flush_metrics``, ``sync_delta`` and ``_flush_dropped`` read them,
    where the JAX package reads them too.
    """

    def __init__(self, num_replicas: int, types: Dict[str, Dict[str, int]],
                 dirty_budget: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.num_replicas = num_replicas
        self.dirty_budget = dirty_budget
        self.specs = {tc: base.get_type(tc) for tc in types}
        for tc, spec in self.specs.items():
            if spec.apply_ops_dropped is None:
                raise ValueError(f"type {tc!r} has no apply_ops_delta")
        self.states = {
            tc: replicated_init(self.specs[tc], num_replicas,
                                device=self.device, **dims)
            for tc, dims in types.items()
        }
        self.num_keys = {tc: int(dims["num_keys"]) for tc, dims in types.items()}
        self.dirty = {
            tc: torch.zeros((num_replicas, self.num_keys[tc]), dtype=torch.bool,
                            device=self.device)
            for tc in types
        }
        self._dropped = self._zero()
        self._fused_key = None
        self._fused_acc = None
        self.fused_trace_count = 0
        self.fused_dispatch_count = 0
        self._ticks_since_flush = 0

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def apply(self, type_code: str, ops: base.OpBatch) -> None:
        check_device(self.device, ops, "ops")
        st, _, dropped = apply_replica_ops_delta(
            self.specs[type_code], self.states[type_code], ops,
            self.dirty[type_code])
        self.states[type_code] = st
        self._dropped += dropped

    def gossip(self, type_code: str, distance: int = 1) -> None:
        # gossip merges bit-equal clean rows into themselves, so it can
        # only change rows that are already dirty: the mask stays valid
        self.states[type_code] = gossip_step(
            self.specs[type_code], self.states[type_code], distance)

    def sync(self, type_code: str) -> None:
        """Converge all replicas (the full anti-entropy round)."""
        self.states[type_code] = converge(self.specs[type_code],
                                          self.states[type_code])
        self.dirty[type_code].zero_()
        self._flush_dropped()

    def sync_delta(self, type_code: str) -> None:
        """Converge via the union-dirty rows (full converge when no budget
        is configured; an overflow of the budget falls back to all rows
        and is counted). Reads the count and the flag to the host, as the
        JAX package does, to set the registry's gauge and counter."""
        if self.dirty_budget is None:
            return self.sync(type_code)
        st, overflowed, count = converge_delta(
            self.specs[type_code], self.states[type_code],
            self.dirty[type_code], self.dirty_budget, clear=True)
        self.states[type_code] = st
        reg = get_registry()
        reg.gauge(f"store_{type_code}_dirty_fraction").set(
            float(count) / max(1, self.num_keys[type_code]))
        if bool(overflowed):
            reg.counter(f"store_{type_code}_delta_overflow_total").add(1)
        self._flush_dropped()

    def sync_all(self) -> None:
        """Converge every registered type."""
        for tc in self.states:
            self.states[tc] = converge(self.specs[tc], self.states[tc])
            self.dirty[tc].zero_()
        self._flush_dropped()

    # -- fused multi-type tick ---------------------------------------------

    def _fresh_acc(self, tcs, use_delta: bool):
        acc = {"dropped": self._zero()}
        if use_delta:
            for tc in tcs:
                acc[f"overflow_{tc}"] = self._zero()
                acc[f"dirty_sum_{tc}"] = self._zero()
        return acc

    def fused_tick(self, ops_by_type: Dict[str, base.OpBatch],
                   delta: Optional[bool] = None) -> None:
        """One tick: apply + converge every type in ``ops_by_type``, with
        no host sync. ``delta=None`` uses the delta path iff a
        ``dirty_budget`` is configured. Per type, the delta path is the
        apply kernel, ``dirty_rows`` (into the running mask),
        ``delta_select`` (which consumes the mask and adds to the
        accumulators) and the row-list join; the full path is the apply
        and the full join."""
        use_delta = (self.dirty_budget is not None) if delta is None else bool(delta)
        if use_delta and self.dirty_budget is None:
            raise ValueError("delta fused_tick requires a dirty_budget")
        tcs = tuple(sorted(ops_by_type))
        key = (use_delta, tcs)
        if self._fused_key != key:
            self._fused_key = key
            self._fused_acc = self._fresh_acc(tcs, use_delta)
            self.fused_trace_count += 1
        acc = self._fused_acc
        check_device(self.device, ops_by_type, "ops")
        for tc in tcs:
            spec, st, d = self.specs[tc], self.states[tc], self.dirty[tc]
            if use_delta:
                st, _, dropped = apply_replica_ops_delta(
                    spec, st, ops_by_type[tc], d)
                st, _, _ = converge_delta(
                    spec, st, d, self.dirty_budget, clear=True,
                    acc_count=acc[f"dirty_sum_{tc}"],
                    acc_overflow=acc[f"overflow_{tc}"])
            else:
                st, dropped = spec.apply_ops_dropped(st, ops_by_type[tc])
                dropped = dropped.sum(dtype=torch.int32)
                st = converge(spec, st)
                d.zero_()
            acc["dropped"] += dropped
            self.states[tc] = st
        self.fused_dispatch_count += 1
        self._ticks_since_flush += 1

    def flush_metrics(self) -> Dict[str, float]:
        """Fetch the device-side per-tick accumulators into the metrics
        registry (one blocking read per accumulator, amortised over the
        ticks since the last flush). Returns {type_code: mean dirty
        fraction} for delta-converged types."""
        reg = get_registry()
        out: Dict[str, float] = {}
        self._flush_dropped()
        if self._fused_acc is None:
            return out
        acc = {k: int(v) for k, v in self._fused_acc.items()}
        use_delta, tcs = self._fused_key
        ticks = max(1, self._ticks_since_flush)
        if acc["dropped"]:
            reg.counter("slots_dropped_total").add(acc["dropped"])
        for tc in tcs:
            if f"overflow_{tc}" in acc:
                if acc[f"overflow_{tc}"]:
                    reg.counter(f"store_{tc}_delta_overflow_total").add(
                        acc[f"overflow_{tc}"])
                frac = acc[f"dirty_sum_{tc}"] / ticks / max(1, self.num_keys[tc])
                reg.gauge(f"store_{tc}_dirty_fraction").set(frac)
                out[tc] = frac
        self._fused_acc = self._fresh_acc(tcs, use_delta)
        self._ticks_since_flush = 0
        return out

    def _flush_dropped(self) -> None:
        n = int(self._dropped)
        if n:
            get_registry().counter("slots_dropped_total").add(n)
        self._dropped = self._zero()

    def query(self, type_code: str, name: str, *args):
        """Run a type query on every replica (the port's queries batch
        over the leading replica axis)."""
        return self.specs[type_code].queries[name](self.states[type_code], *args)

    def rounds_to_converge(self) -> int:
        return max(1, math.ceil(math.log2(max(2, self.num_replicas))))

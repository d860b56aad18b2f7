"""PN-Counter over a whole key space as dense P/N tensors
(counterpart: janus_tpu/models/pncounter.py).

One ``int32[..., K, W]`` tensor per polarity for K keys and W writer
slots, with any number of leading replica axes. ``apply_ops`` is the
``pnc_apply`` hand kernel and the replica-axis join is the
``replica_join`` hand kernel (``join_replicas``, and its row-list mode
``join_replica_rows`` for delta anti-entropy); all update the state in
place. The dirty rows of a delta apply are the ``dirty_rows`` kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels import pnc_apply, replica_join
from janus_tpu_torch.kernels.pnc_apply import OP_DEC, OP_INC  # noqa: F401
from janus_tpu_torch.models import base
from janus_tpu_torch.ops import join_max

State = Dict[str, torch.Tensor]  # {"p": i32[..., K, W], "n": i32[..., K, W]}


def init(num_keys: int, num_writers: int, device=None) -> State:
    dev = resolve_device(device)
    return {
        "p": torch.zeros((num_keys, num_writers), dtype=torch.int32, device=dev),
        "n": torch.zeros((num_keys, num_writers), dtype=torch.int32, device=dev),
    }


def apply_ops(state: State, ops: base.OpBatch) -> State:
    """Apply a batch of inc/dec ops by scatter-add, in place.

    ``a0`` = amount, ``writer`` = the applying replica's writer slot.
    State ``[..., K, W]`` with op fields ``[..., B]``: the leading axes
    are flattened into the kernel's replica axis. Duplicate (key, writer)
    pairs accumulate; int32 sums wrap like JAX's."""
    p, n = state["p"], state["n"]
    K, W = p.shape[-2:]
    lead = p.shape[:-2]
    if tuple(ops["op"].shape[:-1]) != tuple(lead):
        raise ValueError(f"op batch shape {tuple(ops['op'].shape)} does not "
                         f"match state leading axes {tuple(lead)}")
    B = ops["op"].shape[-1]
    flat = {f: ops[f].reshape(-1, B).contiguous()
            for f in ("op", "key", "a0", "writer")}
    pnc_apply(p.view(-1, K, W), n.view(-1, K, W), flat)
    return state


def apply_ops_dropped(state: State, ops: base.OpBatch):
    """Apply + the per-batch drop count: a counter has no slot capacity,
    so nothing can drop."""
    lead = state["p"].shape[:-2]
    return apply_ops(state, ops), torch.zeros(lead, dtype=torch.int32,
                                              device=state["p"].device)


def merge(a: State, b: State) -> State:
    """Lattice join: elementwise max of both polarities."""
    return {"p": join_max(a["p"], b["p"]), "n": join_max(a["n"], b["n"])}


def join_replicas(state: State) -> State:
    """Set every row of the leading replica axis to the join of all rows,
    in place (the ``replica_join`` kernel)."""
    replica_join(state["p"], state["n"])
    return state


def join_replica_rows(state: State, rows: torch.Tensor,
                      n_rows: torch.Tensor) -> State:
    """``join_replicas`` over key rows ``rows[:n_rows]`` only, in place
    (the ``replica_join_rows`` kernel)."""
    kernels.replica_join_rows(state["p"], state["n"], rows, n_rows)
    return state


def value(state: State) -> torch.Tensor:
    """Counter value per key: sum(P) - sum(N) over the writer axis, in
    int32 with JAX's wraparound (torch sums int32 into int64)."""
    total = state["p"].sum(-1) - state["n"].sum(-1)
    return total.to(torch.int32)


SPEC = base.register_type(
    base.CRDTTypeSpec(
        name="PNCounter",
        type_code="pnc",
        init=init,
        apply_ops=apply_ops,
        merge=merge,
        queries={"get": value},
        op_codes={"i": OP_INC, "d": OP_DEC},
        # scatter-add of shipped amounts: order-insensitive, reads no
        # local state -> replay-safe without capture
        replay_safe=True,
        apply_ops_dropped=apply_ops_dropped,
        join_replicas=join_replicas,
        join_replica_rows=join_replica_rows,
        key_leaf="p",
    )
)

apply_ops_delta = SPEC.apply_ops_delta

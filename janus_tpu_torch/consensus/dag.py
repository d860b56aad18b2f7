"""Narwhal-style DAG mempool as a tensor program over a ring-buffered
round window (counterpart: janus_tpu/consensus/dag.py).

An emulated N-node cluster is one dict of tensors; a block is a (round,
source) slot; every protocol rule is a masked reduction. Round r lives in
slot ``r % W``. Shapes and meanings are those of the JAX package:

    edges        bool[W, N, N]   block (r,s) references cert of (r-1,t)
    block_exists bool[W, N]      block (r,s) has been created
    block_seen   bool[N, W, N]   node v has received block (r,s)
    acks         bool[W, N, N]   signer t has acked block (r,s)
    cert_exists  bool[W, N]      2f+1 acks assembled by the creator
    cert_seen    bool[N, W, N]   node v holds the certificate of (r,s)
    node_round   int32[N]        current (logical) round per node
    slot_round   int32[W]        logical round currently owning each slot
    base_round   int32[]         GC frontier: lowest live logical round

The six phase functions (create, deliver blocks, sign, form
certificates, deliver certificates, advance) are the ``dag_round``
kernel's plain version and live in ``kernels/dag_phases.py``; this module
re-exports them. ``round_step`` runs all six as one launch of the kernel;
on the CPU its plain version calls them in order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.kernels.dag_phases import (  # noqa: F401
    advance_rounds,
    create_blocks,
    deliver_blocks,
    deliver_certificates,
    form_certificates,
    or_at,
    sign_blocks,
    slot_of,
    structural_validity,
)
from janus_tpu_torch.kernels.gc_frontier import recycle_dag_plain

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DagConfig:
    num_nodes: int
    num_rounds: int  # static ring window W (live rounds at any moment)

    @property
    def f(self) -> int:
        return (self.num_nodes - 1) // 3

    @property
    def quorum(self) -> int:
        return 2 * self.f + 1


def init(cfg: DagConfig, device=None) -> State:
    n, w = cfg.num_nodes, cfg.num_rounds
    dev = resolve_device(device)
    b = dict(dtype=torch.bool, device=dev)
    return {
        "edges": torch.zeros((w, n, n), **b),
        "block_exists": torch.zeros((w, n), **b),
        "block_seen": torch.zeros((n, w, n), **b),
        "acks": torch.zeros((w, n, n), **b),
        "cert_exists": torch.zeros((w, n), **b),
        "cert_seen": torch.zeros((n, w, n), **b),
        "node_round": torch.zeros((n,), dtype=torch.int32, device=dev),
        "slot_round": torch.arange(w, dtype=torch.int32, device=dev),
        "base_round": torch.zeros((), dtype=torch.int32, device=dev),
    }


def recycle(cfg: DagConfig, state: State, new_base) -> State:
    """Advance the GC frontier to ``new_base`` and clear every slot whose
    round fell below it, handing the slot to round ``slot_round + W``.
    Returns a new state; SafeKV's round recycles in place instead, inside
    the ``gc_frontier`` kernel, whose plain version this shares."""
    new_base = torch.as_tensor(new_base, dtype=torch.int32,
                               device=state["slot_round"].device)
    out = {f: x.clone() for f, x in state.items()}
    recycle_dag_plain(cfg, out, state["slot_round"], new_base)
    return out


def round_step(cfg: DagConfig, state: State, active: Optional[torch.Tensor] = None,
               withhold: Optional[torch.Tensor] = None,
               invalid: Optional[torch.Tensor] = None) -> State:
    """One synchronous protocol round: create -> broadcast -> sign ->
    certify -> broadcast -> advance, in one ``dag_round`` kernel launch.
    ``active[N]``/``withhold[W, N]`` model crashed and
    certificate-withholding nodes; ``invalid[W, N]`` marks integrity-failed
    blocks. Crashed nodes neither create, sign, nor receive, and a crashed
    creator cannot aggregate a certificate."""
    return kernels.dag_round(cfg, state, active, withhold, invalid)

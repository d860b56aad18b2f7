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
on the CPU its plain version calls them in order. ``ingest_batch`` merges
messages received over the wire in one launch of ``dag_ingest``; unlike
JAX's, it updates the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
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
from janus_tpu_torch.kernels.dag_ingest import pack as pack_batch
from janus_tpu_torch.kernels.gc_frontier import recycle_dag_plain
from janus_tpu_torch.obs.metrics import get_registry

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


def ingest_batch(cfg: DagConfig, state: State, seen_by, blocks=(), sigs=(),
                 certs=(), ring: Optional[tuple] = None) -> State:
    """Apply DAG messages received over an external wire (the message
    plane): ``blocks`` = [(round, source, edges_row)] or [(round, source,
    edges_row, payload)], ``sigs`` = [(round, source, signer)], ``certs`` =
    [(round, source)]; ``seen_by`` lists the local node ids that observe
    them. The host-boundary analog of ReceivedBlock/ReceivedSignature/
    ReceivedCertificate (DAG.cs:413-472, 495-568, 574-609).

    A message lands only where its slot still owns its logical round
    (``slot_round[r % W] == r``); every write is monotone; a block's edges
    are first-write-wins; a block's round raises its creator's
    ``node_round``, in the window or not (the split cluster's GC reads it
    as evidence of remote progress). Duplicate (round, source) blocks in
    one batch: the first copy wins. A block's ``payload`` (its op fields
    flattened in ring order, int32) is written into ``ring = (fields,
    filled)`` at ``[round % W, source]`` with ``filled`` set, in the same
    launch. The wire counters, the dedupe and the int32 conversion run on
    the host; the rest is one ``dag_ingest`` launch that updates ``state``
    in place (``slot_round`` keeps its identity). Returns ``state``."""
    reg = get_registry()
    if len(blocks):
        reg.counter("dag_wire_blocks_total").add(len(blocks))
    if len(sigs):
        reg.counter("dag_wire_sigs_total").add(len(sigs))
    if len(certs):
        reg.counter("dag_wire_certs_total").add(len(certs))
    if not (len(blocks) or len(sigs) or len(certs)):
        return state
    # dedupe within the batch (first copy wins, deterministically)
    seen_ids = set()
    uniq, payloads = [], []
    for b in blocks:
        key = (int(b[0]), int(b[1]))
        if key in seen_ids:
            continue
        if np.shape(b[2]) != (cfg.num_nodes,):
            raise ValueError(f"ingest_batch: an edges row of shape "
                             f"{np.shape(b[2])}, expected ({cfg.num_nodes},)")
        seen_ids.add(key)
        if len(b) > 3 and b[3] is not None:
            payloads.append((len(uniq), b[3]))
        uniq.append(b)
    flat, counts = pack_batch(cfg.num_nodes, uniq, sigs, certs, seen_by,
                              payloads)
    msgs = torch.from_numpy(flat).to(state["slot_round"].device)
    kernels.dag_ingest(cfg, state, msgs, counts, ring=ring)
    return state


def ingest_block(cfg: DagConfig, state: State, r: int, source: int,
                 edges_row, seen_by) -> State:
    """Single-message convenience over ingest_batch."""
    return ingest_batch(cfg, state, seen_by, blocks=[(r, source, edges_row)])


def ingest_signature(cfg: DagConfig, state: State, r: int, source: int,
                     signer: int) -> State:
    """Single-message convenience over ingest_batch."""
    return ingest_batch(cfg, state, [], sigs=[(r, source, signer)])


def ingest_certificate(cfg: DagConfig, state: State, r: int, source: int,
                       seen_by) -> State:
    """Single-message convenience over ingest_batch."""
    return ingest_batch(cfg, state, seen_by, certs=[(r, source)])


def observe_dag(cfg: DagConfig, state: State, registry=None,
                scope: str = "dag") -> None:
    """Scrape-time gauges for the DAG's live shape, from one copy of the
    small per-node and per-slot fields."""
    reg = registry if registry is not None else get_registry()
    n = cfg.num_nodes
    small = torch.cat([state["node_round"].reshape(-1),
                       state["base_round"].reshape(1),
                       state["block_exists"].sum().to(torch.int32).reshape(1),
                       state["cert_exists"].sum().to(torch.int32).reshape(1)])
    vals = small.cpu().numpy()
    nr = vals[:n]
    reg.gauge(f"{scope}_base_round").set(int(vals[n]))
    reg.gauge(f"{scope}_node_round_min").set(int(nr.min()))
    reg.gauge(f"{scope}_node_round_max").set(int(nr.max()))
    reg.gauge(f"{scope}_blocks_live").set(int(vals[n + 1]))
    reg.gauge(f"{scope}_certs_live").set(int(vals[n + 2]))

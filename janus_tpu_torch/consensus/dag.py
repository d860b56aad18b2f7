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

Every phase is functional (returns a new dict; inputs are not modified)
and reads no tensor value on the host, so a round is a stream of device
launches with no synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from janus_tpu_torch.device import resolve_device

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


def slot_of(cfg: DagConfig, r):
    """Ring slot of logical round r (floor modulo, as in JAX)."""
    return r % cfg.num_rounds


def or_at(x: torch.Tensor, index, value: torch.Tensor) -> torch.Tensor:
    """Functional ``x.at[index].max(value)`` for bool tensors whose index
    tuples address distinct cells."""
    out = x.clone()
    out[index] = out[index] | value
    return out


def create_blocks(cfg: DagConfig, state: State, active: Optional[torch.Tensor] = None) -> State:
    """Each active node at round r creates its (r, v) block if it hasn't,
    referencing every certificate it holds for round r-1; the creator
    sees and self-acks it. No block outside the GC window."""
    n = cfg.num_nodes
    dev = state["node_round"].device
    vs = torch.arange(n, device=dev)
    r = state["node_round"]
    s = slot_of(cfg, r)
    act = torch.ones((n,), dtype=torch.bool, device=dev) if active is None else active
    base = state["base_round"]
    in_window = (r < base + cfg.num_rounds) & (r >= base)
    fresh = act & ~state["block_exists"][s, vs] & in_window

    sp = slot_of(cfg, r - 1)
    prev_certs = state["cert_seen"][vs, sp, :]  # [N, N]
    new_edges = prev_certs & (fresh & (r > 0))[:, None]

    out = dict(state)
    out["block_exists"] = or_at(state["block_exists"], (s, vs), fresh)
    out["edges"] = or_at(state["edges"], (s, vs), new_edges)
    out["block_seen"] = or_at(state["block_seen"], (vs, s, vs), fresh)
    out["acks"] = or_at(state["acks"], (s, vs, vs), fresh)
    return out


def deliver_blocks(cfg: DagConfig, state: State, mask: Optional[torch.Tensor] = None) -> State:
    """Broadcast: node v receives block (r,s) where mask allows and the
    block exists (mask axes: [recipient, round-slot, source])."""
    arrived = state["block_exists"][None]
    if mask is not None:
        arrived = arrived & mask
    out = dict(state)
    out["block_seen"] = state["block_seen"] | arrived
    return out


def structural_validity(cfg: DagConfig, state: State) -> torch.Tensor:
    """bool[W, N]: genesis blocks are valid; later blocks need >=2f+1
    embedded prev-certificate references."""
    refs = state["edges"].sum(-1)  # [W, N]
    return (state["slot_round"][:, None] == 0) | (refs >= cfg.quorum)


def sign_blocks(cfg: DagConfig, state: State, mask: Optional[torch.Tensor] = None,
                invalid: Optional[torch.Tensor] = None) -> State:
    """Every node acks each valid block it has seen; the signature is
    delivered to the block's creator where mask allows (mask axes:
    [signer, round-slot, source]). ``invalid[W, N]`` marks blocks honest
    nodes refuse to ack."""
    valid = structural_validity(cfg, state)  # [W, N]
    if invalid is not None:
        valid = valid & ~invalid
    sigs = state["block_seen"] & valid[None]  # [signer, W, N]
    if mask is not None:
        sigs = sigs & mask
    out = dict(state)
    out["acks"] = state["acks"] | sigs.permute(1, 2, 0)
    return out


def form_certificates(cfg: DagConfig, state: State, withhold: Optional[torch.Tensor] = None) -> State:
    """A certificate exists once 2f+1 signatures are assembled;
    ``withhold[W, N]`` suppresses formation by faulty creators. The
    creator immediately holds its own certificate."""
    n = cfg.num_nodes
    formed = state["acks"].sum(-1) >= cfg.quorum  # [W, N]
    if withhold is not None:
        formed = formed & ~withhold
    out = dict(state)
    out["cert_exists"] = state["cert_exists"] | formed
    eye = torch.eye(n, dtype=torch.bool, device=formed.device)
    own = out["cert_exists"][None, :, :] & eye[:, None, :]
    out["cert_seen"] = state["cert_seen"] | own
    return out


def deliver_certificates(cfg: DagConfig, state: State, mask: Optional[torch.Tensor] = None) -> State:
    """Certificate broadcast (mask axes: [recipient, round-slot, source])."""
    arrived = state["cert_exists"][None]
    if mask is not None:
        arrived = arrived & mask
    out = dict(state)
    out["cert_seen"] = state["cert_seen"] | arrived
    return out


def advance_rounds(cfg: DagConfig, state: State) -> State:
    """A node advances past round r once it holds 2f+1 certificates for
    round-r blocks, bounded by the GC window; a node below the GC
    frontier fast-forwards to it."""
    n = cfg.num_nodes
    vs = torch.arange(n, device=state["node_round"].device)
    r = state["node_round"]
    s = slot_of(cfg, r)
    have = state["cert_seen"][vs, s, :].sum(-1)
    base = state["base_round"]
    ready = (have >= cfg.quorum) & (r + 1 < base + cfg.num_rounds)
    out = dict(state)
    out["node_round"] = torch.maximum(r + ready.to(torch.int32), base)
    return out


def recycle(cfg: DagConfig, state: State, new_base) -> State:
    """Advance the GC frontier to ``new_base`` and clear every slot whose
    round fell below it, handing the slot to round ``slot_round + W``."""
    w = cfg.num_rounds
    new_base = torch.as_tensor(new_base, dtype=torch.int32,
                               device=state["slot_round"].device)
    live = state["slot_round"] >= new_base  # [W]
    out = dict(state)
    out["edges"] = state["edges"] & live[:, None, None]
    out["block_exists"] = state["block_exists"] & live[:, None]
    out["block_seen"] = state["block_seen"] & live[None, :, None]
    out["acks"] = state["acks"] & live[:, None, None]
    out["cert_exists"] = state["cert_exists"] & live[:, None]
    out["cert_seen"] = state["cert_seen"] & live[None, :, None]
    out["slot_round"] = torch.where(live, state["slot_round"],
                                    state["slot_round"] + w)
    out["base_round"] = new_base
    return out


def round_step(cfg: DagConfig, state: State, active: Optional[torch.Tensor] = None,
               withhold: Optional[torch.Tensor] = None,
               invalid: Optional[torch.Tensor] = None) -> State:
    """One synchronous protocol round: create -> broadcast -> sign ->
    certify -> broadcast -> advance. ``active[N]``/``withhold[W, N]``
    model crashed and certificate-withholding nodes; ``invalid[W, N]``
    marks integrity-failed blocks. Crashed nodes neither create, sign,
    nor receive, and a crashed creator cannot aggregate a certificate."""
    act_mask = None
    wh = withhold
    if active is not None:
        act_mask = active[:, None, None].expand(
            cfg.num_nodes, cfg.num_rounds, cfg.num_nodes)
        crash_wh = (~active)[None, :].expand(cfg.num_rounds, cfg.num_nodes)
        wh = crash_wh if wh is None else (wh | crash_wh)
    state = create_blocks(cfg, state, active)
    state = deliver_blocks(cfg, state, act_mask)
    state = sign_blocks(cfg, state, act_mask, invalid)
    state = form_certificates(cfg, state, wh)
    state = deliver_certificates(cfg, state, act_mask)
    state = advance_rounds(cfg, state)
    return state

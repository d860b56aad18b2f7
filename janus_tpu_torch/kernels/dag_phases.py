"""The six phase functions of one DAG protocol round, on the state dict
of ``janus_tpu_torch.consensus.dag`` (counterpart: the phases of
janus_tpu/consensus/dag.py).

They are the plain version of the ``dag_round`` kernel, so they sit below
both the kernel wrapper and ``consensus.dag``, which re-exports them.
Every phase is functional (returns a new dict; inputs are not modified)
and reads no tensor value on the host. ``cfg`` is a ``DagConfig``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

State = Dict[str, torch.Tensor]


def slot_of(cfg, r):
    """Ring slot of logical round r (floor modulo, as in JAX)."""
    return r % cfg.num_rounds


def or_at(x: torch.Tensor, index, value: torch.Tensor) -> torch.Tensor:
    """Functional ``x.at[index].max(value)`` for bool tensors whose index
    tuples address distinct cells."""
    out = x.clone()
    out[index] = out[index] | value
    return out


def create_blocks(cfg, state: State, active: Optional[torch.Tensor] = None) -> State:
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


def deliver_blocks(cfg, state: State, mask: Optional[torch.Tensor] = None) -> State:
    """Broadcast: node v receives block (r,s) where mask allows and the
    block exists (mask axes: [recipient, round-slot, source])."""
    arrived = state["block_exists"][None]
    if mask is not None:
        arrived = arrived & mask
    out = dict(state)
    out["block_seen"] = state["block_seen"] | arrived
    return out


def structural_validity(cfg, state: State) -> torch.Tensor:
    """bool[W, N]: genesis blocks are valid; later blocks need >=2f+1
    embedded prev-certificate references."""
    refs = state["edges"].sum(-1)  # [W, N]
    return (state["slot_round"][:, None] == 0) | (refs >= cfg.quorum)


def sign_blocks(cfg, state: State, mask: Optional[torch.Tensor] = None,
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


def form_certificates(cfg, state: State, withhold: Optional[torch.Tensor] = None) -> State:
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


def deliver_certificates(cfg, state: State, mask: Optional[torch.Tensor] = None) -> State:
    """Certificate broadcast (mask axes: [recipient, round-slot, source])."""
    arrived = state["cert_exists"][None]
    if mask is not None:
        arrived = arrived & mask
    out = dict(state)
    out["cert_seen"] = state["cert_seen"] | arrived
    return out


def advance_rounds(cfg, state: State) -> State:
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

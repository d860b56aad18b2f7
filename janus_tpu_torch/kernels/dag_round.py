"""``dag_round``: one synchronous DAG protocol round in one launch
(kernel source: csrc/dag_round.cu).

Replaces janus_tpu/consensus/dag.py ``round_step``: create, deliver
blocks, sign, form certificates, deliver certificates, advance, under the
optional crash, withhold and invalid masks. The plain version runs the
phase functions of ``dag_phases`` in that order.

Given ``owned`` (bool[N]), the split mode replaces
janus_tpu/net/splitnode.py ``SplitSafeKV._round_step``: a round for the
nodes one process owns. ``act = owned & active``; create, sign and certify
are masked by ``act``, withhold gains ``~act``, both deliveries reach every
node, and a node not owned keeps its ``node_round``. On the card it is a
template instantiation of the same source, counted on ``dag_round``.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``dag_round_plain`` only for tensors that lie on the CPU. Both return a
new state dict; ``slot_round`` and ``base_round`` are carried over as the
same tensors, every other field is new. On the card it takes the lean
launch path (``operands.lean_placement``, ``build.LeanLaunch``), a block
a ring slot, and the seven new fields are views of one buffer a call
(the state outlives the round, so the buffer is not reused).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from janus_tpu_torch.kernels import build, dag_phases, operands

_BOOL_FIELDS = ("edges", "block_exists", "block_seen", "acks", "cert_exists",
                "cert_seen")
_OUT_FIELDS = _BOOL_FIELDS + ("node_round",)


def split_round_plain(cfg, state, owned: torch.Tensor,
                      active: Optional[torch.Tensor] = None,
                      withhold: Optional[torch.Tensor] = None,
                      invalid: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the split mode (``SplitSafeKV._round_step``
    translated): the owned nodes act, mirrors only receive."""
    n, w = cfg.num_nodes, cfg.num_rounds
    act = owned if active is None else owned & active
    st = dag_phases.create_blocks(cfg, state, act)
    st = dag_phases.deliver_blocks(cfg, st)
    st = dag_phases.sign_blocks(cfg, st, act[:, None, None].expand(n, w, n),
                                invalid)
    wh = (~act)[None, :].expand(w, n)
    if withhold is not None:
        wh = wh | withhold
    st = dag_phases.form_certificates(cfg, st, wh)
    st = dag_phases.deliver_certificates(cfg, st)
    st = dag_phases.advance_rounds(cfg, st)
    st = dict(st)
    st["node_round"] = torch.where(owned, st["node_round"],
                                   state["node_round"])
    return st


def dag_round_plain(cfg, state, active: Optional[torch.Tensor] = None,
                    withhold: Optional[torch.Tensor] = None,
                    invalid: Optional[torch.Tensor] = None,
                    owned: Optional[torch.Tensor] = None):
    """Plain PyTorch version: the six phases in order. Crashed nodes
    neither create, sign, nor receive, and a crashed creator cannot
    aggregate a certificate. With ``owned``, the split mode."""
    if owned is not None:
        return split_round_plain(cfg, state, owned, active, withhold, invalid)
    act_mask = None
    wh = withhold
    if active is not None:
        act_mask = active[:, None, None].expand(
            cfg.num_nodes, cfg.num_rounds, cfg.num_nodes)
        crash_wh = (~active)[None, :].expand(cfg.num_rounds, cfg.num_nodes)
        wh = crash_wh if wh is None else (wh | crash_wh)
    state = dag_phases.create_blocks(cfg, state, active)
    state = dag_phases.deliver_blocks(cfg, state, act_mask)
    state = dag_phases.sign_blocks(cfg, state, act_mask, invalid)
    state = dag_phases.form_certificates(cfg, state, wh)
    state = dag_phases.deliver_certificates(cfg, state, act_mask)
    state = dag_phases.advance_rounds(cfg, state)
    return state


_LAUNCH = build.LeanLaunch("dag_round", "dag_round_launch",
                          [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int])
# the kernel's pointers (csrc/dag_round.cu), refilled by each call
_POINTERS = (ctypes.c_void_p * 20)()
# (N, W) -> the operands' shapes and the output buffer's layout
_GEOMETRY: dict = {}


def _geometry(n: int, w: int):
    """The operands' shapes, and the output buffer's fields: (field,
    byte offset, shape), each at a multiple of 16 bytes, and its int32
    words."""
    held = _GEOMETRY.get((n, w))
    if held is None:
        shapes = {"edges": (w, n, n), "block_exists": (w, n),
                  "block_seen": (n, w, n), "acks": (w, n, n),
                  "cert_exists": (w, n), "cert_seen": (n, w, n),
                  "node_round": (n,), "slot_round": (w,), "base_round": (),
                  "active": (n,), "withhold": (w, n), "invalid": (w, n),
                  "owned": (n,)}
        fields, at = [], 0
        for f in _OUT_FIELDS:
            fields.append((f, at, shapes[f]))
            at += 16 * -(-(4 * n if f == "node_round"
                           else math.prod(shapes[f])) // 16)
        held = _GEOMETRY[(n, w)] = (
            {f: torch.Size(x) for f, x in shapes.items()}, fields, at // 4)
    return held


def dag_round(cfg, state, active: Optional[torch.Tensor] = None,
              withhold: Optional[torch.Tensor] = None,
              invalid: Optional[torch.Tensor] = None,
              owned: Optional[torch.Tensor] = None):
    """One protocol round for every node (``dag.round_step``), or with
    ``owned`` bool[N] for the owned nodes only (the split mode). ``state``
    as in ``janus_tpu_torch.consensus.dag``; ``active`` bool[N],
    ``withhold`` and ``invalid`` bool[W,N], each optional."""
    n, w = cfg.num_nodes, cfg.num_rounds
    b, i32 = torch.bool, torch.int32
    shapes, fields, words = _geometry(n, w)
    dev = operands.lean_placement("dag_round", [
        *((f, state[f], b, shapes[f]) for f in _BOOL_FIELDS),
        ("node_round", state["node_round"], i32, shapes["node_round"]),
        ("slot_round", state["slot_round"], i32, shapes["slot_round"]),
        ("base_round", state["base_round"], i32, shapes["base_round"]),
        ("active", active, b, shapes["active"]),
        ("withhold", withhold, b, shapes["withhold"]),
        ("invalid", invalid, b, shapes["invalid"]),
        ("owned", owned, b, shapes["owned"])])
    if dev is None:
        return dag_round_plain(cfg, state, active, withhold, invalid, owned)
    if n > operands.MAX_NODES:
        operands.check_fits("dag_round", n, 0)
    buf = torch.empty((words,), dtype=i32, device=dev)
    flags = buf.view(b)
    out = dict(state)
    for f, at, shape in fields:
        out[f] = (buf[at // 4:at // 4 + n] if f == "node_round"
                  else flags[at:at + math.prod(shape)].view(shape))
    base = buf.data_ptr()
    ptrs = _POINTERS
    ptrs[:] = (*(state[f].data_ptr() for f in _OUT_FIELDS),
               state["slot_round"].data_ptr(), state["base_round"].data_ptr(),
               *(None if m is None else m.data_ptr()  # null: mask absent
                 for m in (active, withhold, invalid, owned)),
               *(base + at for _, at, _ in fields))
    _LAUNCH(dev, ptrs, n, w, cfg.quorum)
    dag_round.launches += 1
    return out


dag_round.launches = 0

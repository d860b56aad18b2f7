"""``edge_mask``: the 2P2P Graph's dangling-edge filter (kernel source:
csrc/edge_mask.cu).

Replaces janus_tpu/models/graph.py ``edge_mask``, the ``[..., K, CE, CV]``
broadcast membership test behind ``edge_count`` and ``contains_edge``: the
live edges (valid, no tombstone) whose two endpoints are both live
vertices. As in JAX, the slots of dead vertices stand for ``INT32_MAX``,
so an endpoint of that value matches any row that has such a slot. Bound
on the H100 by bytes: each slot read once, one byte written an edge slot;
see the source note.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``edge_mask_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.tp_rows import GRAPH_DTYPES, GRAPH_FIELDS
from janus_tpu_torch.ops.lattice import SENTINEL


def edge_mask_plain(state) -> torch.Tensor:
    """Plain PyTorch version: JAX's broadcast membership test."""
    e_live = state["e_valid"] & ~state["e_removed"]
    vm = state["v_valid"] & ~state["v_removed"]
    vset = torch.where(vm, state["v"], SENTINEL)[..., None, :]

    def endpoint_live(x):
        return (x[..., :, None] == vset).any(-1)

    return e_live & endpoint_live(state["src"]) & endpoint_live(state["dst"])


def _lib():
    lib = build.load("edge_mask")
    if lib.edge_mask_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.edge_mask_launch.argtypes = [
            ctypes.POINTER(ptr), ptr, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.edge_mask_launch.restype = ctypes.c_int
    return lib


def edge_mask(state) -> torch.Tensor:
    """bool ``[..., K, CE]``: the live edges of each row with both
    endpoints live vertices. ``state``: the Graph's leaves
    (``tp_rows.GRAPH_FIELDS``), ``[..., K, CV]`` and ``[..., K, CE]``."""
    lead = tuple(state["v"].shape[:-1])
    CV, CE = state["v"].shape[-1], state["src"].shape[-1]
    dev = operands.placement("edge_mask", [
        (f"state.{f}", state[f], GRAPH_DTYPES[f],
         lead + ((CV,) if f.startswith("v") else (CE,)))
        for f in GRAPH_FIELDS])
    if dev is None:
        return edge_mask_plain(state)
    operands.check_shared("edge_mask", 4 * CV)
    out = torch.empty(lead + (CE,), dtype=torch.bool, device=dev)
    rows = math.prod(lead)
    if rows * CE == 0:
        return out
    fields = (ctypes.c_void_p * 7)(*(state[f].data_ptr()
                                     for f in GRAPH_FIELDS))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.edge_mask_launch(fields, out.data_ptr(), rows, CV, CE,
                                  stream)
    build.check_launch("edge_mask", rc)
    edge_mask.launches += 1
    return out


edge_mask.launches = 0

"""``causal_closure``: SafeKV's predecessor-completeness gate for every view
in one launch (kernel source: csrc/causal_closure.cu).

Replaces janus_tpu/runtime/safecrdt.py ``SafeKV._causal_closure``, a
W-iteration fixpoint whose every iteration reads the whole previous
iterate.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``causal_closure_plain`` only for tensors that lie on the CPU. Both return
a new tensor and leave their inputs as they were.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands


def causal_closure_plain(cfg, dag_state, applied: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: blocks applicable in each view (certificate
    held, not yet applied, and every referenced predecessor already
    applied or becoming applicable earlier in round order); the slot
    holding ``base_round`` has its predecessor applied by definition."""
    edges = dag_state["edges"]
    cert_seen = dag_state["cert_seen"]
    is_base = (dag_state["slot_round"] == dag_state["base_round"])[None, :, None]
    for _ in range(cfg.num_rounds):
        prev_applied = torch.roll(applied, 1, dims=1) | is_base
        viol = (edges[None] & ~prev_applied[:, :, None, :]).any(-1)
        applied = applied | (cert_seen & ~applied & ~viol)
    return applied


def _lib():
    lib = build.load("causal_closure")
    if lib.causal_closure_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.causal_closure_launch.argtypes = [ptr] * 6 + [
            ctypes.c_int, ctypes.c_int, ptr]
        lib.causal_closure_launch.restype = ctypes.c_int
    return lib


def shared_bytes(n: int, w: int) -> int:
    """Dynamic shared memory of one block (csrc/causal_closure.cu)."""
    return 8 * (w * n + 3 * w)


def causal_closure(cfg, dag_state, applied: torch.Tensor) -> torch.Tensor:
    """The applied state after W iterations of the gate, per view.
    ``dag_state``: edges bool[W,N,N], cert_seen bool[N,W,N], slot_round
    int32[W], base_round int32[]; ``applied``: bool[N,W,N]."""
    n, w = cfg.num_nodes, cfg.num_rounds
    b, i32 = torch.bool, torch.int32
    edges, cert_seen = dag_state["edges"], dag_state["cert_seen"]
    slot_round, base_round = dag_state["slot_round"], dag_state["base_round"]
    dev = operands.placement("causal_closure", [
        ("edges", edges, b, (w, n, n)), ("cert_seen", cert_seen, b, (n, w, n)),
        ("applied", applied, b, (n, w, n)), ("slot_round", slot_round, i32, (w,)),
        ("base_round", base_round, i32, ())])
    if dev is None:
        return causal_closure_plain(cfg, dag_state, applied)
    operands.check_fits("causal_closure", n, shared_bytes(n, w))
    out = torch.empty_like(applied)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.causal_closure_launch(
            edges.data_ptr(), cert_seen.data_ptr(), applied.data_ptr(),
            slot_round.data_ptr(), base_round.data_ptr(), out.data_ptr(),
            n, w, stream)
    build.check_launch("causal_closure", rc)
    causal_closure.launches += 1
    return out


causal_closure.launches = 0

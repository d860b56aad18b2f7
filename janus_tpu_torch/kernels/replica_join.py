"""``replica_join``: in-place replica-axis join of the PN-Counter
(kernel source: csrc/replica_join.cu).

Replaces janus_tpu/runtime/store.py ``converge`` (``join_all`` by
``pncounter.merge`` = ``lattice.join_max``, then a broadcast to all R
rows). Bound on the H100 by bytes: P and N are each read once and written
once; see the source note for the design.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and
runs ``replica_join_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands


def replica_join_plain(p: torch.Tensor, n: torch.Tensor) -> None:
    """Plain PyTorch version: ``amax(0)`` followed by a copy into every
    replica row, in place. ``p``, ``n``: int32[R, ...]."""
    for x in (p, n):
        x.copy_(x.amax(0).expand_as(x))


def _lib():
    lib = build.load("replica_join")
    if lib.replica_join_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.replica_join_launch.argtypes = [
            ptr, ptr, ctypes.c_longlong, ctypes.c_longlong, ptr]
        lib.replica_join_launch.restype = ctypes.c_int
    return lib


def replica_join(p: torch.Tensor, n: torch.Tensor) -> None:
    """Set every replica row of ``p`` and ``n`` to the max over the
    replica (leading) axis, in place. ``p``, ``n``: int32[R, ...]."""
    if p.dim() < 1:
        raise ValueError("replica_join: p has no replica axis")
    i32 = torch.int32
    dev = operands.placement("replica_join", [
        ("p", p, i32, p.shape), ("n", n, i32, p.shape)])
    if dev is None:
        return replica_join_plain(p, n)
    R = p.shape[0]
    row = p[0].numel() if R else 0
    if R * row == 0:
        return
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.replica_join_launch(p.data_ptr(), n.data_ptr(), R, row,
                                     stream)
    build.check_launch("replica_join", rc)
    replica_join.launches += 1


replica_join.launches = 0

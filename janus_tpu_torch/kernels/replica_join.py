"""``replica_join``: in-place replica-axis join of the PN-Counter
(kernel source: csrc/replica_join.cu).

Replaces janus_tpu/runtime/store.py ``converge`` (``join_all`` by
``pncounter.merge`` = ``lattice.join_max``, then a broadcast to all R
rows). Bound on the H100 by bytes: P and N are each read once and written
once; see the source note for the design.

``replica_join_rows`` is the kernel's row-list mode: the same join over
listed key rows only, the count of rows read from device memory. It
replaces the slab gather, ``join_all`` and scatter of
janus_tpu/runtime/store.py ``converge_delta`` for the PN-Counter.

Either wrapper takes one operand when ``n`` is None: the RGA's converge
joins its ``[R, K]`` Lamport floor (``ctr_floor``) this way.

The wrappers launch the CUDA kernel for CUDA tensors (or raise) and
run their plain versions only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands


def replica_join_plain(p: torch.Tensor, n: torch.Tensor | None) -> None:
    """Plain PyTorch version: ``amax(0)`` followed by a copy into every
    replica row, in place. ``p``, ``n``: int32[R, ...] (``n`` may be
    None)."""
    for x in (p, n):
        if x is not None:
            x.copy_(x.amax(0).expand_as(x))


def _lib():
    lib = build.load("replica_join")
    if lib.replica_join_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.replica_join_launch.argtypes = [
            ptr, ptr, ctypes.c_longlong, ctypes.c_longlong, ptr]
        lib.replica_join_launch.restype = ctypes.c_int
        lib.replica_join_rows_launch.argtypes = [
            ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ptr,
            ctypes.c_int, ptr, ptr]
        lib.replica_join_rows_launch.restype = ctypes.c_int
    return lib


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def replica_join(p: torch.Tensor, n: torch.Tensor | None) -> None:
    """Set every replica row of ``p`` and ``n`` to the max over the
    replica (leading) axis, in place. ``p``, ``n``: int32[R, ...]; with
    ``n`` None, ``p`` alone."""
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
        rc = lib.replica_join_launch(p.data_ptr(), _ptr(n), R, row, stream)
    build.check_launch("replica_join", rc)
    replica_join.launches += 1


replica_join.launches = 0


def replica_join_rows_plain(p: torch.Tensor, n: torch.Tensor | None,
                            rows: torch.Tensor, n_rows: torch.Tensor) -> None:
    """Plain PyTorch version: gather the first ``n_rows`` listed key rows,
    ``amax(0)``, and write them back into every replica, in place."""
    idx = rows[:int(n_rows)].long()
    for x in (p, n):
        if x is not None:
            x[:, idx] = x[:, idx].amax(0, keepdim=True)


def replica_join_rows(p: torch.Tensor, n: torch.Tensor | None,
                      rows: torch.Tensor, n_rows: torch.Tensor) -> None:
    """Set key rows ``rows[:n_rows]`` of every replica of ``p`` and ``n``
    (int32 ``[R, K, ...]``; ``n`` may be None) to their max over the
    replica axis, in place.
    ``rows``: int32[L], distinct keys in [0, K); ``n_rows``: int32[] on
    the same device, read there (no host sync), at most L counted."""
    if p.dim() < 2:
        raise ValueError("replica_join_rows: p has no [R, K] axes")
    i32 = torch.int32
    L = rows.shape[0] if rows.dim() == 1 else -1
    dev = operands.placement("replica_join_rows", [
        ("p", p, i32, p.shape), ("n", n, i32, p.shape),
        ("rows", rows, i32, (L,)), ("n_rows", n_rows, i32, ())])
    if dev is None:
        return replica_join_rows_plain(p, n, rows, n_rows)
    R, K = p.shape[:2]
    row = p[0, 0].numel() if R * K else 0
    if R * K * row * L == 0:
        return
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.replica_join_rows_launch(
            p.data_ptr(), _ptr(n), R, K, row, rows.data_ptr(), L,
            n_rows.data_ptr(), stream)
    build.check_launch("replica_join_rows", rc)
    replica_join_rows.launches += 1


replica_join_rows.launches = 0

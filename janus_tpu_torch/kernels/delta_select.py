"""``delta_select``: the dirty-slab selection of delta anti-entropy
(kernel source: csrc/delta_select.cu).

Replaces the selection of janus_tpu/runtime/store.py ``converge_delta``:
the union of the ``[R, K]`` dirty mask over replicas, its count, the
stable dirty-first row order and the overflow flag, plus the number of
rows the join must take (``n_join``: the count, or K on overflow), which
stands in for JAX's on-device ``lax.cond``. Every output stays on the
device. Bound on the H100 by bytes; see the source note.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``delta_select_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from janus_tpu_torch.kernels import build, operands


class Selection(NamedTuple):
    """What ``delta_select`` returns, all on the mask's device.

    ``order``: int32[K], every key, dirty ones first, each class in key
    order (its first D entries are JAX's ``argsort(~dirty_u,
    stable=True)[:D]``); ``count``: int32[] union-dirty keys;
    ``overflowed``: bool[] ``count > budget``; ``n_join``: int32[] the
    rows of ``order`` to join, ``count`` or K on overflow."""

    order: torch.Tensor
    count: torch.Tensor
    overflowed: torch.Tensor
    n_join: torch.Tensor


def delta_select_plain(dirty: torch.Tensor, budget: int, clear: bool = False,
                       acc_count: torch.Tensor | None = None,
                       acc_overflow: torch.Tensor | None = None) -> Selection:
    """Plain PyTorch version: ``any`` over replicas, a stable ``argsort``
    and a ``where``. ``dirty``: bool[R, K]."""
    K = dirty.shape[-1]
    union = dirty.any(0)
    count = union.sum(dtype=torch.int32)
    order = torch.argsort((~union).to(torch.int32), stable=True)
    overflowed = count > budget
    n_join = torch.where(overflowed, K, count).to(torch.int32)
    if clear:
        dirty.zero_()
    if acc_count is not None:
        acc_count += count
    if acc_overflow is not None:
        acc_overflow += overflowed.to(torch.int32)
    return Selection(order.to(torch.int32), count, overflowed, n_join)


def _lib():
    lib = build.load("delta_select")
    if lib.delta_select_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.delta_select_launch.argtypes = [
            ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *[ptr] * 8]
        lib.delta_select_launch.restype = ctypes.c_int
    return lib


def delta_select(dirty: torch.Tensor, budget: int, clear: bool = False,
                 acc_count: torch.Tensor | None = None,
                 acc_overflow: torch.Tensor | None = None) -> Selection:
    """Select the rows delta anti-entropy joins from ``dirty`` (bool
    ``[R, K]``) under a budget of ``budget`` rows; see ``Selection``.
    With ``clear`` the mask is zeroed in the same pass (the converge
    consumes it). ``acc_count`` / ``acc_overflow`` (int32[]), when given,
    get ``count`` and ``overflowed`` added in place: running sums that
    stay on the device."""
    if dirty.dim() != 2:
        raise ValueError(f"delta_select: dirty has shape "
                         f"{tuple(dirty.shape)}, expected [R, K]")
    R, K = dirty.shape
    i32 = torch.int32
    dev = operands.placement("delta_select", [
        ("dirty", dirty, torch.bool, (R, K)),
        ("acc_count", acc_count, i32, ()),
        ("acc_overflow", acc_overflow, i32, ())])
    if dev is None:
        return delta_select_plain(dirty, budget, clear, acc_count, acc_overflow)
    union = torch.empty(K, dtype=torch.bool, device=dev)
    out = Selection(torch.empty(K, dtype=i32, device=dev),
                    torch.empty((), dtype=i32, device=dev),
                    torch.empty((), dtype=torch.bool, device=dev),
                    torch.empty((), dtype=i32, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.delta_select_launch(
            dirty.data_ptr(), R, K, min(int(budget), 2**31 - 1), int(clear),
            union.data_ptr(), *(t.data_ptr() for t in out),
            None if acc_count is None else acc_count.data_ptr(),
            None if acc_overflow is None else acc_overflow.data_ptr(), stream)
    build.check_launch("delta_select", rc)
    delta_select.launches += 1
    return out


delta_select.launches = 0

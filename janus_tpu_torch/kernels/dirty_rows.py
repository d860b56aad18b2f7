"""``dirty_rows``: the per-replica dirty-row mask of delta anti-entropy
(kernel source: csrc/dirty_rows.cu).

Replaces janus_tpu/models/base.py ``op_dirty_rows`` (vmapped over the
replica axis) and the OR of a batch's rows into the running mask of
janus_tpu/runtime/store.py ``_apply_and_track`` and ``Store.fused_tick``.
Bound on the H100 by bytes: the op and key fields read once, one byte
stored per distinct (replica, key) marked; see the source note.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``dirty_rows_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.models.base import OP_NOOP, scatter_index


def dirty_rows_plain(op: torch.Tensor, key: torch.Tensor, num_keys: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: a ``scatter_add_`` of the live ops' hits
    under JAX's scatter index rule, ORed into ``out`` in place (or into a
    fresh mask). Arguments as for ``dirty_rows``."""
    k, valid = scatter_index(key, num_keys)
    hit = ((op != OP_NOOP) & valid).to(torch.int32)
    count = torch.zeros(op.shape[:-1] + (num_keys,), dtype=torch.int32,
                        device=op.device)
    mask = count.scatter_add_(-1, k, hit) > 0
    if out is None:
        return mask
    out |= mask
    return out


_LAUNCH = build.LeanLaunch(
    "dirty_rows", "dirty_rows_launch",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int))


def dirty_rows(op: torch.Tensor, key: torch.Tensor, num_keys: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """bool ``[..., K]``: the key rows that live (non-noop) ops of each
    batch touch, by JAX's scatter rule (a negative key counts from the
    end, one still out of range marks nothing). ``op``, ``key``: int32
    ``[..., B]``. With ``out`` (the running mask) the rows are ORed into
    it in place; otherwise a fresh mask is returned. Runs on the lean
    launch path (``operands.lean_placement``, ``build.LeanLaunch``)."""
    shape = op.shape
    batch = shape if shape else (-1,)  # a 0-d op is refused
    mask = shape[:-1] + (num_keys,)
    dev = operands.lean_placement("dirty_rows", (
        ("op", op, torch.int32, batch), ("key", key, torch.int32, batch),
        ("out", out, torch.bool, mask)))
    if dev is None:
        return dirty_rows_plain(op, key, num_keys, out)
    if out is None:
        out = torch.zeros(mask, dtype=torch.bool, device=dev)
    ops = op.numel()
    if ops * num_keys == 0:
        return out
    _LAUNCH(dev, op.data_ptr(), key.data_ptr(), out.data_ptr(),
            ops // shape[-1], shape[-1], num_keys)
    dirty_rows.launches += 1
    return out


dirty_rows.launches = 0

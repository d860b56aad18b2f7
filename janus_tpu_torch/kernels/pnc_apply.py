"""``pnc_apply``: PN-Counter batched apply (kernel source: csrc/pnc_apply.cu).

Replaces janus_tpu/models/pncounter.py ``apply_ops`` batched over the
replica axis (janus_tpu/runtime/store.py ``apply_replica_ops``). Bound on
the H100 by the op-field reads and one scattered atomic per op; see the
source note for the design.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and
runs ``pnc_apply_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.models.base import scatter_index

OP_INC = 1  # reference opId 1 = Increment
OP_DEC = 2  # reference opId 2 = Decrement
_FIELDS = ("op", "key", "a0", "writer")


def pnc_apply_plain(p: torch.Tensor, n: torch.Tensor, ops) -> None:
    """Plain PyTorch version: ``index_put_(..., accumulate=True)`` with
    JAX's scatter index rule. ``p``, ``n``: int32[R, K, W]; op fields
    int32[R, B]. Updates ``p`` and ``n`` in place."""
    R, K, W = p.shape
    op = ops["op"]
    key, key_ok = scatter_index(ops["key"], K)
    wr, wr_ok = scatter_index(ops["writer"], W)
    ok = key_ok & wr_ok
    r = torch.arange(R, device=p.device).view(R, 1).expand(op.shape)
    for state, code in ((p, OP_INC), (n, OP_DEC)):
        val = torch.where(ok & (op == code), ops["a0"], 0)
        state.index_put_((r, key, wr), val, accumulate=True)


def _lib():
    lib = build.load("pnc_apply")
    if lib.pnc_apply_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.pnc_apply_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ptr]
        lib.pnc_apply_launch.restype = ctypes.c_int
    return lib


def pnc_apply(p: torch.Tensor, n: torch.Tensor, ops) -> None:
    """Add every op's ``a0`` into ``p`` (op 1) or ``n`` (op 2) at
    ``[r, key, writer]``, in place. ``p``, ``n``: int32[R, K, W]; op
    fields int32[R, B]."""
    if p.dim() != 3:
        raise ValueError(f"pnc_apply: state shape {tuple(p.shape)} is not "
                         f"[R, K, W]")
    R, K, W = p.shape
    B = ops["op"].shape[1] if ops["op"].dim() == 2 else -1
    i32 = torch.int32
    # the kernel reads B columns of every op field
    dev = operands.placement("pnc_apply", [
        ("p", p, i32, (R, K, W)), ("n", n, i32, (R, K, W)),
        *((f"op field {f!r}", ops[f], i32, (R, B)) for f in _FIELDS)])
    if dev is None:
        return pnc_apply_plain(p, n, ops)
    if R * B == 0:
        return
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pnc_apply_launch(
            p.data_ptr(), n.data_ptr(), *(ops[f].data_ptr() for f in _FIELDS),
            R, K, W, B, stream)
    build.check_launch("pnc_apply", rc)
    pnc_apply.launches += 1


pnc_apply.launches = 0

"""``mark_members``: membership of two-part int32 keys in a masked query
set (kernel source: csrc/mark_members.cu).

Replaces janus_tpu/ops/setops.py ``mark_members``, the protection test of
the RGA's GC-fence compaction: true where A's key equals some query key
whose ``b_valid`` is set. The kernel sorts the valid queries in chunks of
4,096 (one launch) and binary-searches every A key in each chunk (a
second launch). See the source note.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``mark_members_plain`` (``ops.setops.mark_members``) only for tensors that
lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.ops.setops import mark_members as mark_members_plain

# queries sorted per block (csrc/mark_members.cu CHUNK)
CHUNK = 4096


def _lib():
    lib = build.load("mark_members")
    if lib.mark_members_launch.argtypes is None:
        ptr, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.mark_members_launch.argtypes = [ptr, ptr, ll, ptr, ptr, ptr, ll,
                                            ptr, ptr, ptr, ptr]
        lib.mark_members_launch.restype = ctypes.c_int
    return lib


def mark_members(a_keys, b_keys, b_valid) -> torch.Tensor:
    """bool, A's shape: does A record i's key ``(a_keys[0][i],
    a_keys[1][i])`` (int32, any shape) equal some query key ``(b_keys[0][j],
    b_keys[1][j])`` (int32 ``[T]``) whose ``b_valid[j]`` (bool ``[T]``) is
    set?"""
    (a1, a2), (b1, b2) = a_keys, b_keys
    shape, t = tuple(a1.shape), b1.shape[0] if b1.dim() == 1 else -1
    dev = operands.placement("mark_members", [
        ("a_keys[0]", a1, torch.int32, shape),
        ("a_keys[1]", a2, torch.int32, shape),
        ("b_keys[0]", b1, torch.int32, (t,)),
        ("b_keys[1]", b2, torch.int32, (t,)),
        ("b_valid", b_valid, torch.bool, (t,))])
    if dev is None:
        return mark_members_plain(a_keys, b_keys, b_valid)
    m = a1.numel()
    if m == 0 or t == 0:
        return torch.zeros(shape, dtype=torch.bool, device=dev)
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    chunks = -(-t // CHUNK)
    sorted_ = torch.empty((chunks * CHUNK,), dtype=torch.int64, device=dev)
    counts = torch.empty((chunks,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mark_members_launch(
            a1.data_ptr(), a2.data_ptr(), m, b1.data_ptr(), b2.data_ptr(),
            b_valid.data_ptr(), t, sorted_.data_ptr(), counts.data_ptr(),
            out.data_ptr(), stream)
    build.check_launch("mark_members", rc)
    mark_members.launches += 1
    return out


mark_members.launches = 0

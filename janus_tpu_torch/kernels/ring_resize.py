"""``ring_resize``: SafeKV's op ring resized along its block axis
(kernel source: csrc/ring_resize.cu).

Replaces the device work of janus_tpu/runtime/safecrdt.py
``SafeKV.resize_block`` (744-795): a grow zero-pads axis 2 of every ring
field, a shrink slices it after checking that no tail lane of ``op`` is
live. One launch copies every field into the new ring and reduces that
check to one int32 flag, so a shrink's host read is 4 bytes. Bound on the
H100 by bytes: the kept lanes read once, the new ring written once.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``ring_resize_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.models.base import OP_NOOP

# ring fields one launch takes (the six op fields and the type's extras)
MAX_FIELDS = 16


def ring_resize_plain(ring: Dict[str, torch.Tensor], new_b: int
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain PyTorch version: each field zero-filled at the new width and
    its kept lanes copied; the flag is 1 where a lane of ``op`` past
    ``new_b`` is live. Arguments and result as for ``ring_resize``."""
    out = {}
    for f, x in ring.items():
        y = x.new_zeros(tuple(x.shape[:2]) + (new_b,) + tuple(x.shape[3:]))
        keep = min(new_b, x.shape[2])
        y[:, :, :keep] = x[:, :, :keep]
        out[f] = y
    live = (ring["op"][:, :, new_b:] != OP_NOOP).any()
    return out, live.to(torch.int32).reshape(1)


def _lib():
    lib = build.load("ring_resize")
    if not getattr(lib, "_typed", False):
        fn = lib.ring_resize_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def ring_resize(ring: Dict[str, torch.Tensor], new_b: int
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``ring``: int32 fields ``[W, N, B]`` or ``[W, N, B, width]``, one of
    them ``op``. Returns ``(new ring, flag)``: fresh fields ``[W, N,
    new_b(, width)]`` holding the first ``min(B, new_b)`` lanes of each
    field and zeros past them, and an int32 ``[1]`` flag, 1 when a lane of
    ``op`` at or past ``new_b`` is not OP_NOOP (0 on a grow). The ring
    given is not changed."""
    new_b = int(new_b)
    if "op" not in ring or new_b < 1:
        raise ValueError("ring_resize: the ring needs an op field and "
                         "new_b >= 1")
    names = list(ring)
    w, n, b = (int(s) for s in ring["op"].shape)
    dev = operands.placement("ring_resize", [
        (f"ring.{f}", ring[f], torch.int32,
         (w, n, b) + tuple(ring[f].shape[3:])) for f in names])
    if dev is None:
        return ring_resize_plain(ring, new_b)
    if len(names) > MAX_FIELDS:
        raise ValueError(f"ring_resize: {len(names)} ring fields, at most "
                         f"{MAX_FIELDS}")
    out = {f: torch.empty((w, n, new_b) + tuple(ring[f].shape[3:]),
                          dtype=torch.int32, device=dev) for f in names}
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    k = len(names)
    src = (ctypes.c_void_p * k)(*(ring[f].data_ptr() for f in names))
    dst = (ctypes.c_void_p * k)(*(out[f].data_ptr() for f in names))
    width = (ctypes.c_longlong * k)(
        *(ring[f][0, 0, 0].numel() for f in names))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ring_resize_launch(src, dst, width, k, w * n, b, new_b,
                                    names.index("op"), flag.data_ptr(),
                                    stream)
    build.check_launch("ring_resize", rc)
    ring_resize.launches += 1
    return out, flag


ring_resize.launches = 0

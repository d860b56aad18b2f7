"""``ring_resize``: SafeKV's op ring resized along its block axis
(kernel source: csrc/ring_resize.cu).

Replaces the device work of janus_tpu/runtime/safecrdt.py
``SafeKV.resize_block`` (744-795): a grow zero-pads axis 2 of every ring
field, a shrink slices it after checking that no tail lane of ``op`` is
live. One launch copies every field into the new ring and reduces that
check to one int32 flag, so a shrink's host read is 4 bytes. Bound on the
H100 by bytes: the kept lanes read once, the new ring written once.

The new ring is one int32 buffer (``ring_layout``): each field a
contiguous view starting on a 16-byte boundary, the flag its last word.
The wrapper takes the lean launch path (``build.LeanLaunch`` after
``operands.lean_placement``): field widths come from shapes, one
allocation, and the flag is zeroed by the launch. It launches the CUDA
kernel for CUDA tensors (or raises) and runs ``ring_resize_plain`` only
for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.models.base import OP_NOOP

# ring fields one launch takes (the six op fields and the type's extras)
MAX_FIELDS = 16

_LAUNCH = build.LeanLaunch(
    "ring_resize", "ring_resize_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def ring_layout(ring: Dict[str, torch.Tensor], new_b: int, device
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, list]:
    """The new ring's fields ``[W, N, new_b(, width)]`` as contiguous
    views of one uninitialised int32 buffer on ``device``, each starting
    on a 16-byte boundary (a multiple of 4 int32), and the int32 ``[1]``
    flag after them. Returns ``(fields, flag, widths)``, ``widths`` the
    int32 a lane of each field, in the ring's order."""
    w, n = ring["op"].shape[:2]
    widths, views, at = [], [], 0
    for x in ring.values():
        rest = tuple(x.shape[3:])
        width = math.prod(rest)
        lane = new_b * width
        widths.append(width)
        inner = tuple(math.prod(rest[i + 1:]) for i in range(len(rest)))
        views.append(((w, n, new_b) + rest, (n * lane, lane, width) + inner,
                      at))
        at += w * n * lane
        at += -at % 4
    buf = torch.empty(at + 1, dtype=torch.int32, device=device)
    # one strided view a field (cheaper on the host than split and view)
    out = {f: buf.as_strided(*v) for f, v in zip(ring, views)}
    return out, buf.as_strided((1,), (1,), at), widths


def ring_resize_plain(ring: Dict[str, torch.Tensor], new_b: int
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain PyTorch version: each field zero-filled at the new width and
    its kept lanes copied, in the kernel's layout (``ring_layout``); the
    flag is 1 where a lane of ``op`` past ``new_b`` is live. Arguments
    and result as for ``ring_resize``."""
    out, flag, _ = ring_layout(ring, new_b, ring["op"].device)
    for f, x in ring.items():
        y = out[f]
        y.zero_()
        keep = min(new_b, x.shape[2])
        y[:, :, :keep] = x[:, :, :keep]
    flag.copy_((ring["op"][:, :, new_b:] != OP_NOOP).any().reshape(1))
    return out, flag


def ring_resize(ring: Dict[str, torch.Tensor], new_b: int
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``ring``: int32 fields ``[W, N, B]`` or ``[W, N, B, width]``, one of
    them ``op``. Returns ``(new ring, flag)``: fresh fields ``[W, N,
    new_b(, width)]`` holding the first ``min(B, new_b)`` lanes of each
    field and zeros past them, and an int32 ``[1]`` flag, 1 when a lane of
    ``op`` at or past ``new_b`` is not OP_NOOP (0 on a grow). The ring
    given is not changed. The new fields and the flag are views of one
    buffer (``ring_layout``)."""
    new_b = int(new_b)
    if "op" not in ring or new_b < 1:
        raise ValueError("ring_resize: the ring needs an op field and "
                         "new_b >= 1")
    lead = tuple(ring["op"].shape)
    if len(lead) != 3:
        raise ValueError(f"ring_resize: op has shape {lead}, expected "
                         f"[W, N, B]")
    dev = operands.lean_placement("ring_resize", [
        (f"ring.{f}", x, torch.int32, lead + tuple(x.shape[3:]))
        for f, x in ring.items()])
    if dev is None:
        return ring_resize_plain(ring, new_b)
    k = len(ring)
    if k > MAX_FIELDS:
        raise ValueError(f"ring_resize: {k} ring fields, at most "
                         f"{MAX_FIELDS}")
    out, flag, widths = ring_layout(ring, new_b, dev)
    table = (ctypes.c_longlong * (3 * k))(
        *(x.data_ptr() for x in ring.values()),
        *(x.data_ptr() for x in out.values()), *widths)
    _LAUNCH(dev, table, k, lead[0] * lead[1], lead[2], new_b,
            list(ring).index("op"), flag.data_ptr())
    ring_resize.launches += 1
    return out, flag


ring_resize.launches = 0

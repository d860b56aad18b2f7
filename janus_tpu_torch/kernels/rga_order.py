"""``rga_order``: the RGA's linearization of slot rows, the path-key sort
(kernel source: csrc/rga_order.cu).

Replaces janus_tpu/models/rga.py ``_order_row``: per row, the document
order of its slots (valid elements in depth-first order, siblings by
descending id, invalid slots at the tail), each slot's depth and the
row's depth-overflow flag. See the source note for the rules the kernel
keeps (first-match parents, dangling references at the root, chains cut at
``depth`` links, int32 wrapping keys).

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``rga_order_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.rga_rows import slot_operands
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order

# the fields the linearization reads, in the C entry point's order
ORDER_FIELDS = ("id_ctr", "id_rep", "par_ctr", "par_rep", "valid")
# rows per chunk of the plain version's [n, C, C] parent compare
_PLAIN_ELEMS = 1 << 24


def _order_rows(row, depth: int):
    """The JAX function on ``[n, C]`` rows at once."""
    n, C = row["id_ctr"].shape
    dev = row["id_ctr"].device
    valid = row["valid"]
    pmat = ((row["par_ctr"][:, :, None] == row["id_ctr"][:, None, :])
            & (row["par_rep"][:, :, None] == row["id_rep"][:, None, :])
            & valid[:, None, :])
    first = torch.argmax(pmat.to(torch.int8), dim=-1)
    par_idx = torch.where(valid & pmat.any(-1), first, C)
    par_ext = torch.cat([par_idx, torch.full((n, 1), C, device=dev)], -1)
    chain = [torch.arange(C, device=dev).expand(n, C)]
    for _ in range(1, depth):
        chain.append(par_ext.gather(-1, chain[-1]))
    chain = torch.stack(chain, -1)                           # [n, C, D]
    depth_of = (chain < C).sum(-1).to(torch.int32)
    last = chain[..., depth - 1]
    overflow = (valid & (last < C) & (par_ext.gather(-1, last) < C)).any(-1)
    d_idx = (depth_of[..., None] - 1
             - torch.arange(depth, device=dev))              # [n, C, D]
    anc = chain.gather(-1, d_idx.clamp(0, depth - 1).long())
    real = (d_idx >= 0) & (anc < C)
    anc_c = anc.clamp(0, C - 1).reshape(n, -1)
    big = torch.tensor(SENTINEL, dtype=torch.int32, device=dev)
    ids = {f: row[f].gather(-1, anc_c).view(n, C, depth)
           for f in ("id_ctr", "id_rep")}
    kc = torch.where(real, big - ids["id_ctr"], -1)
    kr = torch.where(real, big - ids["id_rep"], -1)
    kc = torch.where(valid[..., None], kc, big)
    kr = torch.where(valid[..., None], kr, big)
    keys = []
    for d in range(depth):
        keys += [kc[..., d], kr[..., d]]
    order = lex_order(keys).to(torch.int32)
    return order, depth_of, overflow


def rga_order_plain(rows, depth: int):
    """Plain PyTorch version: the JAX function (a ``[C, C]`` parent
    compare, ``depth`` parent steps, a stable sort on ``2 * depth`` keys)
    over ``[N, C]`` rows in chunks. Returns ``(order int32 [N, C],
    depth_of int32 [N, C], overflow bool [N])``."""
    N, C = rows["valid"].shape
    step = max(1, _PLAIN_ELEMS // max(1, C * C))
    parts = [_order_rows({f: rows[f][i:i + step] for f in ORDER_FIELDS}, depth)
             for i in range(0, N, step)]
    if not parts:
        dev = rows["valid"].device
        return (torch.zeros((0, C), dtype=torch.int32, device=dev),
                torch.zeros((0, C), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    return tuple(torch.cat(x) for x in zip(*parts))


def _lib():
    lib = build.load("rga_order")
    if lib.rga_order_launch.argtypes is None:
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        lib.rga_order_launch.argtypes = [arr, ptr, ptr, ptr, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int, ptr]
        lib.rga_order_launch.restype = ctypes.c_int
    return lib


def shared_bytes(c: int, depth: int) -> int:
    """Shared memory of one block (csrc/rga_order.cu): per slot a 16-byte
    sort record, six int32 words, ``depth`` ancestor words and a valid
    byte; and the prefix counts' words."""
    return c * (16 + 24 + 4 * depth + 1) + 256


def rga_order(rows, depth: int):
    """Document order of every ``[C]`` row of ``rows`` (``id_ctr``,
    ``id_rep``, ``par_ctr``, ``par_rep``, ``valid``; ``[N, C]``) resolved
    to ``depth`` >= 1 ancestor levels. Returns ``(order int32 [N, C],
    depth_of int32 [N, C], overflow bool [N])``: slot indices in document
    order (invalid slots last), each slot's chain length, and whether some
    valid slot's chain was cut at ``depth``."""
    if rows["valid"].dim() != 2 or depth < 1:
        raise ValueError("rga_order: rows must be [N, C] and depth >= 1")
    N, C = rows["valid"].shape
    dev = operands.placement(
        "rga_order", slot_operands("rows.", rows, (N, C), ORDER_FIELDS))
    if dev is None:
        return rga_order_plain(rows, depth)
    operands.check_shared("rga_order", shared_bytes(C, depth))
    order = torch.empty((N, C), dtype=torch.int32, device=dev)
    depth_of = torch.empty((N, C), dtype=torch.int32, device=dev)
    overflow = torch.empty((N,), dtype=torch.bool, device=dev)
    if math.prod((N, C)) == 0:
        return order, depth_of, overflow.zero_()
    lib = _lib()
    src = (ctypes.c_void_p * 5)(*(rows[f].data_ptr() for f in ORDER_FIELDS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rga_order_launch(src, order.data_ptr(), depth_of.data_ptr(),
                                  overflow.data_ptr(), N, C, depth, stream)
    build.check_launch("rga_order", rc)
    rga_order.launches += 1
    return order, depth_of, overflow


rga_order.launches = 0

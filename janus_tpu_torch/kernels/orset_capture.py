"""``orset_capture``: batched effect capture of OR-Set remove/clear ops
(kernel source: csrc/orset_capture.cu).

Replaces janus_tpu/models/orset.py ``prepare_ops_batch`` (vmapped over the
views). A remove (elem-matched) or clear at lane i captures the tags it
observes: the selected tags of the pre-batch row, in row order, and the
matching adds of earlier lanes of the same raw key, in tag order (an add
counts only if its ``a1`` is not SENTINEL); the first ``r_cap`` of each,
merged stably by tag, cut to ``r_cap``. Other lanes capture nothing
(SENTINEL tags, elem 0). Rows are gathered at the op's key by JAX's gather
rule; the same-key match compares raw keys.

The wrapper launches the CUDA kernel for CUDA tensors (or raises) and runs
``orset_capture_plain`` only for tensors that lie on the CPU. Both return
new tensors. One call of the kernel is four CUDA launches (count, place
and order the adds by bucket, then capture) on scratch the wrapper
allocates; it counts once on ``orset_capture.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.orset_rows import (
    OP_ADD, OP_CLEAR, OP_REMOVE, op_operands, slot_operands)
from janus_tpu_torch.models.base import gather_index
from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order

# elements of the match mask the plain version builds at once
_PLAIN_MASK_ELEMS = 1 << 24


def orset_capture_plain(state, ops, r_cap: int):
    """Plain PyTorch version: the JAX function's three stages with the
    view axis as a batch dimension; stage 2's [B, B] mask keeps only the
    rows and columns it can select (reading the counts on the host). ``state``: ``[V, K, C]`` fields; op fields
    ``[V, B]``. Returns ``(rm_rep, rm_ctr, rm_elem)``, int32
    ``[V, B, r_cap]``."""
    V, K, C = state["valid"].shape
    B = ops["op"].shape[-1]
    key = ops["key"]
    gi = gather_index(key, K)[..., None].expand(V, B, C)
    rows = {f: state[f].gather(1, gi) for f in
            ("valid", "elem", "tag_rep", "tag_ctr")}
    is_rm = ops["op"] == OP_REMOVE
    is_cl = ops["op"] == OP_CLEAR
    is_tomb = is_rm | is_cl
    a0 = ops["a0"]

    # stage 1: state capture, selected tags first in row order
    sel = (rows["valid"] & is_tomb[..., None]
           & torch.where(is_rm[..., None], rows["elem"] == a0[..., None], True))
    order = torch.sort((~sel).to(torch.int32), dim=-1, stable=True).indices
    st = [torch.where(sel, rows["tag_rep"], SENTINEL),
          torch.where(sel, rows["tag_ctr"], SENTINEL),
          torch.where(sel, rows["elem"], 0)]
    st = [x.gather(-1, order)[..., :r_cap] for x in st]

    # stage 2: the adds ordered by tag once, then each remove/clear lane's
    # first r_cap matching adds. The mask has a row per remove/clear lane
    # and a column per valid add (they sort first: an invalid add's tag is
    # SENTINEL), built a chunk of rows at a time; its first r_cap hits per
    # row are the cumulative-count ranks below r_cap.
    lanes = torch.arange(B, dtype=torch.int32, device=key.device)
    is_add = ops["op"] == OP_ADD
    s_rep = torch.where(is_add, ops["a1"], SENTINEL)
    s_ctr = torch.where(is_add, ops["a2"], SENTINEL)
    so = lex_order([s_rep, s_ctr])
    s_rep, s_ctr, s_key, s_a0 = (x.gather(-1, so) for x in (s_rep, s_ctr, key, a0))
    s_lane = lanes.expand(V, B).gather(-1, so)
    n_valid = (s_rep != SENTINEL).sum(-1).tolist()
    ba = [torch.full((V, B, r_cap), SENTINEL, dtype=torch.int32, device=key.device),
          torch.full((V, B, r_cap), SENTINEL, dtype=torch.int32, device=key.device),
          torch.zeros((V, B, r_cap), dtype=torch.int32, device=key.device)]
    for v in range(V if r_cap else 0):
        na = n_valid[v]
        tomb = torch.nonzero(is_tomb[v]).flatten()
        step = max(1, _PLAIN_MASK_ELEMS // max(1, na))
        for i0 in range(0, tomb.numel() if na else 0, step):
            rows = tomb[i0:i0 + step]
            mask = ((s_lane[v, None, :na] < rows[:, None])
                    & (s_key[v, None, :na] == key[v, rows, None])
                    & torch.where(is_rm[v, rows, None],
                                  s_a0[v, None, :na] == a0[v, rows, None], True))
            rank = torch.cumsum(mask.to(torch.int32), -1) - 1
            ii, jj = torch.nonzero(mask & (rank < r_cap), as_tuple=True)
            slot = rank[ii, jj].long()
            for out, src in zip(ba, (s_rep, s_ctr, s_a0)):
                out[v, rows[ii], slot] = src[v, jj]

    # stage 3: union of the two prefixes, tag-sorted, cut
    m = [torch.cat([x, y], -1) for x, y in zip(st, ba)]
    o3 = lex_order(m[:2])
    return tuple(x.gather(-1, o3)[..., :r_cap].contiguous() for x in m)


def _lib():
    lib = build.load("orset_capture")
    if lib.orset_capture_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.orset_capture_launch.argtypes = [ptr] * 13 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.orset_capture_launch.restype = ctypes.c_int
        lib.orset_capture_scratch_ints.argtypes = [ctypes.c_int] * 3
        lib.orset_capture_scratch_ints.restype = ctypes.c_longlong
    return lib


# the kernel holds a lane's prefixes one entry a thread of a warp
MAX_RCAP = 32
# the adds are bucketed by the row their key gathers, modulo this many
# buckets a view (csrc/orset_capture.cu MAX_BUCKETS)
MAX_BUCKETS = 1024


def orset_capture(state, ops, r_cap: int):
    """Captured tags of every remove/clear lane: ``(rm_rep, rm_ctr,
    rm_elem)``, int32 ``[V, B, r_cap]``. ``state``: the five slot fields
    ``[V, K, C]``; op fields int32 ``[V, B]``."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("orset_capture: state must be [V, K, C] and op "
                         "fields [V, B]")
    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    dev = operands.placement("orset_capture", [
        *slot_operands("state.", state, (V, K, C)), *op_operands(ops, (V, B))])
    if dev is None:
        return orset_capture_plain(state, ops, r_cap)
    if K == 0 and V * B > 0:
        raise ValueError("orset_capture: no key rows to gather from")
    if r_cap > MAX_RCAP:
        raise ValueError(f"orset_capture: capture width {r_cap} > {MAX_RCAP}, "
                         f"the most the CUDA kernel takes")
    out = [torch.empty((V, B, r_cap), dtype=torch.int32, device=dev)
           for _ in range(3)]
    if V * B * r_cap == 0:
        return tuple(out)
    lib = _lib()
    scratch = torch.empty((lib.orset_capture_scratch_ints(V, B, K),),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.orset_capture_launch(
            *(ops[f].data_ptr() for f in ("op", "key", "a0", "a1", "a2")),
            *(state[f].data_ptr() for f in ("tag_rep", "tag_ctr", "elem",
                                            "valid")),
            *(x.data_ptr() for x in out), scratch.data_ptr(),
            V, B, K, C, r_cap, stream)
    build.check_launch("orset_capture", rc)
    orset_capture.launches += 1
    return tuple(out)


orset_capture.launches = 0

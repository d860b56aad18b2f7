"""``state_transfer``: SafeKV's crash/lag recovery, in place (kernel
source: csrc/state_transfer.cu).

Replaces janus_tpu/runtime/safecrdt.py ``SafeKV._state_transfer``. A view
needs a transfer when it is below the GC frontier, when its commit cursor
lags the quorum-th best ``last_wave`` by more than ``max(2, W // 4)``, or
when ``force`` says so; every such view adopts the row of the donor (the
first argmax of ``last_wave``) in every leaf it is given. JAX returns new
leaves; here the leaves are updated in place, and a view that needs no
transfer keeps its rows untouched, as does the donor (its own copy is the
identity).

One call is two CUDA launches (the decision, the copy) and adds one to
``state_transfer.launches``; the copy's blocks return at once when no view
needs a transfer, and the decision is never read on the host. For CUDA
tensors the wrapper launches the kernels (or raises);
``state_transfer_plain`` runs only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands

MAX_LEAVES = 48


def lag_window(cfg) -> int:
    """Rounds a commit cursor may lag the quorum before a transfer."""
    return max(2, cfg.num_rounds // 4)


def state_transfer_plain(cfg, leaves, node_round, base_round, last_wave,
                         force):
    """Plain PyTorch version: returns ``(need bool[N], donor int32[])`` and
    sets every needy view's row of each leaf to the donor's, in place."""
    lw_q = torch.sort(last_wave).values[cfg.num_nodes - cfg.quorum]
    need = ((node_round < base_round)
            | (last_wave < lw_q - lag_window(cfg))
            | force)  # [N]
    donor = torch.argmax(last_wave).to(torch.int32)
    take = donor.long().reshape(1)
    for x in leaves:
        if x.numel():
            mask = need.reshape((-1,) + (1,) * (x.dim() - 1))
            x.copy_(torch.where(mask, x.index_select(0, take), x))
    return need, donor


def _lib():
    lib = build.load("state_transfer")
    if lib.state_transfer_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.state_transfer_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.state_transfer_launch.restype = ctypes.c_int
    return lib


def state_transfer(cfg, leaves, node_round, base_round, last_wave, force):
    """Decide and copy: ``(need bool[N], donor int32[])``. ``leaves``:
    tensors whose leading axis is the N views (every state leaf a transfer
    adopts; ``node_round`` and ``last_wave`` among them, read before any
    is copied); ``node_round``, ``last_wave`` int32[N]; ``base_round``
    int32[]; ``force`` bool[N]."""
    n = cfg.num_nodes
    i32 = torch.int32
    leaves = list(leaves)
    dev = operands.placement("state_transfer", [
        ("node_round", node_round, i32, (n,)),
        ("base_round", base_round, i32, ()),
        ("last_wave", last_wave, i32, (n,)),
        ("force", force, torch.bool, (n,)),
        *((f"leaf {i}", x, x.dtype, (n,) + tuple(x.shape[1:]))
          for i, x in enumerate(leaves))])
    if dev is None:
        return state_transfer_plain(cfg, leaves, node_round, base_round,
                                    last_wave, force)
    operands.check_fits("state_transfer", n, 0)
    table = [x for x in leaves if x.numel()]  # zero-size leaves: nothing to copy
    if len(table) > MAX_LEAVES:
        raise ValueError(f"state_transfer: {len(table)} leaves, at most "
                         f"{MAX_LEAVES}")
    need = torch.empty((n,), dtype=torch.bool, device=dev)
    donor = torch.empty((), dtype=i32, device=dev)
    ptrs = (ctypes.c_void_p * max(1, len(table)))(*(x.data_ptr() for x in table))
    rows = (ctypes.c_longlong * max(1, len(table)))(
        *(x[0].numel() * x.element_size() for x in table))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.state_transfer_launch(
            last_wave.data_ptr(), node_round.data_ptr(), base_round.data_ptr(),
            force.data_ptr(), need.data_ptr(), donor.data_ptr(), ptrs, rows,
            len(table), n, cfg.quorum, lag_window(cfg), stream)
    build.check_launch("state_transfer", rc)
    state_transfer.launches += 1
    return need, donor


state_transfer.launches = 0

"""``safekv_submit``: SafeKV's submit around the type's capture, as two
entry points of one source (kernel source: csrc/safekv_submit.cu).

Replaces janus_tpu/runtime/safecrdt.py ``SafeKV._submit_device`` but for
the type's capture and origin apply, which run between the two:

- ``safekv_submit`` (accept): ``accepted[N]`` (block not yet made, slot
  not yet buffered, ``base <= r < base + W``, ``active``), the op batch
  with rejected views' lanes zeroed, in a separate ``[N, B]`` buffer (the
  caller's batch is never written), and a copy of ``node_round``.
- ``safekv_board``: every field of the captured batch into ring row
  ``[slot_of(r_v), v]`` of each accepted view, in place, with
  ``buffer_filled[s, v]`` and ``prosp_applied[v, s, v]`` set.

Each entry point is one launch and adds one to ``safekv_submit.launches``.
For CUDA tensors the wrapper launches its kernel (or raises); the
``*_plain`` version runs only for tensors that lie on the CPU. Board
updates the ring and both masks in place, unlike JAX's pure function.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.dag_phases import slot_of
from janus_tpu_torch.models.base import OP_FIELDS

MAX_FIELDS = 16


def safekv_submit_plain(cfg, dag_state, buffer_filled, ops, active=None):
    """Plain PyTorch version of the accept entry point: returns
    ``(accepted ops {field: int32[N, B]}, accepted bool[N], pre_round
    int32[N])``."""
    n = cfg.num_nodes
    vs = torch.arange(n, device=buffer_filled.device)
    r = dag_state["node_round"]  # the round the next block will occupy
    s = slot_of(cfg, r)
    base_r = dag_state["base_round"]
    # reject ops for sealed slots: block exists, batch already buffered,
    # straggler below the frontier, or GC window full
    accepted = (~dag_state["block_exists"][s, vs]
                & ~buffer_filled[s, vs]
                & (r >= base_r)
                & (r < base_r + cfg.num_rounds))
    if active is not None:
        accepted = accepted & active  # crashed nodes accept no ops
    acc_ops = {f: torch.where(accepted[:, None], ops[f], 0) for f in OP_FIELDS}
    return acc_ops, accepted, dag_state["node_round"].clone()


def safekv_board_plain(cfg, ops_buffer, buffer_filled, prosp_applied, acc_ops,
                       accepted, pre_round) -> None:
    """Plain PyTorch version of the board entry point, in place: ring row
    ``[slot_of(pre_round[v]), v]`` of every field takes the captured batch
    of each accepted view; ``buffer_filled[s, v]`` and
    ``prosp_applied[v, s, v]`` are set for them."""
    n = cfg.num_nodes
    vs = torch.arange(n, device=accepted.device)
    s = slot_of(cfg, pre_round).long()
    for f, buf in ops_buffer.items():
        acc = accepted.reshape((n,) + (1,) * (acc_ops[f].dim() - 1))
        buf[s, vs] = torch.where(acc, acc_ops[f], buf[s, vs])
    buffer_filled[s, vs] = buffer_filled[s, vs] | accepted
    prosp_applied[vs, s, vs] = prosp_applied[vs, s, vs] | accepted


def _lib():
    lib = build.load("safekv_submit")
    if lib.safekv_accept_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.safekv_accept_launch.argtypes = [ptr, ptr, i32] + [ptr] * 7 + [
            i32, i32, ctypes.c_longlong, ptr]
        lib.safekv_accept_launch.restype = ctypes.c_int
        lib.safekv_board_launch.argtypes = [ptr, ptr, ptr, i32] + [ptr] * 4 + [
            i32, i32, ptr]
        lib.safekv_board_launch.restype = ctypes.c_int
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *(t.data_ptr() for t in tensors))


def safekv_submit(cfg, dag_state, buffer_filled, ops, active=None):
    """Accept entry point: ``(accepted ops {field: int32[N, B]}, accepted
    bool[N], pre_round int32[N])``. ``dag_state``: block_exists bool[W, N],
    node_round int32[N], base_round int32[]; ``buffer_filled`` bool[W, N];
    ``ops`` int32[N, B] per op field; ``active`` bool[N] or None."""
    n, w = cfg.num_nodes, cfg.num_rounds
    b = ops["op"].shape[-1] if ops["op"].dim() == 2 else -1
    bl, i32 = torch.bool, torch.int32
    dev = operands.placement("safekv_submit", [
        ("block_exists", dag_state["block_exists"], bl, (w, n)),
        ("buffer_filled", buffer_filled, bl, (w, n)),
        ("node_round", dag_state["node_round"], i32, (n,)),
        ("base_round", dag_state["base_round"], i32, ()),
        ("active", active, bl, (n,)),
        *((f"ops.{f}", ops[f], i32, (n, b)) for f in OP_FIELDS)])
    if dev is None:
        return safekv_submit_plain(cfg, dag_state, buffer_filled, ops, active)
    acc_ops = {f: torch.empty((n, b), dtype=i32, device=dev) for f in OP_FIELDS}
    accepted = torch.empty((n,), dtype=bl, device=dev)
    pre_round = torch.empty((n,), dtype=i32, device=dev)
    src = _pointers([ops[f] for f in OP_FIELDS])
    dst = _pointers([acc_ops[f] for f in OP_FIELDS])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.safekv_accept_launch(
            src, dst, len(OP_FIELDS), dag_state["block_exists"].data_ptr(),
            buffer_filled.data_ptr(), dag_state["node_round"].data_ptr(),
            dag_state["base_round"].data_ptr(),
            None if active is None else active.data_ptr(),
            accepted.data_ptr(), pre_round.data_ptr(), n, w, b, stream)
    build.check_launch("safekv_submit", rc)
    safekv_submit.launches += 1
    return acc_ops, accepted, pre_round


def safekv_board(cfg, ops_buffer, buffer_filled, prosp_applied, acc_ops,
                 accepted, pre_round) -> None:
    """Board entry point, in place. ``ops_buffer``: ring fields int32
    ``[W, N, B, ...]``; ``acc_ops``: the captured batch, int32 ``[N, B,
    ...]`` for every ring field; ``buffer_filled`` bool[W, N];
    ``prosp_applied`` bool[N, W, N]; ``accepted`` bool[N]; ``pre_round``
    int32[N]."""
    n, w = cfg.num_nodes, cfg.num_rounds
    names = list(ops_buffer)
    if len(names) > MAX_FIELDS:
        raise ValueError(f"safekv_board: {len(names)} ring fields, at most "
                         f"{MAX_FIELDS}")
    bl, i32 = torch.bool, torch.int32
    dev = operands.placement("safekv_board", [
        ("buffer_filled", buffer_filled, bl, (w, n)),
        ("prosp_applied", prosp_applied, bl, (n, w, n)),
        ("accepted", accepted, bl, (n,)), ("pre_round", pre_round, i32, (n,)),
        *((f"ops_buffer.{f}", ops_buffer[f], i32,
           (w, n) + tuple(ops_buffer[f].shape[2:])) for f in names),
        *((f"acc_ops.{f}", acc_ops[f], i32,
           (n,) + tuple(ops_buffer[f].shape[2:])) for f in names)])
    if dev is None:
        safekv_board_plain(cfg, ops_buffer, buffer_filled, prosp_applied,
                           acc_ops, accepted, pre_round)
        return
    rows = (ctypes.c_longlong * max(1, len(names)))(
        *(acc_ops[f][0].numel() if n else 0 for f in names))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.safekv_board_launch(
            _pointers([acc_ops[f] for f in names]),
            _pointers([ops_buffer[f] for f in names]), rows, len(names),
            accepted.data_ptr(), pre_round.data_ptr(),
            buffer_filled.data_ptr(), prosp_applied.data_ptr(), n, w, stream)
    build.check_launch("safekv_board", rc)
    safekv_submit.launches += 1


safekv_submit.launches = 0

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

Each entry point is one launch on the lean launch path
(``operands.lean_placement``, ``build.LeanLaunch``) and adds one to
``safekv_submit.launches``; the accept's outputs are views of one
buffer, and the ring's table is cached on its fields' addresses. For
CUDA tensors the wrapper launches its kernel (or raises); the
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


_ptr, _int = ctypes.c_void_p, ctypes.c_int
_TABLE = ctypes.POINTER(ctypes.c_longlong)
_ACCEPT = build.LeanLaunch(
    "safekv_submit", "safekv_accept_launch",
    [_TABLE, _int, _ptr, ctypes.c_longlong] + [_ptr] * 7 + [_int] * 3)
_BOARD = build.LeanLaunch("safekv_submit", "safekv_board_launch",
                          [_TABLE, _TABLE, _int] + [_ptr] * 4 + [_int] * 2)
# the batch fields' addresses, refilled by each call
_SOURCES = (ctypes.c_longlong * MAX_FIELDS)()
# (N, W, B) -> the accept's operand shapes and its buffer's layout
_LAYOUTS: dict = {}


def _layout(n: int, w: int, b: int) -> tuple:
    """``((W, N), (N,), (), (N, B), field stride, accepted's byte
    offset, words)``: the accept's buffer holds ``pre_round`` int32[N],
    then each op field's accepted ops int32[N, B], then ``accepted``
    bool[N], every part 16-byte aligned."""
    held = _LAYOUTS.get((n, w, b))
    if held is None:
        words = operands.int32s
        stride = words(n * b)
        fields_at = words(n)
        acc_at = 4 * (fields_at + len(OP_FIELDS) * stride)
        held = _LAYOUTS[(n, w, b)] = (
            (w, n), (n,), (), (n, b), stride, fields_at, acc_at,
            acc_at // 4 + words(-(-n // 4)))
    return held


def safekv_submit(cfg, dag_state, buffer_filled, ops, active=None):
    """Accept entry point: ``(accepted ops {field: int32[N, B]}, accepted
    bool[N], pre_round int32[N])``. ``dag_state``: block_exists bool[W, N],
    node_round int32[N], base_round int32[]; ``buffer_filled`` bool[W, N];
    ``ops`` int32[N, B] per op field; ``active`` bool[N] or None. On the
    card the outputs are views of one buffer."""
    n, w = cfg.num_nodes, cfg.num_rounds
    b = ops["op"].shape[-1] if ops["op"].dim() == 2 else -1
    bl, i32 = torch.bool, torch.int32
    wn, vec_n, scalar, nb, stride, fields_at, acc_at, total = _layout(n, w, b)
    dev = operands.lean_placement("safekv_submit", [
        ("block_exists", dag_state["block_exists"], bl, wn),
        ("buffer_filled", buffer_filled, bl, wn),
        ("node_round", dag_state["node_round"], i32, vec_n),
        ("base_round", dag_state["base_round"], i32, scalar),
        ("active", active, bl, vec_n),
        *((f"ops.{f}", ops[f], i32, nb) for f in OP_FIELDS)])
    if dev is None:
        return safekv_submit_plain(cfg, dag_state, buffer_filled, ops, active)
    buf = torch.empty(total, dtype=i32, device=dev)
    base = buf.data_ptr()
    src = _SOURCES
    src[:len(OP_FIELDS)] = [ops[f].data_ptr() for f in OP_FIELDS]
    _ACCEPT(dev, src, len(OP_FIELDS), base + 4 * fields_at, stride,
            dag_state["block_exists"].data_ptr(), buffer_filled.data_ptr(),
            dag_state["node_round"].data_ptr(),
            dag_state["base_round"].data_ptr(),
            None if active is None else active.data_ptr(), base + acc_at,
            base, n, w, b)
    safekv_submit.launches += 1
    view = buf.as_strided
    acc_ops = {f: view(nb, (b, 1), fields_at + k * stride)
               for k, f in enumerate(OP_FIELDS)}
    accepted = buf.view(bl).as_strided(vec_n, (1,), acc_at)
    return acc_ops, accepted, view(vec_n, (1,), 0)


def safekv_board(cfg, ops_buffer, buffer_filled, prosp_applied, acc_ops,
                 accepted, pre_round) -> None:
    """Board entry point, in place. ``ops_buffer``: ring fields int32
    ``[W, N, B, ...]``; ``acc_ops``: the captured batch, int32 ``[N, B,
    ...]`` for every ring field; ``buffer_filled`` bool[W, N];
    ``prosp_applied`` bool[N, W, N]; ``accepted`` bool[N]; ``pre_round``
    int32[N]."""
    n, w = cfg.num_nodes, cfg.num_rounds
    if len(ops_buffer) > MAX_FIELDS:
        raise ValueError(f"safekv_board: {len(ops_buffer)} ring fields, at "
                         f"most {MAX_FIELDS}")
    bl, i32 = torch.bool, torch.int32
    dev = operands.lean_placement("safekv_board", [
        ("buffer_filled", buffer_filled, bl, (w, n)),
        ("prosp_applied", prosp_applied, bl, (n, w, n)),
        ("accepted", accepted, bl, (n,)), ("pre_round", pre_round, i32, (n,)),
        *((f"ops_buffer.{f}", x, i32, (w, n) + x.shape[2:])
          for f, x in ops_buffer.items()),
        *((f"acc_ops.{f}", acc_ops[f], i32, (n,) + x.shape[2:])
          for f, x in ops_buffer.items())])
    if dev is None:
        safekv_board_plain(cfg, ops_buffer, buffer_filled, prosp_applied,
                           acc_ops, accepted, pre_round)
        return
    src = _SOURCES
    src[:len(ops_buffer)] = [acc_ops[f].data_ptr() for f in ops_buffer]
    _BOARD(dev, src, operands.ring_table(ops_buffer), len(ops_buffer),
           accepted.data_ptr(), pre_round.data_ptr(), buffer_filled.data_ptr(),
           prosp_applied.data_ptr(), n, w)
    safekv_submit.launches += 1


safekv_submit.launches = 0

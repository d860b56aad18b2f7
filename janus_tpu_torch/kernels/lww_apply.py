"""``lww_apply``: the LWW-Set's sequential apply of add/remove ops, per
view, in place; ``lww_capture``: its capture mode (kernel source:
csrc/lww_apply.cu).

Replaces the ``lax.scan`` of janus_tpu/models/lwwset.py
``_apply_ops_impl`` (vmapped over the views) with
janus_tpu/ops/setops.py ``row_upsert``, uncaptured and captured (an
``ok`` flag per op), and, as ``lww_capture``, the sequential capture of
janus_tpu/models/base.py ``capture_and_apply`` with
janus_tpu/models/lwwset.py ``prepare_ops``. Ops apply in lane order, each
to the row of its key (gathered by JAX's gather rule, written back by its
scatter rule, so an op whose key is out of range after negative
normalisation changes nothing but may count a drop):

- add (a0=elem, (a1, a2)=the stamp): an upsert of elem with add stamp
  (a1, a2) and remove stamp (0, 0), folded into an existing slot by the
  per-polarity timestamp max;
- remove (the same arguments): an upsert with add stamp (0, 0) and remove
  stamp (a1, a2), gated on the elem being contained in the row
  (uncaptured, and in the capture mode, which records the gate as the
  lane's ``ok``) or on the op's ``ok`` (captured);
- an enabled upsert of an absent elem into a full row counts one drop.

The kernel groups the live lanes by (view, row) first, so no warp reads
a lane of another row, then walks many rows a warp from registers
(csrc/lww_apply.cu). One call is two CUDA launches on the lean launch
path (``operands.lean_placement``, ``build.LeanLaunch``), the groups'
scratch cached per device and stream, and adds one to its wrapper's
count.
The wrappers launch the kernel for CUDA tensors (or raise) and run the
plain versions only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.lww_rows import (
    FIELDS, KEY_FIELDS, OP_ADD, OP_FIELDS, OP_REMOVE, fold_duplicate,
    slot_live, slot_operands)
from janus_tpu_torch.kernels.lane_buckets import (
    bucket_records, forget_scratch, row_waves, scratch)
from janus_tpu_torch.models.base import gather_index, scatter_index
from janus_tpu_torch.ops.setops import row_upsert


def _walk_plain(state, ops, ok_out=None) -> torch.Tensor:
    """The JAX scan in PyTorch, in place. A lane reads and writes only the
    row it gathers, so lanes on different rows commute: the live lanes
    run in waves (``kernels.lane_buckets.row_waves``), each wave one batched step
    over distinct rows, each row's lanes in lane order. ``ok_out`` (int32 ``[V, B, 1]``,
    ones) receives each remove lane's containment. Returns the drops per
    view."""
    V, K, C = state["valid"].shape
    dev = state["valid"].device
    gi = gather_index(ops["key"], K)
    wi, wok = scatter_index(ops["key"], K)
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    live = (ops["op"] == OP_ADD) | (ops["op"] == OP_REMOVE)
    for v, b in row_waves(live, gi, K):
        op, e, hi, lo = (ops[f][v, b] for f in ("op", "a0", "a1", "a2"))
        is_add, is_rm = op == OP_ADD, op == OP_REMOVE
        zero = torch.zeros_like(hi)
        row = {f: state[f][v, gi[v, b]] for f in FIELDS}         # [M, C]
        hit = row["valid"] & (row["elem"] == e[:, None])
        contained = slot_live(hit, row["add_hi"], row["add_lo"],
                              row["rm_hi"], row["rm_lo"]).any(-1)
        if ok_out is not None:
            ok_out[v[is_rm], b[is_rm], 0] = contained[is_rm].to(torch.int32)
        gate = ops["ok"][v, b, 0] != 0 if "ok" in ops else contained
        stats = {"slots_dropped": torch.zeros_like(hi)}
        added = row_upsert(
            row, KEY_FIELDS, (e,),
            {"add_hi": hi, "add_lo": lo, "rm_hi": zero, "rm_lo": zero},
            fold_duplicate, enabled=is_add, stats=stats)
        removed = row_upsert(
            row, KEY_FIELDS, (e,),
            {"add_hi": zero, "add_lo": zero, "rm_hi": hi, "rm_lo": lo},
            fold_duplicate, enabled=is_rm & gate, stats=stats)
        dropped.index_add_(0, v, stats["slots_dropped"])
        ok = wok[v, b]
        for f in FIELDS:
            new = torch.where(is_add[:, None], added[f], removed[f])
            state[f][v[ok], wi[v, b][ok]] = new[ok]
    return dropped


def lww_apply_plain(state, ops) -> torch.Tensor:
    """Plain PyTorch version of ``lww_apply``."""
    return _walk_plain(state, ops)


def lww_capture_plain(state, ops):
    """Plain PyTorch version of ``lww_capture``: returns ``(ok int32[V, B,
    1], dropped int32[V])``."""
    V, B = ops["op"].shape
    ok = torch.ones((V, B, 1), dtype=torch.int32, device=ops["op"].device)
    dropped = _walk_plain(state, {f: ops[f] for f in OP_FIELDS}, ok)
    return ok, dropped


# csrc/lww_apply.cu: the widest row and the most lanes a view the walk
# takes (its buckets: lane_buckets.bucket_records)
MAX_SLOTS = 512
MAX_LANES = 2**21

_ARGS = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p))
_DIMS = (ctypes.c_int,) * 6
_APPLY = build.LeanLaunch("lww_apply", "lww_apply_launch",
                          (*_ARGS, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_void_p), *_DIMS))
_CAPTURE = build.LeanLaunch("lww_apply", "lww_capture_launch",
                            (*_ARGS, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_void_p), *_DIMS))

def _launch(name, wrapper, state, ops, capture):
    """Check the operands, then the two launches of the walk (the capture
    mode when ``capture``). Returns ``(ok or None, drops per view)``, or
    None when the tensors lie on the CPU."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError(f"{name}: state must be [V, K, C] and op fields "
                         "[V, B]")
    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    ok = None if capture else ops.get("ok")
    dev = operands.lean_placement(name, [
        *slot_operands("state.", state, (V, K, C)),
        *[(f"op field {f!r}", ops[f], torch.int32, (V, B)) for f in OP_FIELDS],
        ("op field 'ok'", ok, torch.int32, (V, B, 1))])
    if dev is None:
        return None
    if (K == 0 or C == 0) and V * B > 0:
        raise ValueError(f"{name}: no slot rows to gather from")
    if C > MAX_SLOTS or B >= MAX_LANES or V > 65535:
        raise ValueError(f"{name}: the kernel takes rows of at most "
                         f"{MAX_SLOTS} slots, fewer than {MAX_LANES} lanes "
                         f"a view and at most 65,535 views; got C={C}, "
                         f"B={B}, V={V}")
    dropped = torch.empty((V,), dtype=torch.int32, device=dev)
    ok_out = (torch.empty((V, B, 1), dtype=torch.int32, device=dev)
              if capture else None)
    if V == 0:
        return ok_out, dropped
    cap = bucket_records(K, B)
    key, sc = scratch("lww_apply", dev, V * K, V * K * cap, V * K)
    st = (ctypes.c_void_p * 6)(*(state[f].data_ptr() for f in FIELDS))
    op = (ctypes.c_void_p * 6)(*(ops[f].data_ptr() for f in OP_FIELDS),
                               None if ok is None else ok.data_ptr())
    try:
        if capture:
            _CAPTURE(dev, st, op, ok_out.data_ptr(), dropped.data_ptr(),
                     sc.ptrs, V, K, C, B, cap, sc.parity)
        else:
            _APPLY(dev, st, op, dropped.data_ptr(), sc.ptrs, V, K, C, B, cap,
                   sc.parity)
    except RuntimeError:
        forget_scratch(key)  # the counts may not be zero any more
        raise
    sc.parity ^= 1
    wrapper.launches += 1
    return ok_out, dropped


def lww_apply(state, ops) -> torch.Tensor:
    """Apply op lanes in order to every view's rows, in place. ``state``:
    the six slot fields ``[V, K, C]`` (``lww_rows.FIELDS``); op fields
    int32 ``[V, B]``, with ``ok`` int32 ``[V, B, 1]`` for captured ops.
    Returns the drop count per view, int32 ``[V]``."""
    out = _launch("lww_apply", lww_apply, state, ops, False)
    return lww_apply_plain(state, ops) if out is None else out[1]


lww_apply.launches = 0


def lww_capture(state, ops):
    """Capture and apply uncaptured op lanes in order, in place: the
    uncaptured walk, recording each remove's containment against the row
    the earlier lanes left as its ``ok`` (1 for every other lane).
    ``state`` as for ``lww_apply``; op fields int32 ``[V, B]`` (an ``ok``
    field is ignored). Returns ``(ok int32[V, B, 1], dropped int32[V])``."""
    if state["valid"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("lww_capture: state must be [V, K, C] and op "
                         "fields [V, B]")
    out = _launch("lww_capture", lww_capture, state,
                  {f: ops[f] for f in OP_FIELDS}, True)
    return lww_capture_plain(state, ops) if out is None else out


lww_capture.launches = 0

"""``mvr_apply``: the MVRegister's sequential apply of write ops, per view,
in place; ``mvr_capture``: its capture mode (kernel source:
csrc/mvr_apply.cu).

Replaces the ``lax.scan`` of janus_tpu/models/mvregister.py
``_apply_ops_impl`` (vmapped over the views), captured and uncaptured,
and, as ``mvr_capture``, the sequential capture of
janus_tpu/models/base.py ``capture_and_apply`` with
janus_tpu/models/mvregister.py ``prepare_ops``. Writes (op 1: a0=value,
writer=writer lane) apply in lane order, each to the row of its key
(gathered by JAX's gather rule, written back by its scatter rule, so a
write whose key is out of range after negative normalisation changes
nothing but may count a drop); other op codes change nothing:

- captured (the op's ``wclock`` ``[..., W]``): the row's V entries and the
  singleton (a0, wclock) reduced to their causal frontier
  (``mvr_rows.frontier``), cut to V; the overflow counts as drops;
- uncaptured: the observed clock (the max over the row's live clocks,
  0 for an empty slot) with lane ``writer`` bumped by JAX's scatter rule
  (negative counts from the end, out of range bumps nothing), and the row
  replaced by that single value;
- capture: the observed clock with lane ``writer`` bumped only where
  ``0 <= writer < W`` (``prepare_ops``' lane compare) is the lane's
  ``wclock``; the write then applies captured.

Clock bumps wrap as int32. The kernel groups the write lanes by (view,
row) first (csrc/lane_buckets.cuh), ranks each view's rows by their write
count, and walks the rows longest walk first, each from shared memory
with the next lanes' fields in flight; one call is four CUDA launches and
adds one to its wrapper's count. The wrappers launch the kernel for CUDA
tensors (or raise) and run the plain versions only for tensors that lie
on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.mvr_rows import (
    FIELDS, OP_FIELDS, OP_WRITE, frontier, slot_operands, wrap_add_one)
from janus_tpu_torch.kernels.lane_buckets import row_waves
from janus_tpu_torch.models.base import gather_index, scatter_index
from janus_tpu_torch.ops.lattice import SENTINEL

# lane indices one window of a row's lanes holds (csrc/mvr_apply.cu WCAP)
WINDOW = 2048
# lanes whose fields are in flight ahead of the walk (csrc/mvr_apply.cu
# RING)
RING = 8
# values a key the kernel takes (its kept-entry mask is 32 bits)
MAX_VALUES = 32


def _walk_plain(state, ops, wclock_out=None) -> torch.Tensor:
    """The JAX scan in PyTorch, in place: the write lanes in waves over
    distinct rows, each row's lanes in lane order (``kernels.lane_buckets.row_waves``);
    with ``wclock_out`` (int32 ``[V, B, W]``, zeros) the capture mode.
    Returns the drops per view."""
    V, K, vc = state["val"].shape
    w = state["clock"].shape[-1]
    dev = state["val"].device
    lanes = torch.arange(w, device=dev)
    gi = gather_index(ops["key"], K)
    wi, wok = scatter_index(ops["key"], K)
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    captured = "wclock" in ops and wclock_out is None
    for v, b in row_waves(ops["op"] == OP_WRITE, gi, K):
        a0, wr = ops["a0"][v, b], ops["writer"][v, b]
        m = v.numel()
        row = {f: state[f][v, gi[v, b]] for f in FIELDS}   # [M, vc(, W)]
        observed = torch.where(row["valid"][..., None], row["clock"],
                               0).amax(-2)                  # [M, W]
        if captured or wclock_out is not None:
            if captured:
                wclock = ops["wclock"][v, b]
            else:
                wclock = wrap_add_one(observed, lanes[None, :] == wr[:, None])
                wclock_out[v, b] = wclock
            joined, ovf = frontier(
                torch.cat([row["val"], a0[:, None]], -1),
                torch.cat([row["valid"], torch.ones((m, 1), dtype=torch.bool,
                                                    device=dev)], -1),
                torch.cat([row["clock"], wclock[:, None, :]], -2), vc)
            dropped.index_add_(0, v, ovf)
        else:
            wl, wl_ok = scatter_index(wr, w)
            bump = (lanes[None, :] == wl[:, None]) & wl_ok[:, None]
            first = torch.arange(vc, device=dev)[None, :] == 0
            joined = {"val": torch.where(first, a0[:, None], SENTINEL),
                      "valid": first.expand(m, vc),
                      "clock": torch.where(first[..., None],
                                           wrap_add_one(observed, bump)[:, None],
                                           0)}
        ok = wok[v, b]
        for f in FIELDS:
            state[f][v[ok], wi[v, b][ok]] = joined[f][ok].to(state[f].dtype)
    return dropped


def mvr_apply_plain(state, ops) -> torch.Tensor:
    """Plain PyTorch version of ``mvr_apply``."""
    return _walk_plain(state, ops)


def mvr_capture_plain(state, ops):
    """Plain PyTorch version of ``mvr_capture``: returns ``(wclock int32[V,
    B, W], dropped int32[V])``."""
    V, B = ops["op"].shape
    w = state["clock"].shape[-1]
    wclock = torch.zeros((V, B, w), dtype=torch.int32, device=ops["op"].device)
    dropped = _walk_plain(state, {f: ops[f] for f in OP_FIELDS}, wclock)
    return wclock, dropped


def _lib():
    lib = build.load("mvr_apply")
    if lib.mvr_apply_launch.argtypes is None:
        ptr, arr, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.c_int
        lib.mvr_apply_launch.argtypes = [arr, arr, ptr, arr, i32, i32, i32,
                                         i32, i32, ptr]
        lib.mvr_apply_launch.restype = ctypes.c_int
        lib.mvr_capture_launch.argtypes = [arr, arr, ptr, ptr, arr, i32, i32,
                                           i32, i32, i32, ptr]
        lib.mvr_capture_launch.restype = ctypes.c_int
    return lib


def shared_bytes(vc: int, w: int) -> int:
    """Shared memory of one block (csrc/mvr_apply.cu): V + 1 entry slots
    (a clock row of ``w + 4`` ints when ``w % 4 == 0``, else ``w | 1``;
    val, valid), the row's order (32 slot indices),
    the frontier's map and flags, the ring of lanes in flight (each its
    clock, ``w`` rounded up to 4 ints, and 4 op ints) and a window of lane
    indices."""
    n = vc + 1

    def r16(x):
        return (x + 15) & ~15
    ld = w + 4 if w % 4 == 0 else w | 1
    return (r16(4 * (n * ld + n) + n) + r16(4 * 32 + 5 * n)
            + RING * (4 * ((w + 3) & ~3) + 16) + 4 * WINDOW)


def _launch(name, wrapper, state, ops, wclock_out):
    """Check the operands, then one launch of the walk (the capture mode
    when ``wclock_out`` is given). Returns the drops per view, or None
    when the tensors lie on the CPU."""
    if state["val"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError(f"{name}: state must be [V, K, Vc] and op fields "
                         "[V, B]")
    V, K, vc = state["val"].shape
    w = state["clock"].shape[-1]
    B = ops["op"].shape[1]
    wclock = ops.get("wclock") if wclock_out is None else None
    dev = operands.placement(name, [
        *slot_operands("state.", state, (V, K), vc, w),
        *[(f"op field {f!r}", ops[f], torch.int32, (V, B)) for f in OP_FIELDS],
        ("op field 'wclock'", wclock, torch.int32, (V, B, w))])
    if dev is None:
        return None
    operands.check_shared(name, shared_bytes(vc, w))
    if vc > MAX_VALUES:
        raise ValueError(f"{name}: {vc} values a key, at most {MAX_VALUES} "
                         "on the card (csrc/mvr_apply.cu keeps a row's kept "
                         "entries as a 32-bit mask)")
    if (K == 0 or vc == 0) and V * B > 0:
        raise ValueError(f"{name}: no value rows to gather from")
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    if V * B == 0:
        return dropped
    # the lanes' counts per (view, row), then the walk's work counter and
    # the most rows with writes of a view (all zeroed); the rows' starts;
    # the lanes grouped; each view's rows ranked by write count
    scratch = (torch.zeros((V * K + 2,), dtype=torch.int32, device=dev),
               torch.empty((V, K + 1), dtype=torch.int32, device=dev),
               torch.empty((V, B), dtype=torch.int32, device=dev),
               torch.empty((V, K), dtype=torch.int32, device=dev))
    st = (ctypes.c_void_p * 3)(*(state[f].data_ptr() for f in FIELDS))
    op = (ctypes.c_void_p * 5)(*(ops[f].data_ptr() for f in OP_FIELDS),
                               None if wclock is None else wclock.data_ptr())
    sc = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in scratch))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if wclock_out is None:
            rc = lib.mvr_apply_launch(st, op, dropped.data_ptr(), sc, V, K,
                                      vc, w, B, stream)
        else:
            rc = lib.mvr_capture_launch(st, op, wclock_out.data_ptr(),
                                        dropped.data_ptr(), sc, V, K, vc, w,
                                        B, stream)
    build.check_launch(name, rc)
    wrapper.launches += 1
    return dropped


def mvr_apply(state, ops) -> torch.Tensor:
    """Apply write lanes in order to every view's rows, in place.
    ``state``: ``val``/``valid`` ``[V, K, Vc]``, ``clock`` ``[V, K, Vc,
    W]``; op fields int32 ``[V, B]``, with ``wclock`` int32 ``[V, B, W]``
    for captured writes. Returns the drop count per view, int32 ``[V]``."""
    dropped = _launch("mvr_apply", mvr_apply, state, ops, None)
    return mvr_apply_plain(state, ops) if dropped is None else dropped


mvr_apply.launches = 0


def mvr_capture(state, ops):
    """Capture and apply uncaptured write lanes in order, in place: each
    write's ``wclock`` is the observed clock of the row the earlier lanes
    left with its writer's lane bumped, and the write joins the row as a
    captured one. ``state`` as for ``mvr_apply``; op fields int32 ``[V,
    B]`` (a ``wclock`` field is ignored). Returns ``(wclock int32[V, B,
    W], dropped int32[V])``, the clock 0 for a lane that is not a write."""
    if state["val"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError("mvr_capture: state must be [V, K, Vc] and op "
                         "fields [V, B]")
    V, B = ops["op"].shape
    w = state["clock"].shape[-1]
    wclock = torch.zeros((V, B, w), dtype=torch.int32, device=ops["op"].device)
    dropped = _launch("mvr_capture", mvr_capture, state,
                      {f: ops[f] for f in OP_FIELDS}, wclock)
    if dropped is None:
        return mvr_capture_plain(state, ops)
    return wclock, dropped


mvr_capture.launches = 0

"""``block_select``: SafeKV's delta-apply selection and gather for every
view (kernel source: csrc/block_select.cu).

Replaces janus_tpu/runtime/safecrdt.py ``SafeKV._delta_apply``'s
selection and gather, with janus_tpu/consensus/tusk.py ``order_key``
folded in. Per view, the blocks ``ready & ~applied`` are keyed in
prospective order (``(slot_round - base) * N + src``) or, given
``commit_seq``, in commit order (``seq * W * N`` more); the
``apply_budget`` smallest keys in stable order are chosen, their ring
rows gathered into one ``[V, A * B, ...]`` batch (unchosen lanes' op
``OP_NOOP``), and the choice ORed into ``applied`` in place. The type's
apply then runs on that batch.

One call is two CUDA launches (selection, gather) and adds one to
``block_select.launches``. For CUDA tensors the wrapper launches the
kernels (or raises); ``block_select_plain`` runs only for tensors that
lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.models.base import OP_NOOP

INT32_MAX = torch.iinfo(torch.int32).max
MAX_FIELDS = 16
MAX_KEYS = 1024


def selection_keys(cfg, ready, applied, slot_round, base_round,
                   commit_seq=None) -> torch.Tensor:
    """int32[V, W, N]: each block's order key where it is selected
    (``ready & ~applied``), INT32_MAX elsewhere; the key arithmetic wraps
    as int32, as in JAX."""
    w, n = cfg.num_rounds, cfg.num_nodes
    rel = (slot_round - base_round)[None, :, None]
    srcs = torch.arange(n, dtype=torch.int32, device=ready.device)[None, None, :]
    key = rel * n + srcs
    if commit_seq is not None:
        key = commit_seq * (w * n) + key
    return torch.where(ready & ~applied, key, INT32_MAX)


def block_select_plain(cfg, ops_buffer, ready, applied, budget: int,
                       slot_round, base_round, commit_seq=None):
    """Plain PyTorch version: returns ``(batch {field: int32[V, A * B,
    ...]}, idx int32[V, A], chosen bool[V, A])`` and ORs the chosen blocks
    into ``applied`` in place."""
    w, n = cfg.num_rounds, cfg.num_nodes
    v = ready.shape[0]
    a = min(budget, w * n)
    k = selection_keys(cfg, ready, applied, slot_round, base_round,
                       commit_seq).reshape(v, w * n)
    idx = torch.argsort(k, dim=1, stable=True)[:, :a]           # [V, A]
    chosen = k.gather(1, idx) < INT32_MAX                        # [V, A]
    rows = {f: x.reshape((w * n,) + tuple(x.shape[2:]))[idx]
            for f, x in ops_buffer.items()}                      # [V, A, B, ...]
    rows["op"] = torch.where(chosen[:, :, None], rows["op"], OP_NOOP)
    batch = {f: x.reshape((v, a * x.shape[2]) + tuple(x.shape[3:]))
             for f, x in rows.items()}
    sel = torch.zeros((v, w * n), dtype=torch.bool, device=ready.device)
    sel = sel.scatter(1, idx, chosen).reshape(v, w, n)
    applied |= sel
    return batch, idx.to(torch.int32), chosen


def _lib():
    lib = build.load("block_select")
    if lib.block_select_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.block_select_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.block_select_launch.restype = ctypes.c_int
    return lib


def block_select(cfg, ops_buffer, ready, applied, budget: int, slot_round,
                 base_round, commit_seq=None):
    """Select and gather every view's next blocks: ``(batch {field:
    int32[V, A * B, ...]}, idx int32[V, A], chosen bool[V, A])`` with
    ``A = min(budget, W * N)``; ``applied`` is updated in place.
    ``ops_buffer``: ring fields int32 ``[W, N, B, ...]`` (with ``op``);
    ``ready``, ``applied`` bool[V, W, N]; ``slot_round`` int32[W];
    ``base_round`` int32[]; ``commit_seq`` int32[V, W, N] or None."""
    w, n = cfg.num_rounds, cfg.num_nodes
    v = ready.shape[0] if ready.dim() == 3 else -1
    a = min(budget, w * n)
    names = list(ops_buffer)
    if len(names) > MAX_FIELDS or "op" not in names:
        raise ValueError(f"block_select: ring fields {names}: need 'op' and "
                         f"at most {MAX_FIELDS}")
    bl, i32 = torch.bool, torch.int32
    dev = operands.placement("block_select", [
        ("ready", ready, bl, (v, w, n)), ("applied", applied, bl, (v, w, n)),
        ("commit_seq", commit_seq, i32, (v, w, n)),
        ("slot_round", slot_round, i32, (w,)),
        ("base_round", base_round, i32, ()),
        *((f"ops_buffer.{f}", ops_buffer[f], i32,
           (w, n) + tuple(ops_buffer[f].shape[2:])) for f in names)])
    if dev is None:
        return block_select_plain(cfg, ops_buffer, ready, applied, budget,
                                  slot_round, base_round, commit_seq)
    if w * n > MAX_KEYS:
        raise ValueError(f"block_select: W*N = {w * n} blocks per view, at "
                         f"most {MAX_KEYS} on the card")
    batch = {f: torch.empty((v, a * x.shape[2]) + tuple(x.shape[3:]),
                            dtype=i32, device=dev)
             for f, x in ops_buffer.items()}
    idx = torch.empty((v, a), dtype=i32, device=dev)
    chosen = torch.empty((v, a), dtype=bl, device=dev)
    row = (ctypes.c_longlong * len(names))(
        *(ops_buffer[f][0, 0].numel() for f in names))
    src = (ctypes.c_void_p * len(names))(*(ops_buffer[f].data_ptr() for f in names))
    dst = (ctypes.c_void_p * len(names))(*(batch[f].data_ptr() for f in names))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.block_select_launch(
            ready.data_ptr(), applied.data_ptr(),
            None if commit_seq is None else commit_seq.data_ptr(),
            slot_round.data_ptr(), base_round.data_ptr(), idx.data_ptr(),
            chosen.data_ptr(), src, dst, row, len(names), names.index("op"),
            v, n, w, a, stream)
    build.check_launch("block_select", rc)
    block_select.launches += 1
    return batch, idx, chosen


block_select.launches = 0

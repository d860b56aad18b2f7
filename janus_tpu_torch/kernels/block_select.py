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

One call is two CUDA launches (the selection, a block a view; then the
gather, launched while the selection runs and waiting for it;
csrc/block_select.cu) and adds one to ``block_select.launches``; its
outputs are views of one buffer. For CUDA tensors the wrapper launches the
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


_LAUNCH = build.LeanLaunch(
    "block_select", "block_select_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6)

# (ring fields' names, addresses and shapes, V, A) -> Layout
_LAYOUTS: dict = {}


class Layout:
    """One call's outputs as views of one int32 buffer, every part 16-byte
    aligned: each field's batch ``[V, A * B, ...]`` in the ring's field
    order, then ``idx`` int32[V, A] and ``chosen`` bool[V, A]; and the
    kernel's table of the ring (csrc/block_select.cu: the fields'
    addresses, their rows' int32, their batches' offsets)."""

    def __init__(self, ops_buffer, v: int, a: int):
        self.names = list(ops_buffer)
        rows = [x[0, 0].numel() for x in ops_buffer.values()]
        self.views_at, offsets, at = [], [], 0
        for (f, x), r in zip(ops_buffer.items(), rows):
            shape = (v, a * x.shape[2]) + tuple(x.shape[3:])
            self.views_at.append((f, shape, torch.empty(shape, device="meta")
                                  .stride(), at))
            offsets.append(at)
            at += operands.int32s(v * a * r)
        self.idx_at = 4 * at
        at += operands.int32s(v * a)
        self.chosen_at = 4 * at
        self.total = at + operands.int32s(-(-v * a // 4))
        self.va = (v, a)
        self.table = (ctypes.c_longlong * (3 * len(rows)))(
            *(x.data_ptr() for x in ops_buffer.values()), *rows, *offsets)
        self.op_field = self.names.index("op")

    def views(self, buf):
        """``(batch, idx, chosen)`` as views of ``buf``."""
        view = buf.as_strided
        v, a = self.va
        return ({f: view(shape, stride, at)
                 for f, shape, stride, at in self.views_at},
                view((v, a), (a, 1), self.idx_at // 4),
                buf.view(torch.bool).as_strided((v, a), (a, 1),
                                                self.chosen_at))


def layout(ops_buffer, v: int, a: int) -> Layout:
    """The cached layout of a ring and (V, A) (``operands.ring_cached``:
    ``SafeKV.resize_block`` replaces the ring)."""
    return operands.ring_cached(_LAYOUTS, Layout, ops_buffer, v, a)


def block_select(cfg, ops_buffer, ready, applied, budget: int, slot_round,
                 base_round, commit_seq=None):
    """Select and gather every view's next blocks: ``(batch {field:
    int32[V, A * B, ...]}, idx int32[V, A], chosen bool[V, A])`` with
    ``A = min(budget, W * N)``; ``applied`` is updated in place.
    ``ops_buffer``: ring fields int32 ``[W, N, B, ...]`` (with ``op``);
    ``ready``, ``applied`` bool[V, W, N]; ``slot_round`` int32[W];
    ``base_round`` int32[]; ``commit_seq`` int32[V, W, N] or None. On the
    card the outputs are views of one buffer (``Layout``), written by
    two launches on the lean launch path (``operands.lean_placement``,
    ``build.LeanLaunch``): the selection, then the gather by programmatic
    dependent launch."""
    w, n = cfg.num_rounds, cfg.num_nodes
    v = ready.shape[0] if ready.dim() == 3 else -1
    a = min(budget, w * n)
    if len(ops_buffer) > MAX_FIELDS or "op" not in ops_buffer:
        raise ValueError(f"block_select: ring fields {list(ops_buffer)}: "
                         f"need 'op' and at most {MAX_FIELDS}")
    bl, i32 = torch.bool, torch.int32
    dev = operands.lean_placement("block_select", [
        ("ready", ready, bl, (v, w, n)), ("applied", applied, bl, (v, w, n)),
        ("commit_seq", commit_seq, i32, (v, w, n)),
        ("slot_round", slot_round, i32, (w,)),
        ("base_round", base_round, i32, ()),
        *((f"ops_buffer.{f}", x, i32, (w, n) + x.shape[2:])
          for f, x in ops_buffer.items())])
    if dev is None:
        return block_select_plain(cfg, ops_buffer, ready, applied, budget,
                                  slot_round, base_round, commit_seq)
    if w * n > MAX_KEYS:
        raise ValueError(f"block_select: W*N = {w * n} blocks per view, at "
                         f"most {MAX_KEYS} on the card")
    lay = layout(ops_buffer, v, a)
    buf = torch.empty(lay.total, dtype=i32, device=dev)
    _LAUNCH(dev, ready.data_ptr(), applied.data_ptr(),
            None if commit_seq is None else commit_seq.data_ptr(),
            slot_round.data_ptr(), base_round.data_ptr(), buf.data_ptr(),
            lay.idx_at, lay.chosen_at, lay.table, len(lay.names),
            lay.op_field, v, n, w, a)
    block_select.launches += 1
    return lay.views(buf)


block_select.launches = 0

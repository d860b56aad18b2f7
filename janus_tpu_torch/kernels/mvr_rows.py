"""The MVRegister layout and the causal frontier shared by its hand
kernels' plain versions (``mvr_merge``, ``mvr_merge_rows``, ``mvr_apply``,
``mvr_capture``).

Per key a row of V value slots: ``val`` (int32 value id, SENTINEL when
invalid), ``valid`` (bool) and ``clock`` (int32 ``[..., V, W]``, the
vector clock of the write that made the value, one lane per writer).
``frontier`` is janus_tpu/models/mvregister.py ``merge_with_stats`` on a
concatenation of entries; its CUDA twin is csrc/mvr_frontier.cuh.
"""
from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch.ops.lattice import SENTINEL
from janus_tpu_torch.ops.setops import lex_order

OP_WRITE = 1  # a0=value id, writer=writer lane

# every per-slot field, in the order the C entry points take them
FIELDS = ("val", "valid", "clock")
DTYPES = {"val": torch.int32, "valid": torch.bool, "clock": torch.int32}
# the op fields the apply reads, in the C entry point's order
OP_FIELDS = ("op", "key", "a0", "writer")

Row = Dict[str, torch.Tensor]


def frontier(val, valid, clock, capacity: int):
    """The causal frontier of n entries per row, cut to ``capacity``:

    1. drop every entry whose clock is strictly dominated by a valid
       entry's;
    2. drop every exact (val, clock) twin of an earlier valid entry;
    3. sort the kept entries first, stably, by (val, clock lanes 0..W-1)
       as signed int32, the rest after as (SENTINEL, zero clock, invalid);
    4. cut to ``capacity`` slots.

    ``val`` int32 ``[..., n]``, ``valid`` bool ``[..., n]``, ``clock``
    int32 ``[..., n, W]``. Returns ``({"val", "valid", "clock"}, overflow
    int32[...])``, the kept entries that did not fit counted in
    ``overflow``."""
    n, w = clock.shape[-2:]
    ci, cj = clock[..., :, None, :], clock[..., None, :, :]
    leq = (ci <= cj).all(-1)                                    # [..., n, n]
    strictly = leq & (ci < cj).any(-1)
    vj = valid[..., None, :]
    dominated = (strictly & vj).any(-1)
    eq = leq & (ci >= cj).all(-1) & (val[..., :, None] == val[..., None, :])
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                    device=val.device), -1)
    dup = (eq & vj & earlier).any(-1)
    keep = valid & ~dominated & ~dup
    kclock = torch.where(keep[..., None], clock, 0)
    keys = ([(~keep).to(torch.int32), torch.where(keep, val, SENTINEL)]
            + [kclock[..., i] for i in range(w)])
    order = lex_order(keys)[..., :capacity]
    out = {"val": keys[1].gather(-1, order),
           "valid": keep.gather(-1, order),
           "clock": kclock.gather(-2, order[..., None].expand(
               order.shape + (w,)))}
    overflow = keep.sum(-1) - out["valid"].sum(-1)
    return out, overflow.to(torch.int32)


def wrap_add_one(x: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """int32 ``x`` plus one where ``where`` holds, wrapping as int32 (a
    clock bump never widens)."""
    y = x.to(torch.int64) + where.to(torch.int64)
    return ((y + 2**31) % 2**32 - 2**31).to(torch.int32)


def slot_operands(prefix: str, slots: Row, lead, v: int, w: int):
    """``operands.placement`` entries for the three fields of MVRegister
    rows ``lead + (v,)`` (``clock`` ``lead + (v, w)``)."""
    return [(f"{prefix}val", slots["val"], torch.int32, lead + (v,)),
            (f"{prefix}valid", slots["valid"], torch.bool, lead + (v,)),
            (f"{prefix}clock", slots["clock"], torch.int32, lead + (v, w))]

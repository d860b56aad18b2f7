"""The plain versions' counterpart of csrc/lane_buckets.cuh: an apply's
live lanes grouped by (view, gathered row), walked in waves so that the
lanes of one wave touch distinct rows and each row sees its lanes in lane
order. ``lww_apply`` and ``mvr_apply`` walk their plain versions so.
"""
from __future__ import annotations

import torch


def row_waves(live: torch.Tensor, rows: torch.Tensor, num_rows: int):
    """The live lanes of ``live`` (bool ``[V, B]``) as waves: wave t holds
    the t-th live lane, in lane order, of every (view, gathered row)
    group, so the lanes of one wave touch distinct rows. ``rows`` (int64
    ``[V, B]``) is each lane's gathered row. Yields ``(views, lanes)``
    int64 index pairs per wave, in wave order."""
    vs, bs = torch.nonzero(live, as_tuple=True)   # by view, then lane
    if vs.numel() == 0:
        return
    grp = vs * num_rows + rows[vs, bs]
    order = torch.sort(grp, stable=True).indices
    vs, bs, grp = vs[order], bs[order], grp[order]
    pos = torch.arange(grp.numel(), device=grp.device)
    first = torch.ones_like(grp, dtype=torch.bool)
    first[1:] = grp[1:] != grp[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for t in range(int(rank.max()) + 1):
        sel = rank == t
        yield vs[sel], bs[sel]

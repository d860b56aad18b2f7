"""An apply's lanes grouped by (view, gathered row). For the plain
versions (the counterpart of csrc/lane_buckets.cuh): the live lanes
walked in waves so that the lanes of one wave touch distinct rows and
each row sees its lanes in lane order (``lww_apply`` and ``mvr_apply``
walk their plain versions so). For the card's group walks
(csrc/lww_apply.cu, csrc/orset_apply.cu): the buckets' size and their
scratch, cached per walk, device and stream.
"""
from __future__ import annotations

import ctypes
import math

import torch

# csrc/lane_buckets.cuh (the buckets of csrc/lww_apply.cu and
# csrc/orset_apply.cu): the most records a bucket holds
MAX_BUCKET = 2048

# (walk, device index, stream) -> Scratch
_SCRATCH: dict = {}


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


def bucket_records(K: int, B: int) -> int:
    """Records a group's bucket holds at K rows and B lanes a view: the
    lanes a row on average, six of their square roots and 32 (a uniform
    spread of lanes stays inside), a multiple of 32, at most
    ``MAX_BUCKET``; a group past it is walked from the op fields, 32
    lanes at a time."""
    mean = B / max(K, 1)
    return min(MAX_BUCKET, int(mean + 6 * math.sqrt(mean) + 32 + 31) // 32 * 32)


class Scratch:
    """The groups' scratch of one walk, device and stream: the counts
    (zeroed once; every launch leaves them zero), the buckets of 16-byte
    records, the lists of groups (those with lanes; csrc/orset_apply.cu
    then lists those past their bucket) and their lengths, two a list, of
    which a call uses those at ``parity`` (zero) and zeroes the others for
    the next call."""

    def __init__(self, dev):
        def ints(n, zero=False):
            return (torch.zeros if zero else torch.empty)(
                n, dtype=torch.int32, device=dev)
        self.ints = ints
        self.count, self.rec, self.list = ints(0, True), ints(0), ints(0)
        self.live = ints(4, True)
        self.parity = 0
        self.ptrs = None

    def grow(self, groups: int, records: int, listed: int) -> None:
        if self.count.numel() < groups:
            self.count, self.ptrs = self.ints(groups, True), None
        if self.list.numel() < listed:
            self.list, self.ptrs = self.ints(listed), None
        if self.rec.numel() < 4 * records:
            self.rec, self.ptrs = self.ints(4 * records), None
        if self.ptrs is None:  # the four buffers' addresses, as the C
            # entries take them
            self.ptrs = (ctypes.c_void_p * 4)(*(
                t.data_ptr() for t in (self.count, self.rec, self.list,
                                       self.live)))


def scratch(walk: str, dev: torch.device, groups: int, records: int,
            listed: int):
    """The cached scratch of walk ``walk`` (a wrapper's name) on the
    current stream of ``dev``, grown to at least ``groups`` counts,
    ``records`` bucket records and ``listed`` list entries. Returns (key,
    Scratch). The caller flips ``parity`` after each launch."""
    key = (walk, dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    held = _SCRATCH.get(key)
    if held is None:
        held = _SCRATCH[key] = Scratch(dev)
    held.grow(groups, records, listed)
    return key, held


def forget_scratch(key) -> None:
    """Drop a stream's scratch after a failed launch (its counts may not
    be zero any more)."""
    _SCRATCH.pop(key, None)

"""Elementwise lattice joins, vector clocks and (hi, lo) timestamps
(counterpart: janus_tpu/ops/lattice.py).
"""
from __future__ import annotations

import torch

# Reserved key value marking an empty slot in slot-set tensors.
SENTINEL = torch.iinfo(torch.int32).max


def join_max(a, b):
    """Grow-only-vector join: elementwise max (the PN-Counter join)."""
    return torch.maximum(a, b)


def join_or(a, b):
    """Boolean-lattice join: elementwise OR."""
    return torch.logical_or(a, b)


# ---------------------------------------------------------------------------
# Vector clocks: int32 tensors [..., W], one lane per potential writer (an
# absent entry is 0).
# ---------------------------------------------------------------------------

def clock_leq(a, b):
    """True where clock ``a`` happens-before-or-equals ``b`` (a <= b
    elementwise over the trailing clock axis)."""
    return (a <= b).all(-1)


def clock_dominates(a, b):
    """True where ``a`` strictly dominates ``b`` (b <= a and b != a)."""
    return clock_leq(b, a) & (a > b).any(-1)


# comparison codes, symmetric
CLOCK_EQUAL = 0
CLOCK_BEFORE = 1      # a happens-before b  -> b overwrites
CLOCK_AFTER = 2       # b happens-before a  -> a wins
CLOCK_CONCURRENT = 3  # concurrent          -> merge


def clock_compare(a, b):
    """Classify clock pairs along the trailing axis -> int32 code tensor."""
    ale, ble = clock_leq(a, b), clock_leq(b, a)
    code = torch.where(ale, CLOCK_BEFORE,
                       torch.where(ble, CLOCK_AFTER, CLOCK_CONCURRENT))
    return torch.where(ale & ble, CLOCK_EQUAL, code).to(torch.int32)


# ---------------------------------------------------------------------------
# 64-bit timestamps as (hi, lo) int32 pairs in lexicographic order, the low
# word an unsigned counter.
# ---------------------------------------------------------------------------

_SIGN = -(2**31)


def ts_after(hi_a, lo_a, hi_b, lo_b):
    """True where timestamp a >= b (lexicographic on (hi, lo)); on equal
    stamps the first operand wins, so passing the add stamp as ``a`` is
    the add-wins tie rule. Flipping the low word's sign bit makes the
    signed compare an unsigned one."""
    ua, ub = lo_a ^ _SIGN, lo_b ^ _SIGN
    return (hi_a > hi_b) | ((hi_a == hi_b) & (ua >= ub))


def ts_max(hi_a, lo_a, hi_b, lo_b):
    """Lexicographic max of (hi, lo) timestamp pairs -> (hi, lo)."""
    take_a = ts_after(hi_a, lo_a, hi_b, lo_b)
    return torch.where(take_a, hi_a, hi_b), torch.where(take_a, lo_a, lo_b)

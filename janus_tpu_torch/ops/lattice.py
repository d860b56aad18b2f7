"""Elementwise lattice joins (counterpart: janus_tpu/ops/lattice.py).

The vector-clock and timestamp helpers of the JAX module come with the
types that use them (MVRegister, LWW-Set).
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

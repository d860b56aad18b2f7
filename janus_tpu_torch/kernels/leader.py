"""Tusk leader election: the murmur3 finalizer on uint32
(counterpart: janus_tpu/consensus/tusk.py ``_mix32``, ``leader_of``,
``leaders``).

torch has no uint32 right shift on the CPU, so the mix runs in int64
masked to 32 bits, with products split so no intermediate leaves int64.
The ``tusk_commit`` kernel computes the same mix in ``uint32_t`` from the
seed constant ``seed_constant`` gives it. The mix sits beside the
kernels because ``tusk_commit``'s plain version needs it; ``consensus.tusk``
re-exports ``leader_of`` and ``leaders``.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``, without any intermediate above 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 ``x``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def seed_constant(seed: int) -> int:
    """The seed's additive constant of the mix, reduced to 32 bits as the
    JAX package's ``leaders`` does."""
    return (seed * 0x9E3779B9 + 1) & _M32


def leader_of(cfg, wave: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """int32 leader node id for each (unbounded) wave number; the wave is
    read as uint32, as the JAX package's ``astype(uint32)`` does."""
    w = wave.to(torch.int64) & _M32
    h = _mix32((_mul32(w, 2654435761) + seed_constant(seed)) & _M32)
    return (h % cfg.num_nodes).to(torch.int32)


def leaders(cfg, seed: int = 0) -> np.ndarray:
    """int32[W//2]: leader per wave for the first window (host-side)."""
    waves = torch.arange(cfg.num_rounds // 2, dtype=torch.int64)
    return leader_of(cfg, waves, seed).numpy()

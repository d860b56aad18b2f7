"""Workload generators (counterpart: janus_tpu/bench/workloads.py).

Batches are drawn with numpy from a ``np.random.Generator`` — the same
draws, in the same order, as the JAX package's generators — and moved
onto a device with ``ops_to_device``.
"""
from __future__ import annotations

import numpy as np
import torch

from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.models import base, pncounter


def pnc_uniform(rng: np.random.Generator, num_replicas: int, num_keys: int,
                batch: int) -> dict:
    """Uniform inc/dec mix over all keys; writer lane = replica id.
    Returns a dict of int32[num_replicas, batch] numpy arrays."""
    shape = (num_replicas, batch)
    ops = {
        "op": rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1, shape),
        "key": rng.integers(0, num_keys, shape),
        "a0": rng.integers(1, 10, shape),
        "writer": np.broadcast_to(
            np.arange(num_replicas, dtype=np.int32)[:, None], shape),
    }
    return {f: np.ascontiguousarray(ops[f], np.int32) if f in ops
            else np.zeros(shape, np.int32) for f in base.OP_FIELDS}


def ops_to_device(ops: dict, device=None) -> dict:
    """Move an op batch (numpy or tensors, one array per field) onto
    ``device`` as contiguous int32 tensors."""
    dev = resolve_device(device)
    return {f: torch.tensor(np.asarray(v), dtype=torch.int32, device=dev)
            if not isinstance(v, torch.Tensor)
            else v.to(device=dev, dtype=torch.int32).contiguous()
            for f, v in ops.items()}

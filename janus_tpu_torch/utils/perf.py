"""Host-side timing helpers (counterpart: janus_tpu/utils/perf.py)."""
from __future__ import annotations

import time

import torch

from janus_tpu_torch.device import resolve_device


def backend_rtt(reps: int = 5, device=None) -> float:
    """Seconds of one dispatch + fetch round trip of a trivial kernel: the
    observation floor every wall-clock reading of a device result
    includes. One definition, so every benchmark subtracts and reports the
    same floor. ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    x = torch.zeros((4,), dtype=torch.int32, device=dev)
    (x + 1).cpu()  # first use off the clock
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        (x + 1).cpu()
    return (time.perf_counter() - t0) / reps

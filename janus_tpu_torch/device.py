"""Device choice for every entry point of the port.

The port runs on the card. ``device=None`` means CUDA, and a machine
without one raises; the CPU is used only when the caller names it (the
tests do, to hold the port against the JAX package).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the concrete device to run on.

    ``None`` -> the current CUDA device, raising if there is none; an
    explicit ``"cpu"`` (or ``torch.device("cpu")``) -> the CPU; an
    explicit CUDA device -> that device, raising if CUDA is absent."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_device(dev: torch.device, tree, what: str = "tensor") -> None:
    """Raise unless every tensor leaf of ``tree`` (a tensor or a nested
    dict of tensors) lies on ``dev``."""
    if isinstance(tree, dict):
        for v in tree.values():
            check_device(dev, v, what)
    elif isinstance(tree, torch.Tensor) and tree.device != dev:
        raise ValueError(f"{what} lies on {tree.device}, expected {dev}")

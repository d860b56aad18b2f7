"""Operand checks shared by every kernel wrapper, and the host tables
the ring's wrappers cache.

A wrapper runs its plain version only when every tensor lies on the CPU;
otherwise every tensor must lie on one CUDA device with the dtype the
kernel reads and be contiguous, or the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

# the consensus kernels hold each DAG row as a 64-bit mask over nodes
MAX_NODES = 64
# dynamic shared memory one block can use on Hopper
MAX_SHARED_BYTES = 232448
# static shared memory of the block-wide prefix sums (csrc/slot_sort.cuh)
SCAN_SHARED_BYTES = 4 * 1024 + 4 * 34


def placement(name: str, operands) -> torch.device | None:
    """``operands``: (label, tensor or None, dtype, shape) tuples; a None
    tensor is an absent optional input. Raises on a wrong shape. Returns
    None when every tensor lies on the CPU, else the one CUDA device all
    of them lie on, after checking dtype and contiguity."""
    present = [op for op in operands if op[1] is not None]
    for label, t, _, shape in present:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    if all(t.device.type == "cpu" for _, t, _, _ in present):
        return None
    dev = present[0][1].device
    if dev.type != "cuda" or any(t.device != dev for _, t, _, _ in present):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    for label, t, dtype, _ in present:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"tensor, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    return dev


def lean_placement(name: str, operands) -> torch.device | None:
    """``placement`` at less host cost for the usual call: when every
    present tensor lies on the CUDA device of the first one, contiguous,
    with its dtype and shape, returns that device; anything else goes to
    ``placement``, which returns None for tensors on the CPU or raises
    as it always does."""
    dev = None
    for _, t, dtype, shape in operands:
        if t is None:
            continue
        if not (t.is_cuda and t.dtype is dtype and t.shape == shape
                and t.is_contiguous()):
            return placement(name, operands)
        if dev is None:
            dev = t.device
        elif t.device != dev:
            return placement(name, operands)
    return placement(name, operands) if dev is None else dev


def int32s(n: int) -> int:
    """int32 words of n, rounded up to 16 bytes: the step between the
    parts of a wrapper's one output buffer."""
    return -(-n // 4) * 4


def ring_cached(cache: dict, make, ops_buffer, *extra):
    """``make(ops_buffer, *extra)``, held in ``cache`` on the ring fields'
    names, addresses and shapes and ``extra`` (``SafeKV.resize_block``
    replaces the ring, so a new ring is a new key); a full cache (64
    entries) is emptied."""
    key = (tuple((f, x.data_ptr(), x.shape) for f, x in ops_buffer.items()),
           *extra)
    held = cache.get(key)
    if held is None:
        if len(cache) >= 64:
            cache.clear()
        held = cache[key] = make(ops_buffer, *extra)
    return held


def _ring_table(ops_buffer):
    xs = list(ops_buffer.values())
    return (ctypes.c_longlong * max(1, 2 * len(xs)))(
        *(x.data_ptr() for x in xs), *(x[0].numel() for x in xs))


# (ring fields' names, addresses and shapes) -> the ring's table
_RING_TABLES: dict = {}


def ring_table(ops_buffer):
    """The kernels' table of a ring (int32 fields ``[W, ...]``): their
    addresses, then each slot row's int32, cached (``ring_cached``)."""
    return ring_cached(_RING_TABLES, _ring_table, ops_buffer)


def check_fits(name: str, num_nodes: int, shared_bytes: int) -> None:
    """Raise unless the card path takes ``num_nodes`` and the shared
    memory one block of the kernel needs."""
    if num_nodes > MAX_NODES:
        raise ValueError(f"{name}: {num_nodes} nodes, but the CUDA kernel "
                         f"holds a DAG row as a 64-bit mask (at most "
                         f"{MAX_NODES} nodes)")
    check_shared(name, shared_bytes)


def check_shared(name: str, shared_bytes: int) -> None:
    """Raise unless one block of the kernel fits in shared memory."""
    if shared_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: needs {shared_bytes} bytes of shared "
                         f"memory per block, more than {MAX_SHARED_BYTES}")


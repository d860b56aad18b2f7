"""janus-tpu-torch: the PyTorch/CUDA port of janus-tpu for NVIDIA Hopper.

A second package beside ``janus_tpu`` (the JAX reference, which it never
imports). Subpackages and file names mirror the JAX package, so every
ported file has one counterpart:

ops        lattice joins, slot sets
models     CRDT type models (PN-Counter, OR-Set)
kernels    hand-written CUDA kernels (sources under ``csrc/``), each with
           its plain PyTorch version and a launch counter
runtime    replicated store, engine tick, SafeKV dual-state runtime
consensus  DAG mempool + Tusk wave commit as tensor programs
bench      workload generators
utils      OR-Set tag minting
convert    state carried across from the JAX package (numpy in, numpy out)

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU it raises instead of switching silently
(see ``device.resolve_device``).
"""

__version__ = "0.1.0"

from janus_tpu_torch.device import resolve_device  # noqa: F401,E402

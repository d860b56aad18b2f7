"""Lattice joins (counterpart: janus_tpu/ops)."""

from janus_tpu_torch.ops.lattice import SENTINEL, join_max, join_or  # noqa: F401

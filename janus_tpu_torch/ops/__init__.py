"""Lattice joins, vector clocks and timestamps (counterpart: janus_tpu/ops)."""

from janus_tpu_torch.ops.lattice import (  # noqa: F401
    CLOCK_AFTER, CLOCK_BEFORE, CLOCK_CONCURRENT, CLOCK_EQUAL, SENTINEL,
    clock_compare, clock_dominates, clock_leq, join_max, join_or, ts_after,
    ts_max)

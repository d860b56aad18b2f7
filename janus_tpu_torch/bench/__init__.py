"""Workload generators (counterpart: janus_tpu/bench)."""

"""Replicated store, engine tick and SafeKV runtime (counterpart: janus_tpu/runtime)."""

"""Host-side helpers (counterpart: janus_tpu/utils)."""

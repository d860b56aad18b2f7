"""The split cluster's host side: the DAG message wire, the crypto binding,
the split-cluster endpoints (counterpart: janus_tpu/net)."""

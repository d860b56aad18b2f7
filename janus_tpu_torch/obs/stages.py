"""Stage timers for the safe-update path: ingest -> seal -> dag_round
-> commit -> apply (counterpart: janus_tpu/obs/stages.py).

Each stage maps to a host-measurable leg of the pipeline (a round's device
work is queued without a host sync, so timing happens at its host
boundaries — same trick as the harness's dispatch/absorb split):

- ingest:    op arrival on the wire to staged on a runtime queue
             (net/service.py routing, net/splitnode.py inbox drain).
- seal:      boarding a block — the dispatch that seals staged ops into
             a DAG block (runtime/safecrdt.py submit+tick dispatch).
- dag_round: one consensus round's dispatch->absorb wall time (the
             device-side create/deliver/sign/certify program).
- commit:    submit wall-clock to own-view Tusk commit observed — the
             measured end-to-end safe-update leg.
- apply:     commit absorbed to delta applied + safe-acks surfaced
             (host bookkeeping in _absorb_commits / ack send).

Histograms are named ``stage_<scope>_<stage>_ns`` so multiple runtimes
(one per CRDT type in a service) stay distinguishable.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from janus_tpu_torch.obs.metrics import Histogram, get_registry

STAGES = ("ingest", "seal", "dag_round", "commit", "apply")


def stage_name(scope: str, stage: str) -> str:
    return f"stage_{scope}_{stage}_ns"


def stage_histograms(scope: str, registry=None) -> dict:
    """Histogram per stage for one scope (e.g. a type_code or 'svc')."""
    reg = registry if registry is not None else get_registry()
    return {s: reg.histogram(stage_name(scope, s)) for s in STAGES}


@contextmanager
def time_stage(hist: Histogram):
    """Time a block into a stage histogram (nanoseconds)."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        hist.record(time.perf_counter_ns() - t0)


def summarize_stages(scope: str, registry=None) -> dict:
    """Scrape-time p50/p90/p99/mean (ms) per stage, for results/PERF
    reporting — the harness threads this into results_r*.jsonl rows so
    PERF.md tails are reproducible from raw data."""
    reg = registry if registry is not None else get_registry()
    out = {}
    for s in STAGES:
        h = reg.get(stage_name(scope, s))
        if h is None or h.count == 0:
            continue
        out[s] = {
            "count": h.count,
            "mean_ms": (h.sum / h.count) / 1e6,
            "p50_ms": h.percentile(0.50) / 1e6,
            "p90_ms": h.percentile(0.90) / 1e6,
            "p99_ms": h.percentile(0.99) / 1e6,
        }
    return out

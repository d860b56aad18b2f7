"""The port's flight recorder (janus_tpu_torch.obs.flight) and its causal
spans through the port's SafeKV (on the CPU), against the JAX package's.

The recorder cases are those of tests/test_flight.py but the Chrome-trace
export (the port has no traceview yet). The causal chain runs the same
seeded rounds through a JAX SafeKV and the port's, each under its own
package's process recorder: every trace id must get the same spans and
events in the same order (ingest, seal, dag_round, commit, apply, recycled)
in both, and some trace the whole chain. Times are not compared.
"""
import json
import time

import numpy as np
import pytest
import torch

from janus_tpu.consensus import DagConfig as JaxDagConfig
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.obs import flight as jax_flight
from janus_tpu.runtime.safecrdt import SafeKV as JaxSafeKV

from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.obs import flight
from janus_tpu_torch.obs.flight import FlightRecorder
from janus_tpu_torch.runtime.safecrdt import SafeKV

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CHAIN = ("ingest", "seal", "dag_round", "commit", "apply")


def test_ring_wraparound_keeps_newest_never_reallocs():
    rec = FlightRecorder(capacity=8)
    buf_id = id(rec._buf)
    for i in range(20):
        rec.event(f"t{i}", "mark", "I", detail=i)
    assert id(rec._buf) == buf_id
    assert len(rec._buf) == 8
    assert rec.total == 20
    snap = rec.snapshot()
    assert len(snap) == 8
    assert [e[4] for e in snap] == list(range(12, 20))


def test_span_context_manager_records_complete_span():
    rec = FlightRecorder(capacity=4)
    with rec.span("c1", "work"):
        pass
    (_t0, tid, span, kind, dur) = rec.snapshot()[0]
    assert (tid, span, kind) == ("c1", "work", "S")
    assert dur >= 0


def test_disabled_recorder_records_nothing():
    rec = FlightRecorder(capacity=4, enabled=False)
    rec.event("x", "y")
    rec.span_at("x", "y", 0, 5)
    assert rec.total == 0
    assert rec.snapshot() == []


def test_dump_writes_json_lines(tmp_path):
    rec = FlightRecorder(capacity=4)
    rec.event("a", "m", "I", detail="d")
    p = tmp_path / "f.jsonl"
    assert rec.dump(str(p)) == 1
    row = json.loads(p.read_text())
    assert row["trace_id"] == "a"
    assert row["span"] == "m"


def test_process_recorder_starts_disabled_and_toggles():
    flight.disable()
    rec = flight.get_recorder()
    assert not rec.enabled
    assert flight.enable() is rec and rec.enabled
    flight.disable()
    assert not flight.get_recorder().enabled
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def _run(kv, rec, n, b):
    rng = np.random.default_rng(0)
    writer = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                             (n, b)).copy()
    safe = np.ones((n, b), bool)
    for t in range(40):
        ops = {"op": np.full((n, b), jax_pnc.OP_INC, np.int32),
               "key": rng.integers(0, 16, (n, b)).astype(np.int32),
               "a0": np.ones((n, b), np.int32), "a1": np.zeros((n, b), np.int32),
               "a2": np.zeros((n, b), np.int32), "writer": writer}
        # node 3 boards nothing on odd rounds: its blocks carry no trace
        record = np.array([True, True, True, t % 2 == 0])
        trace = [f"n{v}.t{t}" if record[v] else None for v in range(n)]
        t0 = time.time_ns()
        for tid in trace:
            if tid:
                rec.span_at(tid, "ingest", t0, time.time_ns())
        kv.step(ops, safe=safe, record=record, trace=trace)


def _chains(events):
    out = {}
    for _t, tid, span, kind, _d in events:
        out.setdefault(tid, []).append((span, kind))
    return out


def test_causal_chain_through_safekv_matches_jax():
    n, b = 4, 8
    rec, jrec = flight.enable(), jax_flight.enable()
    rec.clear()
    jrec.clear()
    try:
        kv = SafeKV(DagConfig(n, 8), pncounter.SPEC, ops_per_block=b,
                    collect_logs=False, device="cpu", num_keys=16,
                    num_writers=n)
        _run(kv, rec, n, b)
        jkv = JaxSafeKV(JaxDagConfig(n, 8), jax_pnc.SPEC, ops_per_block=b,
                        collect_logs=False, num_keys=16, num_writers=n)
        _run(jkv, jrec, n, b)
    finally:
        flight.disable()
        jax_flight.disable()
    got, want = _chains(rec.snapshot()), _chains(jrec.snapshot())
    assert got == want
    full = [tid for tid, spans in got.items()
            if set(CHAIN) <= {s for s, _ in spans}]
    assert full, f"no complete causal chain among {len(got)} traces"
    spans = [s for s, _ in got[full[0]]]
    assert spans[0] == "ingest"
    assert spans.index("seal") < spans.index("commit") < spans.index("apply")
    # a committed block's commit span starts where its seal span started
    by_tid = {}
    for t_ns, tid, span, kind, _d in rec.snapshot():
        by_tid.setdefault(tid, {})[span] = t_ns
    assert by_tid[full[0]]["commit"] == by_tid[full[0]]["seal"]
    assert not kv._block_traces or all(
        tid for tid, _ in kv._block_traces.values())


def test_disabled_recorder_leaves_safekv_untraced():
    flight.disable()
    n, b = 4, 8
    rec = flight.get_recorder()
    before = rec.total
    kv = SafeKV(DagConfig(n, 8), pncounter.SPEC, ops_per_block=b,
                collect_logs=False, device="cpu", num_keys=16, num_writers=n)
    _run(kv, FlightRecorder(capacity=8, enabled=False), n, b)
    assert rec.total == before
    assert kv._block_traces == {}

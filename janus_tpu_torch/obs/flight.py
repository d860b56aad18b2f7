"""Bounded flight recorder: a ring buffer of causal trace events
(counterpart: janus_tpu/obs/flight.py).

Every pipeline stage appends a small structured event ``(t_ns, trace_id,
span, kind, detail)`` into a preallocated ring; on anomaly (the health
watchdog, ``obs/watchdog.py``) or on demand the last ``capacity`` events
are snapshotted or dumped as JSON lines. The aggregate stage histograms
(``obs/stages.py``) say how fast the pipeline runs; the recorder says
which block, which round, why one safe update stalled.

- **O(1) append, no allocation after construction.** The ring is a
  preallocated list; append is an index increment plus a slot store.
  Wrap-around overwrites the oldest event.
- **Thread-tolerant, not thread-serialized.** The hot path takes no
  lock: a racing append may lose or double-write a slot, never tear one
  event (each slot is a single tuple store).
- **Free when disabled.** Callers guard on ``rec.enabled`` (a plain
  attribute); the process-wide recorder starts disabled.

Event kinds: ``"S"``, a completed span (``t_ns`` its start, ``detail``
its duration in ns); ``"I"``, an instant event (``detail`` free-form).
"""
from __future__ import annotations

import json
import threading
import time
from typing import List, Optional, Tuple

Event = Tuple[int, str, str, str, object]  # (t_ns, trace_id, span, kind, detail)

DEFAULT_CAPACITY = 65536


class FlightRecorder:
    """Fixed-capacity ring of trace events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self._buf: List[Optional[Event]] = [None] * capacity
        self._idx = 0       # next write position (monotonic, mod on store)
        self.total = 0      # appends since construction (survives wrap)

    # -- hot path --------------------------------------------------------

    def event(self, trace_id: str, span: str, kind: str = "I",
              detail=None, t_ns: Optional[int] = None) -> None:
        """Append one event. O(1); never grows the buffer."""
        if not self.enabled:
            return
        if t_ns is None:
            t_ns = time.time_ns()
        i = self._idx
        self._idx = i + 1
        self.total += 1
        self._buf[i % self.capacity] = (t_ns, trace_id, span, kind, detail)

    def span_at(self, trace_id: str, span: str, t0_ns: int,
                t1_ns: int) -> None:
        """Record a completed span with explicit wall-clock bounds."""
        if not self.enabled:
            return
        i = self._idx
        self._idx = i + 1
        self.total += 1
        self._buf[i % self.capacity] = (
            t0_ns, trace_id, span, "S", max(0, t1_ns - t0_ns))

    def span(self, trace_id: str, name: str):
        """Context manager measuring a span with ``time.time_ns``."""
        return _SpanCtx(self, trace_id, name)

    # -- cold path -------------------------------------------------------

    def snapshot(self) -> List[Event]:
        """Events oldest-first. Advisory-consistent under concurrency
        (a racing append may show once, twice, or not at all)."""
        idx = self._idx
        cap = self.capacity
        if idx <= cap:
            out = self._buf[:idx]
        else:
            cut = idx % cap
            out = self._buf[cut:] + self._buf[:cut]
        return [e for e in out if e is not None]

    def dump(self, path: str) -> int:
        """Write the snapshot as JSON lines; returns the event count."""
        events = self.snapshot()
        with open(path, "w") as f:
            for t_ns, tid, span, kind, detail in events:
                f.write(json.dumps({"t_ns": t_ns, "trace_id": tid,
                                    "span": span, "kind": kind,
                                    "detail": detail}) + "\n")
        return len(events)

    def clear(self) -> None:
        cap = self.capacity
        self._buf = [None] * cap
        self._idx = 0
        self.total = 0


class _SpanCtx:
    __slots__ = ("_rec", "_tid", "_name", "_t0")

    def __init__(self, rec: FlightRecorder, tid: str, name: str):
        self._rec = rec
        self._tid = tid
        self._name = name

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rec.span_at(self._tid, self._name, self._t0, time.time_ns())
        return False


# -- process-wide default recorder ---------------------------------------

_lock = threading.Lock()
_default: Optional[FlightRecorder] = None


def get_recorder() -> FlightRecorder:
    """The process-wide recorder; starts DISABLED (zero-cost guards)."""
    global _default
    rec = _default
    if rec is None:
        with _lock:
            if _default is None:
                _default = FlightRecorder(enabled=False)
            rec = _default
    return rec


def enable(capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Enable the process-wide recorder (resizing it if asked)."""
    global _default
    with _lock:
        rec = _default
        if rec is None or rec.capacity != capacity:
            rec = FlightRecorder(capacity=capacity, enabled=True)
            _default = rec
        else:
            rec.enabled = True
    return rec


def disable() -> None:
    rec = get_recorder()
    rec.enabled = False

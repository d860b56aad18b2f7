"""Process-wide metrics registry: counters, gauges, log-bucketed
histograms (counterpart: janus_tpu/obs/metrics.py, copied so the port
imports nothing of the JAX package).

1. The record path is cheap enough to live inside the tick loop: no
   locks, no allocation, no device syncs. A histogram bucket for a
   non-negative integer value is ``value.bit_length()`` clipped to the
   last bucket (bucket 0 holds exactly {0}; bucket i holds
   [2^(i-1), 2^i)). Percentiles are interpolated only at scrape time.

2. Concurrent recording from several threads never corrupts state: a
   race on one bucket can at worst lose an increment.

3. The module is a leaf: it imports nothing of the rest of the port.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np

NUM_BUCKETS = 64
_MAX_IDX = NUM_BUCKETS - 1

# bucket i (i >= 1) spans [2^(i-1), 2^i); upper edges for interpolation.
BUCKET_LO = [0] + [1 << (i - 1) for i in range(1, NUM_BUCKETS)]
BUCKET_HI = [1] + [1 << i for i in range(1, NUM_BUCKETS)]


def percentile_from_counts(counts: Sequence[int], q: float) -> float:
    """Interpolated q-quantile (q in [0,1]) from a 64-bucket count
    vector in this module's power-of-two bucketing. This is
    ``Histogram.percentile`` factored out so MERGED histograms —
    per-shard SLO bucket vectors summed across a cluster scrape
    — get identical math without a Histogram instance to call it on.

    Linear interpolation within the bucket containing the target rank,
    so the result is exact for single-bucket data and bounded by the
    bucket edges otherwise (<= 2x relative error by construction of
    power-of-two buckets).
    """
    counts = list(counts)
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * (total - 1)
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        # ranks [cum, cum+c-1] fall in bucket i
        if rank < cum + c:
            lo, hi = BUCKET_LO[i], BUCKET_HI[i]
            if c == 1:
                frac = 0.5
            else:
                frac = (rank - cum) / (c - 1)
            return lo + frac * (hi - lo)
        cum += c
    return float(BUCKET_HI[_MAX_IDX])


class Counter:
    """Monotonic counter. ``add`` is a single in-place increment."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def add(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        self._value = 0

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        self._value += n

    def max(self, v: float) -> None:
        """Ratchet upward: keep the largest value ever set."""
        if v > self._value:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Log-bucketed histogram of non-negative integers (default unit: ns).

    64 fixed power-of-two buckets; values >= 2^62 land in the overflow
    bucket. Recording touches one list slot and two scalars; everything
    rank-based (percentiles, cumulative counts) happens at scrape time.
    """

    __slots__ = ("name", "unit", "_counts", "_sum", "_count")

    def __init__(self, name: str, unit: str = "ns"):
        self.name = name
        self.unit = unit
        self._counts = [0] * NUM_BUCKETS
        self._sum = 0
        self._count = 0

    def record(self, value: int) -> None:
        v = int(value)
        if v < 0:
            v = 0
        idx = v.bit_length()
        self._counts[idx if idx < _MAX_IDX else _MAX_IDX] += 1
        self._sum += v
        self._count += 1

    def record_seconds(self, seconds: float) -> None:
        self.record(int(seconds * 1e9))

    def record_many(self, values) -> None:
        """Vectorized ``record`` for a batch of values (the SLO ledger's
        bulk-ack path records thousands of e2e latencies per flush; a
        Python loop there would undo the batching).

        Bucket-exact vs the scalar path: for v > 0, bit_length(v) is
        frexp(v)[1] once v is a float64 — exact for v < 2^53, and values
        at or beyond that are deep in the clipped tail anyway (bucket 53+
        of 63 for nanosecond latencies = multi-month outliers).
        """
        v = np.asarray(values, np.int64).ravel()
        if v.size == 0:
            return
        v = np.maximum(v, 0)
        idx = np.frexp(v.astype(np.float64))[1]  # 0 for v == 0
        # upper bound only: v >= 0 already pins the exponent to >= 0.
        # bincount (one O(n) pass) instead of unique (a sort): latency
        # batches land in a handful of adjacent buckets, so the scatter
        # into the list touches a few slots either way but the bucket
        # grouping itself is ~4x cheaper
        np.minimum(idx, _MAX_IDX, out=idx)
        bc = np.bincount(idx)
        counts = self._counts
        for i in np.flatnonzero(bc).tolist():
            counts[i] += int(bc[i])
        self._sum += int(v.sum())
        self._count += int(v.size)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> int:
        return self._sum

    def counts(self) -> list:
        return list(self._counts)

    def reset(self) -> None:
        self._counts = [0] * NUM_BUCKETS
        self._sum = 0
        self._count = 0

    def percentile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0,1]) from bucket ranks; see
        ``percentile_from_counts`` for the interpolation contract."""
        return percentile_from_counts(self._counts, q)

    def snapshot(self) -> dict:
        counts = list(self._counts)
        return {
            "type": "histogram",
            "unit": self.unit,
            "count": self._count,
            "sum": self._sum,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "buckets": {
                str(BUCKET_HI[i]): c for i, c in enumerate(counts) if c
            },
        }


class Registry:
    """Name -> instrument map. Creation is locked; recording is not.

    ``enabled=False`` swaps every instrument handed out afterwards for a
    shared no-op so instrumented code needs no feature-flag branches.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments = {}

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, **kw)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        return self._get(name, Gauge)

    def histogram(self, name: str, unit: str = "ns") -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        return self._get(name, Histogram, unit=unit)

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self) -> list:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        return {
            name: inst.snapshot()
            for name, inst in sorted(self._instruments.items())
        }

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_NULL_COUNTER = Counter("_null")
_NULL_GAUGE = Gauge("_null")
_NULL_HISTOGRAM = Histogram("_null")

_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return _REGISTRY

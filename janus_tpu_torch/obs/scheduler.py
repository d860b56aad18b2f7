"""Latency-adaptive block-size controller, AIMD on measured seal latency
(counterpart: janus_tpu/obs/scheduler.py).

A large block B buys consensus throughput, but under a light load a safe
update then rides a block-fill and round it never needed. The controller
closes the loop on the telemetry plane's own seal-latency measurements:

- under backlog (queues hold at least a full block), grow B additively
  toward the throughput peak ``b_max``;
- when queues drain and measured seal latency sits above the target,
  shrink B multiplicatively toward ``b_min`` so blocks seal promptly;
- always clamp so W x B never exceeds the ring-window back-pressure
  bound ``max_inflight_ops``.

Actuation is decoupled from decision: ``maybe_adjust`` only returns the
target; the owner calls ``SafeKV.resize_block``, which refuses a shrink
while tail lanes still carry live ops (the target is then retried at the
next adjust). Blocks quantize to ``quantum`` lanes, so a run sees a
handful of ring geometries, not one per adjustment.

With ``slo_p99_target_ms > 0`` the same controller also co-schedules the
drain hold-off ``wait_ms`` and the unsafe-class shed probability
``shed_prob`` from the SLO evidence ``observe_slo`` feeds it:

- queue at/past the hard cap, or p99 past target while queued deep:
  multiplicative shed increase and the hold-off pinned long;
- p99 past target while queues are shallow: shrink the hold-off toward
  ``wait_min_ms`` instead of shedding;
- healthy: multiplicative shed decay to zero and the hold-off relaxed
  back to ``wait0_ms``.

A goodput guard bounds the shed law: while measured goodput sits below
90% of its (decaying) peak, shed probability backs off rather than grows.
"""
from __future__ import annotations

from dataclasses import dataclass

from janus_tpu_torch.obs.metrics import get_registry


@dataclass(frozen=True)
class SchedulerConfig:
    b_min: int = 64                 # latency-floor block size
    b_max: int = 5120               # swept throughput-peak block size
    window: int = 8                 # ring W: slots concurrently in flight
    max_inflight_ops: int = 0       # back-pressure bound; 0 -> W * b_max
    latency_target_ms: float = 50.0  # seal p90 the shrink path defends
    grow_step: int = 512            # additive increase per adjust
    shrink_factor: float = 0.5      # multiplicative decrease per adjust
    adjust_every: int = 8           # ticks between decisions
    quantum: int = 64               # B rounded down to a multiple
    # SLO-driven overload extension (inactive at 0.0): unsafe e2e p99
    # the shed/wait laws defend, read from the live SloLedger via
    # observe_slo
    slo_p99_target_ms: float = 0.0
    shed_max: float = 0.95          # unsafe shed-probability ceiling
    wait0_ms: float = 10.0          # healthy-state drain hold-off
    wait_min_ms: float = 1.0        # latency-mode hold-off floor
    wait_max_ms: float = 50.0       # overload-mode hold-off ceiling

    def bound(self) -> int:
        """Largest B the ring window tolerates."""
        cap = self.max_inflight_ops or self.window * self.b_max
        return max(self.b_min, cap // max(1, self.window))


class AdaptiveTick:
    """Per-runtime AIMD controller; feed it one observation per tick."""

    def __init__(self, cfg: SchedulerConfig, b0=None, scope="sched",
                 registry=None):
        self.cfg = cfg
        reg = registry if registry is not None else get_registry()
        self._g_b = reg.gauge(f"{scope}_block_size")
        self._c_grow = reg.counter(f"{scope}_grows_total")
        self._c_shrink = reg.counter(f"{scope}_shrinks_total")
        start = cfg.b_max if b0 is None else int(b0)
        self._b = self._clamp(start)
        self._g_b.set(self._b)
        self._ticks = 0
        self._backlog_peak = 0
        self._seal_ms = []
        self._overflows = 0
        self._dirty_fracs = []
        # overload-control outputs (live values the owner actuates);
        # inert unless cfg.slo_p99_target_ms > 0 and observe_slo feeds
        self.shed_prob = 0.0
        self.wait_ms = float(cfg.wait0_ms)
        self._slo_obs = []  # (goodput_ops_s, p99_ms, depth_frac)
        self._goodput_peak = 0.0
        self._g_shed = reg.gauge(f"{scope}_shed_prob_ppm")
        self._g_wait = reg.gauge(f"{scope}_ingest_wait_us")

    @property
    def b(self) -> int:
        return self._b

    def _clamp(self, b: int) -> int:
        b = min(int(b), self.cfg.b_max, self.cfg.bound())
        b = max(b, self.cfg.b_min)
        q = self.cfg.quantum
        if b > q:
            b -= b % q
        return b

    def observe(self, backlog_ops: int, seal_ms: float) -> None:
        """One tick's evidence: deepest per-node queue, seal wall ms."""
        self._ticks += 1
        if backlog_ops > self._backlog_peak:
            self._backlog_peak = int(backlog_ops)
        self._seal_ms.append(float(seal_ms))

    def observe_delta(self, dirty_fraction: float, overflowed: bool) -> None:
        """Delta-converge evidence for the same tick: the union-dirty
        fraction and whether the slab budget overflowed (forcing a full
        converge). Overflow is shrink pressure — smaller blocks dirty
        fewer rows per tick, pulling the delta path back under budget."""
        self._dirty_fracs.append(float(dirty_fraction))
        if overflowed:
            self._overflows += 1

    def observe_slo(self, goodput_ops_s: float, p99_ms: float,
                    depth_frac: float) -> None:
        """One tick's SLO-plane evidence: admitted-goodput over the last
        window, unsafe e2e p99, and queue depth as a fraction of the
        admission hard cap (>= 1.0 means the door is past its cap)."""
        self._slo_obs.append(
            (float(goodput_ops_s), float(p99_ms), float(depth_frac)))

    def _adjust_slo(self) -> None:
        """Shed/wait half of the adjust step (slo mode only)."""
        obs = self._slo_obs
        self._slo_obs = []
        if not obs or self.cfg.slo_p99_target_ms <= 0:
            return
        goodput = sum(g for g, _p, _d in obs) / len(obs)
        p99 = max(p for _g, p, _d in obs)
        depth = max(d for _g, _p, d in obs)
        target = self.cfg.slo_p99_target_ms
        # decaying peak: the reference the goodput guard compares
        # against adapts if the sustainable rate itself moves
        self._goodput_peak = max(goodput, self._goodput_peak * 0.98)
        if depth >= 1.0 or (p99 > target and depth >= 0.5):
            # overloaded at the door: shed multiplicatively while
            # goodput holds near its peak. Once goodput falls below
            # 90% of peak, shedding is eating admitted work — back
            # off multiplicatively instead, so the law seeks the shed
            # level that keeps goodput on the plateau rather than
            # overshooting and pinning there
            if goodput < 0.9 * self._goodput_peak:
                self.shed_prob *= 0.7
                if self.shed_prob < 0.02:
                    self.shed_prob = 0.0
            else:
                self.shed_prob = min(self.cfg.shed_max,
                                     self.shed_prob * 1.7 + 0.05)
            # deep queues fill every drain: long hold-off is free
            # batching, so pin it at the ceiling
            self.wait_ms = self.cfg.wait_max_ms
        elif p99 > target:
            # slow but shallow: the hold-off itself is the latency —
            # halve it toward the floor instead of shedding
            self.wait_ms = max(self.cfg.wait_min_ms, self.wait_ms * 0.5)
            self.shed_prob *= 0.5
            if self.shed_prob < 0.02:
                self.shed_prob = 0.0
        else:
            self.shed_prob *= 0.5
            if self.shed_prob < 0.02:
                self.shed_prob = 0.0
            # relax the hold-off back to the operating point
            w0 = self.cfg.wait0_ms
            self.wait_ms += (w0 - self.wait_ms) * 0.5
        self._g_shed.set(int(self.shed_prob * 1e6))
        self._g_wait.set(int(self.wait_ms * 1e3))

    def maybe_adjust(self):
        """At the adjust cadence, return a new target B (or None)."""
        if self._ticks < self.cfg.adjust_every:
            return None
        backlog = self._backlog_peak
        seal = self._seal_ms
        overflows = self._overflows
        n_delta = len(self._dirty_fracs)
        self._ticks = 0
        self._backlog_peak = 0
        self._seal_ms = []
        self._overflows = 0
        self._dirty_fracs = []
        self._adjust_slo()
        if not seal:
            return None
        seal_sorted = sorted(seal)
        seal_p90 = seal_sorted[min(len(seal) - 1, int(0.9 * len(seal)))]
        # Overflowing the dirty budget on most delta ticks means the full
        # [R, K] converge ran anyway — the block is dirtying more rows than
        # the slab can carry, so treat it like missed latency.
        overflow_pressure = n_delta > 0 and overflows * 2 > n_delta
        new_b = self._b
        if backlog >= self._b and not overflow_pressure:
            # saturation: queues refill a whole block every tick
            new_b = self._clamp(self._b + self.cfg.grow_step)
            if new_b > self._b:
                self._c_grow.add()
        elif overflow_pressure or (
                seal_p90 > self.cfg.latency_target_ms
                and backlog < max(1, self._b // 2)):
            # drained and slow: blocks are bigger than the load needs
            new_b = self._clamp(int(self._b * self.cfg.shrink_factor))
            if new_b < self._b:
                self._c_shrink.add()
        if new_b == self._b:
            return None
        self._b = new_b
        self._g_b.set(new_b)
        return new_b

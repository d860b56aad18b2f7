"""Config-driven benchmark harness, tensor mode (counterpart:
janus_tpu/bench/harness.py): load generation, latency split by op class,
reference-style results table.

``run_tensor`` drives SafeKV directly on the device with pipelined
fetches: the device-rate numbers (consensus throughput, commit latency by
wall clock from submit to own-view commit) without wire overhead; how the
framework is driven when embedded. ``BenchConfig``, ``OpStats``,
``Results``, ``DRIVE_DEPTH`` and ``PRESETS`` are the JAX harness's, so a
config or preset means the same run in both packages, and a seed gives
the same op batches (the same numpy draws in the same order).

``run_tensor`` also drives the Byzantine runs (``byzantine`` > 0) through
the integrity plane (``consensus.integrity.SecureCluster``, one
synchronous secure step a round), with the pruned blocks folded through
the health watchdog; ``run_tensor_adaptive`` is the offered-rate drive
through the AIMD block-size controller (``obs.scheduler``), which resizes
SafeKV's blocks at runtime; ``run`` dispatches a config by its mode. Not
in this port yet: the wire modes and the overload sweep (ROADMAP queue 1
items 3-4), and the store_delta and RGA replay runners (queue 1 item 2;
their paths run in ``chip_smoke.py``).

    python -m janus_tpu_torch.bench.harness --preset pnc [--json]
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# tensor-mode pipeline depth for the throughput phase (the
# latency phase runs depth 2); also sets the reported absorb-cadence
# observation floor (~backend RTT / depth)
DRIVE_DEPTH = 16


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """BenchmarkConfig.cs analog (JSON-loadable)."""

    name: str = "pnc_uniform"
    mode: str = "tensor"              # "tensor" | "wire"
    type_code: str = "pnc"            # pnc | orset | mixed
    num_nodes: int = 4
    window: int = 8
    num_objects: int = 100
    ops_per_block: int = 1000
    ticks: int = 60
    # wire mode
    clients: int = 4
    ops_per_client: int = 200
    # requests in flight per client connection: 1 = closed loop; the
    # reference benchmark is effectively open-loop (async receive with
    # per-thread batches, BenchmarkRunners.cs:185-256), which is what a
    # deep pipeline reproduces
    pipeline: int = 1
    # op mix (BenchmarkConfig.opsRatio): weights by op class
    ops_ratio: Tuple[float, float, float] = (0.5, 0.5, 0.0)  # get/update/safe
    key_pattern: str = "uniform"      # uniform | zipf | normal
    zipf_theta: float = 0.99
    byzantine: int = 0                # nodes injecting invalid signatures
    invalid_rate: float = 0.5
    crashed: int = 0                  # crash-fault nodes (paper Fig 11)
    # OR-Set per-key tag capacity. NOT scaled with num_objects: the
    # effect-capture payload is [W, N, B, rm_capacity] int32 per extra
    # field, so these multiply the whole consensus op buffer
    orset_capacity: int = 128
    # captured tags per remove op; exact while elements keep fewer live
    # tags than this (the bench add/remove mix keeps ~1-2)
    orset_rm_capacity: int = 16
    # RGA replay churn shape: each element is deleted rga_delete_lag
    # ticks after its insert, and every replica compacts (identically,
    # at full convergence) every rga_compact_every ticks — live state
    # stays bounded while the cumulative op log runs to millions
    rga_delete_lag: int = 2
    rga_compact_every: int = 4
    # delta-convergence mode (mode="store_delta"): union-dirty slab
    # budget D for Store.converge_delta; the A/B workload's per-tick
    # hot-key window derives from it (D // 2 keys), keeping the dirty
    # fraction under budget by construction
    dirty_budget: int = 0
    # adaptive mode (mode="adaptive"): offered-rate drive through the
    # AIMD block-size controller (obs/scheduler.py). ops_per_block is
    # the throughput-peak CEILING; offered_per_tick=0 saturates (full
    # blocks every tick), >0 trickles that many ops per node per tick.
    # adaptive=False runs the same offered-rate drive at fixed B — the
    # like-for-like control for the controller's latency win.
    adaptive: bool = True
    offered_per_tick: int = 0
    block_floor: int = 64
    latency_target_ms: float = 50.0
    # sharded wire mode (mode="wire_sharded"): worker count for the B
    # arm (the A arm always runs shards=1 over the same schedule), and
    # ops per columnar batch frame for the open-loop sender fleet
    shards: int = 4
    frame_ops: int = 2048
    # op-accumulation threshold handed to JanusConfig.ingest_batch for
    # both wire_sharded arms (0 = device round every service step)
    ingest_batch: int = 0
    # native zero-GIL shard demux (JanusConfig.native_demux) for the
    # sharded arms; mode="wire_sharded_native" A/Bs this switch at
    # EQUAL shard count (native rings vs the Python router)
    native_demux: bool = True
    # pin each shard's device state to its own mesh member
    # (JanusConfig.shard_devices) — the multi-device step-overlap row;
    # needs >= shards devices (real or XLA virtual) to mean anything
    shard_devices: bool = False
    # overload-control sweep (mode="overload"): offered-load multiples
    # of the service's own calibrated drain capacity; each point drives
    # the admission-controlled sharded service open-loop at that rate
    load_mults: Tuple[float, ...] = ()
    seed: int = 0

    @classmethod
    def from_json(cls, text: str) -> "BenchConfig":
        raw = json.loads(text)
        if "ops_ratio" in raw:
            raw["ops_ratio"] = tuple(raw["ops_ratio"])
        if "load_mults" in raw:
            raw["load_mults"] = tuple(raw["load_mults"])
        return cls(**raw)


@dataclasses.dataclass
class OpStats:
    """One op class's latency population (Results.cs:96-232)."""

    latencies_ms: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        if not self.latencies_ms:
            return {"count": 0}
        a = np.asarray(self.latencies_ms)
        return {
            "count": int(a.size),
            "mean_ms": round(float(a.mean()), 3),
            "median_ms": round(float(np.median(a)), 3),
            "stdev_ms": round(float(a.std()), 3),
            "p95_ms": round(float(np.percentile(a, 95)), 3),
            "p99_ms": round(float(np.percentile(a, 99)), 3),
        }


class Results:
    """Aggregated run results + reference-table printer."""

    # reference §6.2 numbers for side-by-side display (BASELINE.md)
    REFERENCE = {
        "pnc_peak_ops_per_sec": 260_000,
        "orset_peak_ops_per_sec": 80_000,
        "safe_latency_light_ms": "100-200",
        "byzantine_throughput_delta": "-20%",
    }

    def __init__(self, cfg: BenchConfig):
        self.cfg = cfg
        self.stats: Dict[str, OpStats] = {
            "get": OpStats(), "update": OpStats(), "safeUpdate": OpStats(),
        }
        self.total_ops = 0
        self.elapsed_s = 0.0
        self.extra: Dict[str, object] = {}

    @property
    def throughput(self) -> float:
        return self.total_ops / self.elapsed_s if self.elapsed_s else 0.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "config": self.cfg.name,
            "mode": self.cfg.mode,
            "throughput_ops_per_sec": round(self.throughput, 1),
            "latency": {k: v.summary() for k, v in self.stats.items()},
            "reference": self.REFERENCE,
            **self.extra,
        }

    def print_table(self) -> None:
        d = self.to_dict()
        print(f"== {self.cfg.name} ({self.cfg.mode}) ==")
        print(f"throughput: {d['throughput_ops_per_sec']:>12,.1f} ops/s   "
              f"(reference pnc peak {self.REFERENCE['pnc_peak_ops_per_sec']:,}, "
              f"orset peak {self.REFERENCE['orset_peak_ops_per_sec']:,})")
        for cls_, s in d["latency"].items():
            if s.get("count"):
                print(f"  {cls_:>11}: n={s['count']:<7} median "
                      f"{s['median_ms']:>8.2f} ms   p95 {s['p95_ms']:>8.2f}"
                      f"   p99 {s['p99_ms']:>8.2f}")
        for k, v in self.extra.items():
            print(f"  {k}: {v}")


def _keys(rng: np.random.Generator, cfg: BenchConfig, shape) -> np.ndarray:
    if cfg.key_pattern == "zipf":
        from janus_tpu_torch.bench.workloads import zipf_keys
        return zipf_keys(rng, cfg.num_objects, shape, cfg.zipf_theta)
    if cfg.key_pattern == "normal":
        # normal access centered mid-keyspace (BankingBenchmarkRunner
        # access patterns, :208-226)
        raw = rng.normal(cfg.num_objects / 2, cfg.num_objects / 8, shape)
        return np.clip(raw, 0, cfg.num_objects - 1).astype(np.int32)
    return rng.integers(0, cfg.num_objects, shape).astype(np.int32)


# the ROADMAP item that ports each mode run_tensor does not run
UNPORTED_MODES = {
    "wire": "ROADMAP queue 1 items 3-4 (the wire plane and service)",
    "wire_native": "ROADMAP queue 1 items 3-4 (the wire plane and service)",
    "wire_sharded": "ROADMAP queue 1 items 3-4 (the wire plane and service)",
    "wire_sharded_native":
        "ROADMAP queue 1 items 3-4 (the wire plane and service)",
    "overload": "ROADMAP queue 1 items 3-4 (the wire plane and service)",
    "store_delta": "ROADMAP queue 1 item 2 (run_store_delta)",
}


def _host_batch(op, key, a0=None, a1=None, a2=None, writer=None) -> dict:
    """A dense int32 op batch in numpy; missing fields are zero-filled."""
    fields = {"op": op, "key": key, "a0": a0, "a1": a1, "a2": a2,
              "writer": writer}
    shape = np.shape(op)
    return {f: (np.zeros(shape, np.int32) if v is None
                else np.asarray(v).astype(np.int32))
            for f, v in fields.items()}


def _fetcher(packed: torch.Tensor):
    """Queue the D2H copy of a round's packed output behind that round's
    work (no host sync) and return a function that waits for it: the
    fetch completes when that round is done, not behind later rounds."""
    if packed.device.type != "cuda":
        return lambda: (packed.numpy(), time.perf_counter())
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.numpy(), time.perf_counter()
    return wait


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_tensor(cfg: BenchConfig, device=None,
               observe: Optional[dict] = None) -> Results:
    """Device-rate run: consensus path under steady load, with the safe
    class measured by wall-clock submit->own-view-commit and queries
    timed against the live state. ``device`` defaults to CUDA (a machine
    without one raises; pass ``"cpu"`` to run the plain versions).
    ``observe``, a dict when given, receives the run's SafeKVs (``kvs``,
    by type code), its host op batches (``batches``), the crash mask
    (``active``) and every absorbed round as ``(type code, batch index or
    None when idle, accepted[N])`` (``rounds``)."""
    from concurrent.futures import ThreadPoolExecutor

    from janus_tpu_torch.bench.workloads import ops_to_device
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.device import resolve_device
    from janus_tpu_torch.models import orset, pncounter
    from janus_tpu_torch.obs import stages as obs_stages
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.utils.ids import TagMinter
    from janus_tpu_torch.utils.perf import backend_rtt

    if cfg.mode != "tensor":
        raise NotImplementedError(
            f"mode {cfg.mode!r} is not ported: "
            f"{UNPORTED_MODES.get(cfg.mode, 'only the tensor mode is')}")
    if cfg.byzantine and cfg.crashed:
        raise ValueError(
            "byzantine + crashed in one run needs SecureCluster's "
            "fetch-mode crash modeling; configure them separately")
    if cfg.type_code not in ("pnc", "orset", "mixed"):
        raise NotImplementedError(
            f"type {cfg.type_code!r} has no tensor-mode run in the port")
    dev = resolve_device(device)
    res = Results(cfg)
    rng = np.random.default_rng(cfg.seed)
    n, B, K = cfg.num_nodes, cfg.ops_per_block, cfg.num_objects
    dag = DagConfig(cfg.num_nodes, cfg.window)

    specs = []
    # collect_logs=False: these runs never read the total-order log,
    # so skip the O(N^2*W) commit-tensor fetch per tick
    if cfg.type_code in ("pnc", "mixed"):
        specs.append(("pnc", SafeKV(dag, pncounter.SPEC, ops_per_block=B,
                                    collect_logs=False, device=dev,
                                    num_keys=K, num_writers=n)))
    if cfg.type_code in ("orset", "mixed"):
        # budget: steady state certifies n blocks/tick and commits 2n
        # every 2 ticks (wave cadence) — n + headroom keeps up via spill
        specs.append(("orset", SafeKV(dag, orset.SPEC, ops_per_block=B,
                                      collect_logs=False, device=dev,
                                      num_keys=K,
                                      apply_budget=n + max(4, n // 4),
                                      capacity=cfg.orset_capacity,
                                      rm_capacity=cfg.orset_rm_capacity)))
    minters = [TagMinter(v) for v in range(n)]
    planes = {}
    if cfg.byzantine:
        from janus_tpu_torch.consensus.integrity import (IntegrityPlane,
                                                         SecureCluster)
        byz = np.zeros(n, bool)
        byz[-cfg.byzantine:] = True
        specs = [(code, kv, SecureCluster(
            kv, IntegrityPlane(dag, byzantine=byz,
                               invalid_rate=cfg.invalid_rate, seed=cfg.seed)))
            for code, kv in specs]
        planes = {code: sc.plane for code, _, sc in specs}
    else:
        specs = [(code, kv, None) for code, kv in specs]

    def gen_batch(code: str) -> dict:
        shape = (n, B)
        keys = _keys(rng, cfg, shape)
        if code == "pnc":
            op = rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1, shape)
            return _host_batch(
                op=op, key=keys, a0=rng.integers(1, 10, shape),
                writer=np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                                       shape))
        is_add = rng.random(shape) < 0.5
        tags = np.zeros(shape + (2,), np.int32)
        for v in range(n):
            lanes = np.nonzero(is_add[v])[0]
            if lanes.size:
                tags[v, lanes] = minters[v].mint_many(lanes.size)
        return _host_batch(
            op=np.where(is_add, orset.OP_ADD, orset.OP_REMOVE), key=keys,
            a0=rng.integers(0, 64, shape), a1=tags[..., 0], a2=tags[..., 1])

    safe_frac = cfg.ops_ratio[2] / max(sum(cfg.ops_ratio[1:]), 1e-9)
    safe = rng.random((n, B)) < safe_frac
    # crash faults: the last `crashed` nodes neither create, sign, nor
    # receive (paper §6.2 Fig 11's experiment shape); their op lanes and
    # safe flags are zeroed so only live-node work is counted
    active = None
    if cfg.crashed:
        active = np.ones(n, bool)
        active[-cfg.crashed:] = False
        safe = safe & active[:, None]

    host_batches = {code: [gen_batch(code) for _ in range(4)]
                    for code, _, _ in specs}
    if active is not None:
        for blist in host_batches.values():
            for bt in blist:
                bt["op"] = np.where(active[:, None], bt["op"], 0)
    # pre-upload every rotating batch: SafeKV never writes it
    batches = {code: [ops_to_device(bt, dev) for bt in blist]
               for code, blist in host_batches.items()}
    idle_batch = {code: ops_to_device({f: np.zeros_like(v) for f, v in
                                       host_batches[code][0].items()}, dev)
                  for code, _, _ in specs}
    active_dev = None if active is None else torch.as_tensor(active, device=dev)
    # `safe` stays host numpy: it is host-side ack bookkeeping only
    # (step_dispatch never ships it to the device)
    if observe is not None:
        observe.update(kvs={code: kv for code, kv, _ in specs},
                       batches=host_batches, active=active, rounds=[],
                       planes=planes)

    def drive(pool, ticks, record=True, idle=False, depth=DRIVE_DEPTH):
        inflight = []

        def absorb(entry):
            kv, code, idx, fut, meta = entry
            arr, at = fut.result()
            info = kv.step_absorb(arr, meta, observed_at=at)
            if observe is not None:
                observe["rounds"].append((code, idx, info["accepted"]))

        for i in range(ticks):
            for code, kv, secure in specs:
                idx = None if idle else i % 4
                batch = idle_batch[code] if idle else batches[code][idx]
                if secure is not None:
                    # the plane signs and verifies each round's blocks on
                    # the host before the round: one synchronous step
                    info = secure.step(batch, safe=safe, record=record)
                    if observe is not None:
                        observe["rounds"].append((code, idx, info["accepted"]))
                    continue
                packed, meta = kv.step_dispatch(batch, safe=safe,
                                                active=active_dev,
                                                record=record)
                inflight.append((kv, code, idx, pool.submit(_fetcher(packed)),
                                 meta))
                while len(inflight) > depth:
                    absorb(inflight.pop(0))
        for entry in inflight:
            absorb(entry)

    with ThreadPoolExecutor(max_workers=8) as pool:
        drive(pool, 2 * cfg.window)  # warmup: first use of every kernel
        for _, kv, _ in specs:
            kv.wall_latency_log.clear()
            kv.latency_log.clear()
        t0 = time.perf_counter()
        drive(pool, cfg.ticks)
        # submission-phase duration only: in steady state the sustained
        # rate is the submission rate; the drain merely completes the
        # tail so its latencies are recorded
        res.elapsed_s = time.perf_counter() - t0
        drive(pool, 2 * cfg.window, record=False, idle=True)  # drain
        # throughput accounting stops here: blocks committed during the
        # latency phase below must not count against elapsed_s
        committed_blocks = {code: len(kv.latency_log)
                            for code, kv, _ in specs}
        # latency phase: depth-2 pipeline, so an op's commit observation
        # is not queued behind many in-flight fetches
        for _, kv, _ in specs:
            kv.wall_latency_log.clear()
        drive(pool, min(cfg.ticks, 2 * cfg.window + 8), depth=2)
        drive(pool, 2 * cfg.window, record=False, idle=True, depth=2)

    # ONE floor sample reused for the read timing and the observation-
    # floor report below
    rtt_floor = backend_rtt(reps=3, device=dev)

    for code, kv, _ in specs:
        lats = 1e3 * np.asarray(kv.wall_latency_log)
        res.stats["safeUpdate"].latencies_ms.extend(lats.tolist())
        res.total_ops += committed_blocks[code] * B
        # timed reads against the live state (the gp class), measured
        # the way a co-located client experiences them: a single-view
        # query, with the backend fetch floor measured and subtracted
        qname = "get" if code == "pnc" else "live_count"
        qfn = kv.spec.queries[qname]

        def read(st, q=qfn):
            return q({f: x[0] for f, x in st.items()})[0]

        read(kv.prospective)  # first use off the clock
        _sync(dev)
        fetch_floor = rtt_floor
        for _ in range(10):
            t1 = time.perf_counter()
            for _ in range(8):
                read(kv.prospective)
            _sync(dev)  # one sync for the 8 chained reads
            per_read = max(time.perf_counter() - t1 - fetch_floor, 0.0) / 8
            res.stats["get"].latencies_ms.append(1e3 * per_read)
        res.extra["read_fetch_floor_ms"] = round(1e3 * fetch_floor, 3)
        res.extra["read_latency_note"] = (
            "per-read device latency of a single-key query on view 0; one "
            "synchronize (floor reported separately) amortized over 8 reads")
        # measured per-stage decomposition (telemetry plane), per type
        res.extra[f"stages_{code}"] = obs_stages.summarize_stages(
            kv.stage_scope)
    if planes:
        res.extra["pruned_blocks"] = sum(
            len(p.pruned_blocks()) for p in planes.values())
        # per-node pruned-block counts folded through the watchdog's
        # equivocation detector: a byzantine run flags the injecting
        # nodes; the invalid_rate=0 control stays OK
        from janus_tpu_torch.obs import HealthWatchdog
        merged: Dict[int, int] = {}
        for p in planes.values():
            for src, cnt in p.equivocation_counts().items():
                merged[src] = merged.get(src, 0) + cnt
        wd = HealthWatchdog()
        wd.observe_equivocation(merged)
        res.extra["health"] = wd.health()
    all_lags = np.concatenate([np.asarray(kv.latency_log)
                               for _, kv, _ in specs])
    res.extra["commit_lag_ticks_p50"] = int(np.percentile(all_lags, 50))
    # derived co-located commit latency: measured per-tick time x the
    # measured commit-lag distribution in TICKS (tick indices are immune
    # to fetch latency)
    ticks_run = cfg.ticks
    tick_ms = 1e3 * res.elapsed_s / max(ticks_run, 1)
    res.extra["window"] = cfg.window
    res.extra["tick_ms_avg"] = round(tick_ms, 3)
    # tick_ms_avg is max(device tick, absorb cadence); the cadence floor
    # is ~RTT/pipeline-depth, so when tick_ms_avg is within a few
    # multiples of the floor the derived values are an UPPER BOUND on the
    # co-located latency
    # the secure path steps synchronously: effective depth 1
    obs_floor = 1e3 * rtt_floor / (1 if planes else DRIVE_DEPTH)
    res.extra["tick_observation_floor_ms"] = round(obs_floor, 3)
    res.extra["derived_is_upper_bound"] = bool(tick_ms < 4 * obs_floor)
    res.extra["commit_lag_ticks_p99"] = int(np.percentile(all_lags, 99))
    res.extra["derived_colocated_p50_ms"] = round(
        float(np.percentile(all_lags, 50)) * tick_ms, 3)
    res.extra["derived_colocated_p99_ms"] = round(
        float(np.percentile(all_lags, 99)) * tick_ms, 3)
    # every counted op is applied at all n emulated nodes
    res.extra["replica_applications_per_sec"] = round(res.throughput * n, 1)
    return res


def adaptive_scheduler(cfg: BenchConfig, registry=None):
    """The AIMD controller ``run_tensor_adaptive`` steers ``cfg``'s blocks
    with (the JAX harness's settings): floor ``block_floor``, ceiling
    ``ops_per_block``, a decision every 4 ticks."""
    from janus_tpu_torch.obs import AdaptiveTick, SchedulerConfig

    b_max = cfg.ops_per_block
    return AdaptiveTick(SchedulerConfig(
        b_min=min(cfg.block_floor, b_max), b_max=b_max, window=cfg.window,
        latency_target_ms=cfg.latency_target_ms,
        grow_step=max(64, b_max // 8), adjust_every=4,
        quantum=min(64, b_max)), b0=b_max, registry=registry)


def run_tensor_adaptive(cfg: BenchConfig, device=None,
                        observe: Optional[dict] = None) -> Results:
    """Offered-rate drive through the AIMD block-size controller: each
    tick appends ``offered_per_tick`` ops per node to a host queue,
    boards up to the current block size B, steps synchronously (depth 1:
    wall latencies carry no pipeline queueing), and feeds the controller
    the backlog and the measured seal latency; a target it returns goes
    to ``SafeKV.resize_block``. ``offered_per_tick=0`` saturates (full
    blocks every tick). ``adaptive=False`` runs the same drive at fixed B.
    The same draws in the same order as the JAX package's, so a seed
    gives the same op columns. ``device`` as for ``run_tensor``;
    ``observe``, a dict when given, receives the SafeKV (``kv``) and
    every tick as ``(B, backlog, seal ms, target or None, resized)``
    (``ticks``; ``resized`` None when no resize was asked)."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.device import resolve_device
    from janus_tpu_torch.models import orset, pncounter
    from janus_tpu_torch.obs import flight as obs_flight
    from janus_tpu_torch.obs import stages as obs_stages
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.utils.ids import TagMinter

    dev = resolve_device(device)
    res = Results(cfg)
    rng = np.random.default_rng(cfg.seed)
    n, K, b_max = cfg.num_nodes, cfg.num_objects, cfg.ops_per_block
    dag = DagConfig(cfg.num_nodes, cfg.window)
    if cfg.type_code == "pnc":
        kv = SafeKV(dag, pncounter.SPEC, ops_per_block=b_max,
                    collect_logs=False, device=dev, num_keys=K, num_writers=n)
    else:
        kv = SafeKV(dag, orset.SPEC, ops_per_block=b_max,
                    collect_logs=False, device=dev, num_keys=K,
                    apply_budget=n + max(4, n // 4),
                    capacity=cfg.orset_capacity,
                    rm_capacity=cfg.orset_rm_capacity)
    minters = [TagMinter(v) for v in range(n)]
    sched = adaptive_scheduler(cfg) if cfg.adaptive else None
    if observe is not None:
        observe.update(kv=kv, ticks=[])

    cols = ("op", "key", "a0", "a1", "a2")
    queues = [{c: np.zeros(0, np.int32) for c in cols} for _ in range(n)]

    def gen_cols(v: int, count: int) -> Dict[str, np.ndarray]:
        keys = _keys(rng, cfg, (count,))
        if cfg.type_code == "pnc":
            return {"op": rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1,
                                       count).astype(np.int32),
                    "key": keys, "a0": rng.integers(1, 10, count).astype(
                        np.int32),
                    "a1": np.zeros(count, np.int32),
                    "a2": np.zeros(count, np.int32)}
        is_add = rng.random(count) < 0.5
        tags = np.zeros((count, 2), np.int32)
        lanes = np.nonzero(is_add)[0]
        if lanes.size:
            tags[lanes] = minters[v].mint_many(lanes.size)
        return {"op": np.where(is_add, orset.OP_ADD,
                               orset.OP_REMOVE).astype(np.int32),
                "key": keys,
                "a0": rng.integers(0, 64, count).astype(np.int32),
                "a1": tags[:, 0], "a2": tags[:, 1]}

    resize_failures = [0]

    def one_tick(record: bool = True) -> int:
        B = kv.B
        fl = obs_flight.get_recorder()
        t_in = time.time_ns() if fl.enabled else 0
        offered = cfg.offered_per_tick
        batch = {c: np.zeros((n, B), np.int32) for c in cols}
        batch["writer"] = np.broadcast_to(
            np.arange(n, dtype=np.int32)[:, None], (n, B)).copy()
        boarded = np.zeros(n, np.int64)
        backlog = 0
        for v in range(n):
            if offered == 0:
                fresh = gen_cols(v, B)
                for c in cols:
                    batch[c][v] = fresh[c]
                boarded[v] = B
                backlog = max(backlog, 2 * B)  # saturated by construction
                continue
            fresh = gen_cols(v, offered)
            q = queues[v]
            for c in cols:
                q[c] = np.concatenate([q[c], fresh[c]])
            take = min(B, len(q["op"]))
            for c in cols:
                batch[c][v, :take] = q[c][:take]
            boarded[v] = take
        trace = None
        if fl.enabled and record:
            # one causal trace id per boarded block, named by the (node,
            # tick) it boarded at; the boarding loop above is this drive
            # mode's ingest stage
            trace = [None] * n
            t1w = time.time_ns()
            for v in range(n):
                if boarded[v] > 0:
                    tid = f"n{v}.t{kv.tick_count}"
                    trace[v] = tid
                    fl.span_at(tid, "ingest", t_in, t1w)
        t0 = time.perf_counter()
        info = kv.step(batch, record=(np.asarray(boarded > 0) if record
                                      else False), trace=trace)
        seal_s = time.perf_counter() - t0
        acc = info["accepted"]
        done = 0
        for v in range(n):
            if offered == 0:
                done += int(boarded[v]) if acc[v] else 0
                continue
            q = queues[v]
            if acc[v]:
                take = int(boarded[v])
                for c in cols:
                    q[c] = q[c][take:]
                done += take
            backlog = max(backlog, len(q["op"]))
        target = resized = None
        if sched is not None:
            sched.observe(backlog, seal_s * 1e3)
            target = sched.maybe_adjust()
            if target is not None and target != kv.B:
                resized = kv.resize_block(target)
                if not resized:
                    resize_failures[0] += 1
        if observe is not None:
            observe["ticks"].append((B, backlog, seal_s * 1e3, target,
                                     resized))
        return done

    warmup = max(2 * cfg.window, 16)
    for _ in range(warmup):
        one_tick(record=False)
    kv.wall_latency_log.clear()
    kv.latency_log.clear()
    b_trace = [kv.B]
    total = 0
    t0 = time.perf_counter()
    for _ in range(cfg.ticks):
        total += one_tick()
        b_trace.append(kv.B)
    res.elapsed_s = time.perf_counter() - t0
    # drain: commits for the last boarded blocks land within ~W ticks
    for _ in range(2 * cfg.window):
        one_tick(record=False)

    res.total_ops = total
    lats = 1e3 * np.asarray(kv.wall_latency_log)
    res.stats["safeUpdate"].latencies_ms.extend(lats.tolist())
    res.extra["window"] = cfg.window
    res.extra["adaptive"] = bool(cfg.adaptive)
    res.extra["offered_per_tick"] = cfg.offered_per_tick
    res.extra["block_ceiling"] = b_max
    res.extra["block_floor"] = cfg.block_floor
    res.extra["block_final"] = kv.B
    res.extra["block_trace"] = (b_trace[:: max(1, len(b_trace) // 16)]
                                + [b_trace[-1]])
    res.extra["block_resizes"] = kv.stats["block_resizes"]
    res.extra["resize_refusals"] = resize_failures[0]
    res.extra["tick_ms_avg"] = round(
        1e3 * res.elapsed_s / max(cfg.ticks, 1), 3)
    # the measured per-stage decomposition from the telemetry plane
    res.extra["stages"] = obs_stages.summarize_stages(kv.stage_scope)
    return res


def run(cfg: BenchConfig, device=None,
        observe: Optional[dict] = None) -> Results:
    """Run ``cfg`` by its mode, as the JAX package's ``run``: the adaptive
    mode through ``run_tensor_adaptive``, the tensor mode through
    ``run_tensor`` (``device`` and ``observe`` passed on); a mode or type
    the port does not run yet raises ``NotImplementedError`` naming its
    ROADMAP item."""
    if cfg.type_code == "rga":
        raise NotImplementedError(
            "the RGA replay runner is not ported: ROADMAP queue 1 item 2 "
            "(run_rga_replay; its path runs in chip_smoke.py)")
    if cfg.mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"mode {cfg.mode!r} is not ported: {UNPORTED_MODES[cfg.mode]}")
    if cfg.mode == "adaptive":
        return run_tensor_adaptive(cfg, device=device, observe=observe)
    return run_tensor(cfg, device=device, observe=observe)


PRESETS = {
    # BASELINE.json configs 1-4 (config 5, RGA, lives with the sequence type)
    "pnc": BenchConfig(name="pnc_4rep_banking_shape", type_code="pnc",
                       num_nodes=4, num_objects=100, ops_ratio=(0.2, 0.6, 0.2)),
    # capacity sized to live tags + one GC window of tombstones — the
    # runtime compacts at every GC-frontier advance, so the per-key row
    # stays small; a small row is also what keeps the batched-union
    # record soup (state is re-sorted per delta apply) from dominating
    # the tick
    # B=5120 is the measured throughput peak at this node count (the
    # sweep is RECORDED as orset16_bsweep_* rows in results_r5.jsonl:
    # 2048/3072/4096/6144 -> 85.8k/104.5k/122.2k/131.1k ops/s vs 136.2k
    # here — the [K*C] state share of the per-tick sort amortizes with
    # block size until the op-record share dominates); orset_light is
    # the light-load latency geometry
    "orset": BenchConfig(name="orset_16rep", type_code="orset", num_nodes=16,
                         window=8, num_objects=1000, ops_per_block=5120,
                         ticks=10, orset_capacity=64, orset_rm_capacity=4,
                         ops_ratio=(0.0, 1.0, 0.0)),
    # the reference's own OR-Set PEAK geometry (4 nodes, 100 objects,
    # 50-element cap — paper §6.2 Fig 5's 80k ops/s point); 16 nodes is
    # the Fig 10 scalability row, not the peak
    "orset4": BenchConfig(name="orset_4rep_peak", type_code="orset",
                          num_nodes=4, window=8, num_objects=100,
                          ops_per_block=8192, ticks=24, orset_capacity=64,
                          orset_rm_capacity=4, ops_ratio=(0.0, 1.0, 0.0)),
    # node-count scaling mid point (paper §6.2 Fig 10: OR-Set loses
    # ~40% from 4 -> 8 nodes, then flattens 12 -> 16)
    "orset8": BenchConfig(name="orset_8rep_scaling", type_code="orset",
                          num_nodes=8, window=8, num_objects=100,
                          ops_per_block=8192, ticks=20, orset_capacity=64,
                          orset_rm_capacity=4, ops_ratio=(0.0, 1.0, 0.0)),
    # light-load latency geometry: small blocks keep the tick (and so
    # the op->commit wall clock) low — the reference's latency figures
    # are light-load for the same reason (1000 ops/s send rate, Fig 7)
    "orset_light": BenchConfig(name="orset_16rep_light", type_code="orset",
                               num_nodes=16, window=8, num_objects=1000,
                               ops_per_block=256, ticks=48,
                               orset_capacity=64, orset_rm_capacity=4,
                               ops_ratio=(0.0, 1.0, 0.0)),
    # AIMD controller at the peak geometry, saturated: full blocks every
    # tick, so B should hold the 5120 ceiling and throughput stay within
    # 5% of the fixed-B orset row
    "orset_adaptive": BenchConfig(name="orset_16rep_adaptive",
                                  type_code="orset", mode="adaptive",
                                  num_nodes=16, window=8, num_objects=1000,
                                  ops_per_block=5120, ticks=10,
                                  orset_capacity=64, orset_rm_capacity=4,
                                  block_floor=64,
                                  ops_ratio=(0.0, 1.0, 0.0)),
    # same controller under a trickle (256 ops/node/tick, ~5% of a full
    # block): B collapses to the floor and the measured safe-update p50
    # must beat the fixed-B=5120 control below >= 2x
    "orset_adaptive_light": BenchConfig(name="orset_16rep_adaptive_light",
                                        type_code="orset", mode="adaptive",
                                        num_nodes=16, window=8,
                                        num_objects=1000,
                                        ops_per_block=5120, ticks=48,
                                        offered_per_tick=256,
                                        orset_capacity=64,
                                        orset_rm_capacity=4, block_floor=64,
                                        ops_ratio=(0.0, 1.0, 0.0)),
    # the CONTROL for the row above: identical trickle drive, controller
    # disabled, blocks pinned at the throughput-peak 5120
    "orset_fixed_light": BenchConfig(name="orset_16rep_fixed_light",
                                     type_code="orset", mode="adaptive",
                                     adaptive=False,
                                     num_nodes=16, window=8,
                                     num_objects=1000, ops_per_block=5120,
                                     ticks=48, offered_per_tick=256,
                                     orset_capacity=64, orset_rm_capacity=4,
                                     ops_ratio=(0.0, 1.0, 0.0)),
    # 64-node two-type emulation: all 64 views' unions run on one chip,
    # so the tick is heavy — sized for a ~5-minute run
    "mixed": BenchConfig(name="mixed_zipf_64rep", type_code="mixed",
                         num_nodes=64, window=8, num_objects=500,
                         ops_per_block=64, ticks=24, key_pattern="zipf",
                         orset_capacity=256, orset_rm_capacity=8,
                         ops_ratio=(0.3, 0.5, 0.2)),
    # delta-convergence A/B at the mixed-64 geometry: the same two-type
    # keyspace, driven through fused megaticks full- vs slab-converged.
    # The hot window (dirty_budget // 2 = 32 keys/tick, zipf within) keeps
    # the union-dirty fraction at ~6% of the 500 keys — the sparse regime
    # where the slab join's O(D/K) cost advantage is the whole point
    "mixed_delta": BenchConfig(name="mixed_delta_64rep", mode="store_delta",
                               type_code="mixed", num_nodes=64, window=8,
                               num_objects=500, ops_per_block=64, ticks=24,
                               key_pattern="zipf", orset_capacity=256,
                               orset_rm_capacity=8, dirty_budget=64,
                               ops_ratio=(0.0, 1.0, 0.0)),
    # window 16: the bounded ring deadlocks if a run of dead-leader
    # waves (crashed or pruned-byzantine leaders) spans the in-flight
    # W/2 waves — the liveness bound documented at safecrdt's GC.
    # Measured: n=8 with nodes {6,7} crashed hits a 3-run (waves 6,7,8
    # of the leader mix) and freezes a W=8 ring at base_round 10; W=16
    # rides out runs up to 5. The reference never deadlocks only
    # because its DAG grows without bound (DAG.cs GC comment).
    "byzantine": BenchConfig(name="byzantine_orset", type_code="orset",
                             num_nodes=16, window=16, num_objects=500,
                             ops_per_block=256,
                             byzantine=4, invalid_rate=0.25,
                             ops_ratio=(0.0, 0.8, 0.2)),
    # fault-free CONTROL at the byzantine geometry (same secure path,
    # zero injected invalid certs) — the Fig 11 comparison is the DELTA
    # against this, not against an insecure-path run
    "byzantine0": BenchConfig(name="byzantine_orset_control",
                              type_code="orset", num_nodes=16, window=16,
                              num_objects=500, ops_per_block=256,
                              byzantine=4, invalid_rate=0.0,
                              ops_ratio=(0.0, 0.8, 0.2)),
    # BASELINE config 5: 1k replicas, >=1M applied inserts (plus the
    # matching deletes) with mid-run compaction — 1024 x 16 lanes x 64
    # ticks = 1,048,576 inserts; live state stays ~bounded via the
    # delete-lag/compaction churn
    "rga": BenchConfig(name="rga_text_replay_1k_1M", type_code="rga",
                       num_nodes=1024, num_objects=128, ops_per_block=32,
                       ticks=64, rga_delete_lag=2, rga_compact_every=4),
    # full client plane over loopback TCP (native server -> dispatch ->
    # SafeKV), sized for a sustained-throughput reading vs the
    # reference's 260k ops/s wire peak
    "wire": BenchConfig(name="wire_pnc", type_code="pnc", mode="wire",
                        num_nodes=4, num_objects=100, ops_per_block=2048,
                        clients=16, ops_per_client=3000, pipeline=256,
                        ops_ratio=(0.3, 0.6, 0.1)),
    # same plane driven by the native load generator (loadgen.cc) — the
    # Python clients above cap at ~25k ops/s and measure the clients;
    # this is the server's own ceiling (reference: .NET clients on a
    # separate VM, BenchmarkRunners.cs)
    # B=4096 measured 269.7k ops/s on the co-located CPU host (vs 82k at
    # B=8192 — the bigger block paid full device-step cost at partial
    # fill); reference peak 260k (paper §6.2 Fig 5)
    "wire_native": BenchConfig(name="wire_pnc_native", type_code="pnc",
                               mode="wire_native", num_nodes=4,
                               num_objects=100, ops_per_block=4096,
                               clients=16, ops_per_client=60000,
                               pipeline=1024, ops_ratio=(0.3, 0.6, 0.1)),
    # sharded service plane A/B: open-loop columnar batch
    # frames drive shards=1 vs shards=2 over the same schedule; the
    # per-op protobuf dispatch the wire_native preset pays (~2.6 us/op
    # at its measured 269.7k) is what the frame path deletes
    # small blocks on purpose: the ingest delta combiner collapses a
    # whole poll's counter increments to <= num_objects lanes per home,
    # so step cost tracks B (2.8 ms at B=128 vs 72 ms at B=4096), not
    # the wire op count
    "wire_sharded": BenchConfig(name="wire_pnc_sharded",
                                mode="wire_sharded", type_code="pnc",
                                num_nodes=4, num_objects=64,
                                ops_per_block=256, clients=8,
                                ops_per_client=131072, frame_ops=4096,
                                shards=2, ingest_batch=65536,
                                ops_ratio=(0.0, 1.0, 0.0),
                                seed=11),
    # multi-device step-overlap row: same A/B as
    # wire_sharded but with each shard's device state pinned to its own
    # mesh member (shard_devices) — run under
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 for the
    # virtual-device dryrun; on real multi-chip hosts the pinning is
    # what lets shard steps overlap instead of queueing on one device
    "wire_sharded_overlap": BenchConfig(name="wire_pnc_sharded_overlap",
                                        mode="wire_sharded",
                                        type_code="pnc", num_nodes=4,
                                        num_objects=64, ops_per_block=128,
                                        clients=8, ops_per_client=131072,
                                        frame_ops=4096, shards=2,
                                        ingest_batch=65536,
                                        ops_ratio=(0.0, 1.0, 0.0),
                                        shard_devices=True, seed=11),
    # demux A/B at equal shard count: Python-router vs
    # native zero-GIL demux, same schedule — isolates the router
    # thread's decode+copy cost, which is what capped the round-7
    # sharded arm below the unsharded one on a single-core host
    # ops_per_block 128, not 256: a device round's cost scales with
    # n*B whether lanes are occupied or not, and delta-combining
    # collapses a 65536-op drain to ~num_objects lanes — at B=256 both
    # arms were round-bound on dead lanes (measured: B=1024 slowed
    # both arms ~25%, B=128 left the py arm at its B=256 goodput while
    # the native arm gained ~15%)
    "wire_sharded_native": BenchConfig(name="wire_pnc_sharded_native",
                                       mode="wire_sharded_native",
                                       type_code="pnc", num_nodes=4,
                                       num_objects=64, ops_per_block=128,
                                       clients=8, ops_per_client=131072,
                                       frame_ops=4096, shards=2,
                                       ingest_batch=65536,
                                       ops_ratio=(0.0, 1.0, 0.0),
                                       seed=11),
    # overload-control sweep: offered load at 0.5x-20x the
    # service's own calibrated capacity through the admission-
    # controlled sharded plane — hard-capped inboxes shed unsafe ops
    # with retry-after nacks, safe lanes hold a block reservation, and
    # the SLO controller closes the shed/hold-off loop per worker.
    # ops_ratio's safe weight (2%) is the frame's safe-op share; the
    # evidence gates are goodput plateau past saturation, bounded
    # safe-op p99 at 20x, exact offered == admitted + shed, and zero
    # watchdog commit stalls
    "overload": BenchConfig(name="overload_pnc_sharded", mode="overload",
                            type_code="pnc", num_nodes=4, num_objects=64,
                            ops_per_block=256, clients=8,
                            ops_per_client=65536, frame_ops=1024,
                            shards=2, ingest_batch=65536,
                            latency_target_ms=250.0,
                            load_mults=(0.5, 1.0, 2.0, 4.0, 8.0, 20.0),
                            ops_ratio=(0.0, 0.98, 0.02), seed=11),
    # crash-fault pair (paper §6.2 Fig 11: 8 nodes, 0 vs 2 crashed);
    # window 16 on BOTH so the with/without-crash delta compares like
    # for like (see the byzantine note for why faults need the bigger
    # ring)
    "pnc8": BenchConfig(name="pnc_8rep_baseline", type_code="pnc",
                        num_nodes=8, window=16, num_objects=100,
                        ops_per_block=1000, ticks=60,
                        ops_ratio=(0.2, 0.6, 0.2)),
    "crash": BenchConfig(name="pnc_8rep_2crashed", type_code="pnc",
                         num_nodes=8, window=16, num_objects=100,
                         ops_per_block=1000, ticks=60, crashed=2,
                         ops_ratio=(0.2, 0.6, 0.2)),
}


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="JSON BenchConfig file")
    ap.add_argument("--preset", choices=sorted(PRESETS), help="named preset")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--json", action="store_true", help="emit JSON only")
    args = ap.parse_args(argv)
    if args.config:
        cfg = BenchConfig.from_json(open(args.config).read())
    else:
        cfg = PRESETS[args.preset or "pnc"]
    res = run(cfg, device=args.device)
    if args.json:
        print(json.dumps(res.to_dict()))
    else:
        res.print_table()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (janus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card through its own entry points and
checks every result; any failed check raises, so the script exits
non-zero. Phases, one JSON line each:

1. device     the card's name and power limit (nvidia-smi)
2. build      all fourteen kernel sources in csrc/ compiled with nvcc, in
              parallel
3. kernels    each hand kernel against its plain PyTorch version on the
              card, bit-equal: pnc_apply and replica_join at the fast-path
              shapes, at the consensus path's submit and delta-apply shapes
              and at ragged ones; tusk_commit, causal_closure and dag_round
              (phase dag_kernels) on random states at four (N, W), on a
              constructed back-chain DAG, and on the recorded calls of real
              SafeKV rounds at 4 nodes and at 16 nodes, each with a crashed
              node; slot_union, orset_capture, orset_replay and orset_apply
              (phase orset_kernels) on random rows (full and non-canonical
              ones), hazard ops (duplicate tags, SENTINEL lanes, keys in
              [-K, 2K)), path A's ops all on one key, and the recorded calls
              of an OR-Set SafeKV run and an OR-Set store run; dirty_rows,
              delta_select, replica_join_rows and slot_union_rows (phase
              delta_kernels) on hazard ops, masks with no, all, exactly D
              and D+1 dirty rows at odd R and R=1, the row-list joins on
              those selections, and the recorded calls of a delta store
              run; rga_union, rga_union_rows, rga_apply, rga_compact and
              rga_order (phase rga_kernels) on random canonical and
              non-canonical rows, deep random trees (chains past
              max_depth, dangling and cyclic parents, dead interior nodes,
              invalid slots mid-row), full rows that drop, deletes before
              their insert, keys in [-K, 2K), and every call of the rga
              preset's first two ticks, its first compaction, tick 3's
              apply and compaction, a text and two delta ticks
4. fast_path  R=256 replicas, K=1024 keys, W=256 writers, B=1024 ops per
              replica: 80 engine ticks (apply + converge), checked against
              an independent numpy expectation
5. consensus  SafeKV for the PN-Counter at 4 nodes, window 8, 4000-op
              blocks, 100 keys: 64 rounds with half the ops safe, then idle
              rounds until drained; checked for acceptance, safe acks,
              identical total order, stable == prospective == numpy sum,
              and P and N per writer lane against a numpy scatter; the
              pnc_apply calls of its warm-up rounds are recorded and
              replayed through the kernel and its plain version, bit-equal;
              each consensus kernel must launch once per SafeKV round
6. orset_store  path B, the OR-Set anti-entropy store: R=64 replicas, K=500
              keys of 256 slots, B=64 ops per replica per tick in a Zipf
              hot window of 32 keys, 24 ticks of apply + full converge;
              replica rows bit-equal after every tick, the final state
              equal to an independent numpy model
7. orset_consensus  path A, SafeKV for the OR-Set at 4 nodes, window 8,
              8192-op blocks, 100 keys of 64 slots, capture width 4: the
              first 5 rounds bit-equal to the same run on the CPU (a GC
              advance and a compaction among them), 24 timed rounds, idle
              rounds until every view's stable state is bit-equal, rows
              canonical with no tag twice
8. store_delta  the delta anti-entropy store (harness preset mixed_delta):
              R=64 replicas, K=500 keys of a PN-Counter and of a 256-slot
              OR-Set, B=64 ops per type per replica per tick in a Zipf hot
              window of 32 keys; three Stores through fused_tick, one full
              converge per tick, one delta at D=64 and one at D=16 (every
              tick overflows), 24 ticks; every arm bit-equal to the full
              one after every tick and after sync_all, with the launches
              per tick, the dirty fractions and the overflow counts checked
9. rga_replay  harness preset rga (BASELINE config 5), uncut: R=1,024
              replicas, K=128 documents of 1,024 slots (2.95 GB), 16 insert
              and 16 delete lanes per replica per tick, 64 ticks of
              make_tick with a compaction every 4, the first off the clock,
              then 8 texts of document 0; a second arm through
              Store.fused_tick at dirty budget K; replicas and arms
              bit-equal, 256 live elements per document, nothing dropped,
              no depth overflow, the text of document 0 equal to an
              independent numpy model
10. profiler_check  the kernels torch.profiler saw over 20 calls of a
              plain torch kernel, and of causal_closure right after a
              profile of tusk_commit's plain version (the kernels line
              gives each wrapper's count beside its own launch count)
11. timing, the kernels line, the nvidia-smi line, and the result line.

Needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# non-tensor-core 32-bit rate, used for int32 max/add
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# ~50 ms at the H100's boost clock: longer than the host takes to queue a
# timed burst of 20 wrapper calls
SLEEP_CYCLES = 100_000_000

FAST = dict(R=256, K=1024, W=256, B=1024, ticks=80)
CONS = dict(nodes=4, window=8, ops_per_block=4000, keys=100, rounds=64,
            max_idle=64, profile_rounds=4, split_rounds=16)
# the consensus kernels' checks: random states per (N, W), and two recorded
# SafeKV runs with node N-1 crashed for rounds [crash[0], crash[1])
CONS_KERNELS = dict(shapes=((4, 8), (7, 6), (16, 8), (32, 16)), states=6)
RECORDED = (dict(nodes=4, window=8, ops_per_block=4000, keys=100, rounds=16,
                 crash=(4, 10)),
            dict(nodes=16, window=8, ops_per_block=500, keys=100, rounds=8,
                 crash=(2, 8)))
CONSENSUS_KERNELS = ("tusk_commit", "causal_closure", "dag_round")
# path B, the OR-Set anti-entropy store: R replicas, K keys of C slots, B
# uncaptured ops per replica per tick, Zipf keys in a rotating hot window
ORSET_STORE = dict(R=64, K=500, C=256, rm=8, B=64, hot=32, ticks=24,
                   recorded_ticks=2)
# path A, SafeKV for the OR-Set at the reference's peak geometry; the first
# cpu_rounds are held against the same run on the CPU
ORSET_CONS = dict(nodes=4, window=8, keys=100, ops_per_block=8192,
                  capacity=64, rm=4, budget=8, rounds=24, warmup=4,
                  cpu_rounds=5, min_idle=16, max_idle=64, profile_rounds=3,
                  recorded_rounds=6)
ORSET_KERNELS = ("slot_union", "orset_capture", "orset_replay", "orset_apply")
# the delta anti-entropy store, harness preset mixed_delta: R replicas, K
# keys of a PN-Counter (R writers) and an OR-Set (C slots), B ops per type
# per replica per tick in a Zipf hot window of budget/2 keys; a full arm,
# a delta arm at the budget and one at overflow_budget (every tick
# overflows)
STORE_DELTA = dict(R=64, K=500, C=256, rm=8, B=64, budget=64,
                   overflow_budget=16, ticks=24, recorded_ticks=2)
DELTA_KERNELS = ("dirty_rows", "delta_select", "replica_join_rows",
                 "slot_union_rows")
# harness preset rga (BASELINE config 5), uncut: R replicas, K documents,
# L insert and L delete lanes per replica per tick, deletes of the insert
# `lag` ticks back, a compaction every `compact_every` ticks, 64 ticks (the
# first off the clock), then `text_calls` texts of document 0; the
# profiler reads `profile_ticks` more ticks of the trace on a copy
RGA_REPLAY = dict(R=1024, K=128, lanes=16, lag=2, compact_every=4, ticks=64,
                  max_depth=8, text_calls=8, profile_ticks=2, seed=0)
RGA_KERNELS = ("rga_union", "rga_union_rows", "rga_apply", "rga_compact",
               "rga_order")
# the earlier wrappers the RGA path also runs, checked at its shapes
RGA_PATH_KERNELS = ("replica_join", "replica_join_rows", "dirty_rows",
                    "delta_select")
# the RGA kernels' random checks: unions (lead, Ca, Cb, canonical); trees
# (R, K, C, rows listed); applies (R, K, C, B, eff_ctr, canonical); deep
# trees for compaction and order (lead, C, depth, canonical)
RGA_CHECKS = dict(
    unions=(((3, 5), 6, 6, False), ((7,), 8, 8, True), ((2, 4), 5, 3, False),
            ((64, 128), 1024, 1024, True), ((4, 16), 300, 200, False)),
    trees=((1, 6, 16, 4), (2, 6, 16, 6), (3, 9, 16, 9), (5, 40, 64, 20),
           (8, 40, 64, 40)),
    applies=((3, 5, 8, 40, False, True), (4, 3, 6, 300, True, False),
             (64, 128, 1024, 32, False, True), (8, 7, 300, 64, True, True),
             (5, 2, 4, 24, False, False)),
    trees_deep=(((3, 5), 12, 4, True), ((2, 4), 9, 3, False),
                ((16, 128), 1024, 8, True), ((3, 7), 300, 8, False),
                ((2, 3), 8, 1, False), ((2, 2), 64, 32, True)))
RGA_LIBRARY_NOTES = {
    "rga_union": "no single PyTorch call computes it: an id-keyed union "
                 "with a max/OR fold and a capacity cut",
    "rga_union_rows": "no single PyTorch call computes it: an id-keyed "
                      "union with a max/OR fold over listed rows",
    "rga_apply": "no single PyTorch call computes it: a per-row sequential "
                 "apply with Lamport minting",
    "rga_compact": "no single PyTorch call computes it: a parent test and "
                   "a stable partition",
    "rga_order": "no single PyTorch call computes it: a path-key sort of "
                 "a tree",
}
# a row-list mode or another slot layout is its kernel's source with
# another entry point
SOURCES = {"replica_join_rows": "replica_join", "slot_union_rows": "slot_union",
           "rga_union": "slot_union", "rga_union_rows": "slot_union"}
# the TPU-era functions each hand kernel replaces
REPLACES = {
    "pnc_apply": "janus_tpu/models/pncounter.py:36",
    "replica_join": "janus_tpu/runtime/store.py:76",
    "tusk_commit": "janus_tpu/consensus/tusk.py:219",
    "causal_closure": "janus_tpu/runtime/safecrdt.py:349",
    "dag_round": "janus_tpu/consensus/dag.py:328",
    "slot_union": "janus_tpu/ops/setops.py:61",
    "orset_capture": "janus_tpu/models/orset.py:111",
    "orset_replay": "janus_tpu/models/orset.py:217",
    "orset_apply": "janus_tpu/models/orset.py:384",
    "dirty_rows": "janus_tpu/models/base.py:73",
    "delta_select": "janus_tpu/runtime/store.py:88",
    "replica_join_rows": "janus_tpu/runtime/store.py:114",
    "slot_union_rows": "janus_tpu/runtime/store.py:114",
    "rga_union": "janus_tpu/models/rga.py:189",
    "rga_union_rows": "janus_tpu/runtime/store.py:114",
    "rga_apply": "janus_tpu/models/rga.py:120",
    "rga_compact": "janus_tpu/models/rga.py:285",
    "rga_order": "janus_tpu/models/rga.py:208",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_cuda(fn, reps=20, warmup=3) -> float:
    """Mean milliseconds per call, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_reps(fn, budget_ms=300.0) -> int:
    """Calls of ``fn`` that fit ``budget_ms``, between 3 and 20, from one
    timed call (a slow plain version is timed over fewer calls)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = 1e3 * (time.perf_counter() - t0)
    return int(max(3, min(20, budget_ms // max(one, 1e-3))))


def device_profile(fn, reps=10):
    """(CUDA kernels seen, their device ms) over ``reps`` calls of an
    already warmed-up ``fn``, by torch.profiler; memcpy and memset are not
    counted."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def host_probe_ms(n=400):
    """Wall ms of a fixed host-only loop: ``n`` rounds of small CPU tensor
    ops through PyTorch's dispatcher, the kind of host work a tick's
    dispatch does, on no device. Timed beside the ticks, it tells whether
    their dispatch time follows the host's speed."""
    x = torch.zeros(16, dtype=torch.int32)
    t0 = time.perf_counter()
    for _ in range(n):
        x = torch.empty_like(x).copy_(x).add_(1)
    return 1e3 * (time.perf_counter() - t0)


def device_burst_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``, by CUDA events around
    ``reps`` calls queued behind a sleeping kernel: the host queues the
    whole burst before the device starts it, so the span holds no host
    time. Raises if the host took longer to queue than the device slept."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    slept = ev[0].elapsed_time(ev[1])
    check(host_ms < slept, f"device burst: queueing took {host_ms} ms, "
          f"longer than the {slept} ms sleep")
    return ev[1].elapsed_time(ev[2]) / reps


def kernel_operands(operands, fn, args):
    """(inputs, outputs): the tensors a wrapper hands its kernel, taken
    from the operand list it passes to ``operands.placement`` (absent
    optional inputs dropped), and the tensors it returns that are none of
    them. Calls ``fn`` once."""
    lists = []
    real = operands.placement

    def spy(name, ops):
        lists.append(list(ops))
        return real(name, lists[-1])

    operands.placement = spy
    try:
        out = fn(*args)
    finally:
        operands.placement = real
    check(len(lists) == 1, f"{len(lists)} operand lists in one wrapper call")
    ins = [t for _, t, _, _ in lists[0] if t is not None]
    outs = [t for t in tensors_of(out) if not any(t is x for x in ins)]
    return ins, outs


def wrap32(x: np.ndarray) -> np.ndarray:
    """int64 -> int32 with two's-complement wraparound."""
    return ((x + 2**31) % 2**32 - 2**31).astype(np.int32)


def rand_state(shape, dev, gen, lo=-(2**31), hi=2**31 - 1):
    return {f: torch.randint(lo, hi, shape, dtype=torch.int32, device=dev,
                             generator=gen) for f in "pn"}


def ragged_ops(rng, r, b, k, w, keys=None):
    """Keys in [-K, 2K), writers in [-W, 2W), op codes 0..3, amounts near
    INT32_MAX (wraparound), optionally few distinct keys (duplicates)."""
    shape = (r, b)
    return {
        "op": rng.integers(0, 4, shape),
        "key": (rng.integers(-k, 2 * k, shape) if keys is None
                else rng.choice(keys, shape)),
        "a0": rng.integers(2**31 - 100, 2**31 - 1, shape),
        "a1": np.zeros(shape), "a2": np.zeros(shape),
        "writer": rng.integers(-w, 2 * w, shape),
    }


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def pnc_err(kernels, state, ops) -> int:
    """Max abs difference of ``pnc_apply`` from its plain version on one
    input (``state`` takes the plain version's result)."""
    a = {f: v.clone() for f, v in state.items()}
    kernels.pnc_apply(a["p"], a["n"], ops)
    kernels.pnc_apply_plain(state["p"], state["n"], ops)
    torch.cuda.synchronize()
    return max(max_abs_err(a[f], state[f]) for f in "pn")


def pnc_case(kernels, cases, name, state, ops):
    """``pnc_apply`` against its plain version on one input, bit-equal."""
    err = pnc_err(kernels, state, ops)
    cases.append({"kernel": "pnc_apply", "case": name, "max_abs_err": err})
    check(err == 0, f"pnc_apply {name}: max_abs_err {err}")


def join_case(kernels, cases, name, state):
    """``replica_join`` against its plain version on one input, bit-equal."""
    a = {f: v.clone() for f, v in state.items()}
    kernels.replica_join(a["p"], a["n"])
    kernels.replica_join_plain(state["p"], state["n"])
    torch.cuda.synchronize()
    err = max(max_abs_err(a[f], state[f]) for f in "pn")
    cases.append({"kernel": "replica_join", "case": name, "max_abs_err": err})
    check(err == 0, f"replica_join {name}: max_abs_err {err}")


def kernel_checks(dev, kernels, workloads):
    """Each kernel bit-equal to its plain version on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    R, K, W, B = (FAST[k] for k in "RKWB")
    cases = []

    fast_ops = workloads.ops_to_device(workloads.pnc_uniform(rng, R, K, B), dev)
    pnc_case(kernels, cases, "fast_path", rand_state((R, K, W), dev, gen),
             fast_ops)
    join_case(kernels, cases, "fast_path", rand_state((R, K, W), dev, gen))
    for r, k, w, b, keys in ((5, 37, 13, 1000, None), (3, 33, 12, 4097, None),
                             (7, 11, 3, 999, np.array([0, 1, -1]))):
        ops = workloads.ops_to_device(ragged_ops(rng, r, b, k, w, keys), dev)
        near_max = rand_state((r, k, w), dev, gen, lo=2**31 - 1000)
        pnc_case(kernels, cases, f"R{r}_K{k}_W{w}_B{b}", near_max, ops)
        join_case(kernels, cases, f"R{r}_K{k}_W{w}",
                  rand_state((r, k, w), dev, gen))
    # the consensus path's shapes, keys drawn as that phase draws them: a
    # submit batch [N, B] (writer lane = node) and a delta-apply batch
    # [N, 4N*B] (SafeKV's default apply budget) holding blocks of every
    # origin node, a quarter of them masked to no-ops
    n, k, b = (CONS[x] for x in ("nodes", "keys", "ops_per_block"))
    for width, mixed in ((b, False), (4 * n * b, True)):
        host = workloads.pnc_uniform(rng, n, k, width)
        if mixed:
            host["writer"] = rng.integers(0, n, (n, width)).astype(np.int32)
            host["op"] = np.where(rng.random((n, width)) < 0.25, 0,
                                  host["op"]).astype(np.int32)
        pnc_case(kernels, cases, f"consensus_R{n}_K{k}_W{n}_B{width}",
                 rand_state((n, k, n), dev, gen, lo=-1000, hi=1000),
                 workloads.ops_to_device(host, dev))
    emit("kernels", cases=cases)
    return fast_ops, cases


def record_pnc_apply(pncounter, fn):
    """Run ``fn`` with the inputs of every PN-Counter ``pnc_apply`` call
    cloned just before the kernel runs; returns ``[(state, ops), ...]``."""
    calls = []
    real = pncounter.pnc_apply

    def recording(p, n, ops):
        calls.append(({"p": p.clone(), "n": n.clone()},
                      {f: v.clone() for f, v in ops.items()}))
        real(p, n, ops)

    pncounter.pnc_apply = recording
    try:
        fn()
    finally:
        pncounter.pnc_apply = real
    return calls


def replay_consensus_calls(kernels, cases, calls, n, b):
    """Replay the ``pnc_apply`` calls of real SafeKV rounds (submit: B
    columns; delta-apply: a multiple of B) through the kernel and its
    plain version, bit-equal. Each width must carry live ops of all N
    writer lanes, so a wrong writer index cannot pass unseen."""
    widths = sorted({ops["op"].shape[1] for _, ops in calls})
    check(len(widths) == 2 and widths[0] == b,
          f"consensus: pnc_apply widths {widths}, expected B={b} and a "
          f"delta-apply width")
    for width in widths:
        mine = [c for c in calls if c[1]["op"].shape[1] == width]
        live = [((ops["op"] == 1) | (ops["op"] == 2)) for _, ops in mine]
        writers = torch.cat([ops["writer"][m] for (_, ops), m in zip(mine, live)])
        lanes = torch.unique(writers).tolist()
        check(lanes == list(range(n)), f"consensus: live writer lanes "
              f"{lanes} in the recorded B={width} calls, expected 0..{n - 1}")
        err = max(pnc_err(kernels, state, ops) for state, ops in mine)
        name = f"consensus_recorded_R{n}_B{width}"
        cases.append({"kernel": "pnc_apply", "case": name, "max_abs_err": err,
                      "calls": len(mine),
                      "live_ops": int(sum(int(m.sum()) for m in live)),
                      "writer_lanes": lanes})
        check(err == 0, f"pnc_apply {name}: max_abs_err {err}")


def tree_map(fn, tree):
    """``fn`` on every tensor of a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def tensors_of(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_err(a, b) -> int:
    """Max abs difference over the tensors of two outputs of one shape."""
    ta, tb = tensors_of(a), tensors_of(b)
    check(len(ta) == len(tb) and all(x.shape == y.shape and x.dtype == y.dtype
                                     for x, y in zip(ta, tb)),
          "consensus kernel: outputs differ in structure")
    return max(max_abs_err(x, y) for x, y in zip(ta, tb) if x.numel())


def plain_of(kernels, name):
    return getattr(kernels, f"{name}_plain")


def record_calls(kernels, names, fn):
    """Run ``fn`` with the inputs of every call of the named wrappers
    (module attributes of ``kernels``, which the consensus and model
    modules call) cloned just before the call; returns
    ``{name: [(args, kwargs), ...]}``."""
    calls = {name: [] for name in names}
    real = {name: getattr(kernels, name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append(tree_map(torch.Tensor.clone, (args, kwargs)))
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(kernels, name, recorder(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(kernels, name, real[name])
    return calls


class CaseLog:
    """Per-kernel counts of the checks of the named kernels."""

    def __init__(self, names):
        self.by = {name: {"cases": 0, "max_abs_err": 0} for name in names}
        if "tusk_commit" in self.by:
            self.by["tusk_commit"]["committed_cases"] = 0

    def add(self, kernels, name, args, what, kwargs=None):
        """The kernel against its plain version on clones of one input,
        bit-equal, outputs and drop/overflow counts included (and the
        state a kernel updates in place); returns the kernel's output."""
        kwargs = kwargs or {}
        mine = tree_map(torch.Tensor.clone, (args, kwargs))
        ref = tree_map(torch.Tensor.clone, (args, kwargs))
        out = kernels.WRAPPERS[name](*mine[0], **mine[1])
        want = plain_of(kernels, name)(*ref[0], **ref[1])
        torch.cuda.synchronize()
        err = tree_err((mine, out), (ref, want))
        check(err == 0, f"{name} {what}: max_abs_err {err}")
        rec = self.by[name]
        rec["cases"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if name == "tusk_commit":  # a commit counter grew
            rec["committed_cases"] += bool(
                (out[4] != args[2]["commit_counter"]).any())
        return out


def run_recorded(dev, workloads, geo):
    """A SafeKV run for the PN-Counter at ``geo`` with node N-1 crashed
    for rounds in ``geo['crash']``; returns the finished SafeKV."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import pncounter
    from janus_tpu_torch.runtime.safecrdt import SafeKV

    n, w, b, k = (geo[x] for x in ("nodes", "window", "ops_per_block", "keys"))
    rng = np.random.default_rng(n)
    kv = SafeKV(DagConfig(n, w), pncounter.SPEC, ops_per_block=b, device=dev,
                num_keys=k, num_writers=n)
    lo, hi = geo["crash"]
    for t in range(geo["rounds"]):
        active = np.ones(n, bool)
        active[n - 1] = not lo <= t < hi
        ops = workloads.ops_to_device(workloads.pnc_uniform(rng, n, k, b), dev)
        kv.step(ops, rng.random((n, b)) < 0.5, active=active)
    return kv


def consensus_kernel_checks(dev, kernels, workloads, cases):
    """tusk_commit, causal_closure and dag_round against their plain
    versions on the card, bit-equal: (a) random states, (b) the
    constructed back-chain DAG, (c) the recorded calls of real SafeKV
    rounds. Returns the recorded calls of the 4-node run (the timing
    inputs of the kernels line)."""
    from janus_tpu_torch.consensus import DagConfig

    log = CaseLog(CONSENSUS_KERNELS)
    rng = np.random.default_rng(2)

    def on_dev(tree):
        return {f: torch.as_tensor(v, device=dev) for f, v in tree.items()}

    # (a) random states: anchors at rounds 0-2 and below, windows above 0,
    # int32 wraparound, masks present and absent, steps 2 and W//2
    for n, w in CONS_KERNELS["shapes"]:
        cfg = DagConfig(n, w)
        for i in range(CONS_KERNELS["states"]):
            dag, com, applied = (on_dev(x) if isinstance(x, dict) else
                                 torch.as_tensor(x, device=dev) for x in
                                 workloads.consensus_state(rng, n, w, wrap=i % 3 == 2))
            for steps in sorted({2, max(1, w // 2)}):
                log.add(kernels, "tusk_commit", (cfg, dag, com, i % 2, steps),
                        f"N{n} W{w} state {i} steps {steps}")
            log.add(kernels, "causal_closure", (cfg, dag, applied),
                    f"N{n} W{w} state {i}")
            masks = [torch.as_tensor(m, device=dev)
                     for m in workloads.round_masks(rng, n, w)]
            for keep in ((0, 0, 0), (1, 1, 1), (1, 0, 0), (0, 1, 1)):
                sel = [m if k else None for m, k in zip(masks, keep)]
                log.add(kernels, "dag_round", (cfg, dag, *sel),
                        f"N{n} W{w} state {i} masks {keep}")

    # (b) wave 0's leader lacks support and wave 1's anchor chains it
    cfg = DagConfig(4, 8)
    dag, com = (on_dev(x) for x in workloads.backchain_state(4, 8, seed=0))
    out = log.add(kernels, "tusk_commit", (cfg, dag, com, 0, 2), "back-chain")
    seqs = sorted(torch.unique(out[1][out[0]]).tolist())
    check(out[4].tolist() == [2] * 4 and seqs == [0, 1],
          f"back-chain: counters {out[4].tolist()} and sequence numbers "
          f"{seqs}, expected 2 each and [0, 1]")
    backchain = {"commit_counter": out[4].tolist(), "commit_seqs": seqs}

    # (c) the calls real rounds make, with a crashed node
    recorded = {}
    for geo in RECORDED:
        calls = record_calls(kernels, CONSENSUS_KERNELS,
                             lambda: run_recorded(dev, workloads, geo))
        torch.cuda.synchronize()
        tag = f"N{geo['nodes']}_B{geo['ops_per_block']}"
        for name in CONSENSUS_KERNELS:
            check(len(calls[name]) == geo["rounds"],
                  f"recorded {tag}: {len(calls[name])} {name} calls in "
                  f"{geo['rounds']} rounds")
            outs = [log.add(kernels, name, args, f"recorded {tag} round {j}")
                    for j, (args, _) in enumerate(calls[name])]
            if name == "tusk_commit":
                committing = sum(bool((out[4] != args[2]["commit_counter"]).any())
                                 for out, (args, _) in zip(outs, calls[name]))
        bases = [args[1]["base_round"].item() for args, _ in calls["tusk_commit"]]
        crashed = sum(args[2] is not None and not bool(args[2].all())
                      for args, _ in calls["dag_round"])
        check(crashed > 0 and committing > 0, f"recorded {tag}: {crashed} "
              f"rounds with a crashed node, {committing} committing calls")
        recorded[tag] = {"rounds": geo["rounds"], "crashed_rounds": crashed,
                         "committing_calls": committing,
                         "max_base_round": max(bases)}
        if geo["nodes"] == CONS["nodes"]:
            timing_calls = calls
    committed = log.by["tusk_commit"]["committed_cases"]
    check(committed > 0, "tusk_commit: no checked case committed anything")
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "dag_kernels", **rec})
    emit("dag_kernels", by_kernel=log.by, backchain=backchain,
         recorded=recorded)
    return timing_calls


def fast_path(dev, kernels, workloads):
    from janus_tpu_torch.models import pncounter
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import replicated_init

    R, K, W, B, ticks = (FAST[k] for k in ("R", "K", "W", "B", "ticks"))
    rng = np.random.default_rng(0)
    host_ops = [workloads.pnc_uniform(rng, R, K, B) for _ in range(4)]
    ops = [workloads.ops_to_device(o, dev) for o in host_ops]
    kernels.reset_launches()
    state = replicated_init(pncounter.SPEC, R, device=dev, num_keys=K,
                            num_writers=W)
    tick = make_tick(pncounter.SPEC, device=dev)
    state = tick(state, ops[0])  # warm-up tick
    torch.cuda.synchronize()
    before = kernels.launches()
    t0 = time.perf_counter()
    for i in range(ticks):
        state = tick(state, ops[i % len(ops)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launches()
    for name in ("pnc_apply", "replica_join"):
        grew = launches[name] - before[name]
        check(grew == ticks, f"fast path: {name} launched {grew} times "
              f"in {ticks} ticks")

    # independent expectation: every tick's ops (the warm-up tick's
    # included) added into one [K, W]; the writer lane is the replica id
    uses = [len(range(i, ticks, len(ops))) + (i == 0) for i in range(len(ops))]
    exp = {f: np.zeros((K, W), np.int64) for f in "pn"}
    for o, u in zip(host_ops, uses):
        for f, code in (("p", 1), ("n", 2)):
            m = o["op"] == code
            np.add.at(exp[f], (o["key"][m], o["writer"][m]),
                      u * o["a0"][m].astype(np.int64))
    for f in "pn":
        x = state[f]
        check(torch.equal(x, x[:1].expand_as(x)),
              f"fast path: replica rows of {f} differ")
        check(np.array_equal(x[0].cpu().numpy(), wrap32(exp[f])),
              f"fast path: {f} differs from the numpy expectation")
    value = pncounter.value(state).cpu().numpy()
    exp_value = wrap32(exp["p"].sum(1) - exp["n"].sum(1))
    check((value == exp_value[None]).all(), "fast path: value != sum(inc) - sum(dec)")
    emit("fast_path", replicas=R, keys=K, writers=W, ops_per_replica=B,
         ticks=ticks, seconds=dt, ms_per_tick=1e3 * dt / ticks,
         converged_ops_per_s=R * B * ticks / dt,
         launches={k: launches[k] - before[k] for k in launches},
         launches_incl_warmup=launches)
    return launches


def cuda_kernels_of(fn) -> int:
    """CUDA kernels the profiler sees in one call of ``fn`` (memcpy and
    memset included, as the consensus phase counts them)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def consensus_path(dev, kernels, workloads, cases):
    from janus_tpu_torch.consensus import DagConfig, tusk
    from janus_tpu_torch.consensus import dag as dagmod
    from janus_tpu_torch.models import pncounter
    from janus_tpu_torch.runtime.safecrdt import COMMIT_STEPS, SafeKV

    n, w, b, k = (CONS[x] for x in ("nodes", "window", "ops_per_block", "keys"))
    rounds = CONS["rounds"]
    rng = np.random.default_rng(1)

    def make_kv():
        return SafeKV(DagConfig(n, w), pncounter.SPEC, ops_per_block=b,
                      device=dev, num_keys=k, num_writers=n)

    host = [workloads.pnc_uniform(rng, n, k, b) for _ in range(rounds)]
    batches = [workloads.ops_to_device(o, dev) for o in host]
    safe = [rng.random((n, b)) < 0.5 for _ in range(rounds)]  # half safe
    idle = workloads.ops_to_device(
        {f: np.zeros((n, b), np.int32) for f in host[0]}, dev)

    # first-use costs of torch's kernels, off the clock; the warm-up rounds'
    # pnc_apply calls are recorded and replayed against the plain version
    warm = make_kv()
    calls = record_pnc_apply(pncounter, lambda: [
        warm.step(batches[t], safe[t]) for t in range(4)])
    torch.cuda.synchronize()
    replay_consensus_calls(kernels, cases, calls, n, b)
    emit("consensus_kernels", cases=cases[-2:])

    kernels.reset_launches()
    kv = make_kv()
    safe_sent = np.zeros(n, np.int64)
    safe_acked = np.zeros(n, np.int64)
    t0 = time.perf_counter()
    for t in range(rounds):
        info = kv.step(batches[t], safe[t])
        check(info["accepted"].all(), f"consensus: round {t} batch rejected")
        safe_sent += safe[t].sum(1)
        safe_acked += kv.drain_safe_acks().sum((0, 2))
    dt = time.perf_counter() - t0
    expect = np.zeros(k, np.int64)
    for o in host:
        sign = np.where(o["op"] == 1, 1, np.where(o["op"] == 2, -1, 0))
        np.add.at(expect, o["key"].ravel(), (sign * o["a0"]).ravel())
    expect = wrap32(expect)
    idle_rounds = 0
    while True:
        prosp = kv.query_prospective("get").cpu().numpy()
        stable = kv.query_stable("get").cpu().numpy()
        orders = [kv.ordered_commits(v) for v in range(n)]
        drained = (len(kv.latency_log) == rounds * n
                   and (prosp == stable).all()
                   and all(o == orders[0] for o in orders))
        if drained or idle_rounds == CONS["max_idle"]:
            break
        kv.step(idle, record=False)
        safe_acked += kv.drain_safe_acks().sum((0, 2))
        idle_rounds += 1
    torch.cuda.synchronize()
    launches = kernels.launches()
    check(drained, f"consensus: not drained after {idle_rounds} idle rounds")
    check((safe_acked == safe_sent).all(),
          f"consensus: safe acks {safe_acked.tolist()} != sent {safe_sent.tolist()}")
    check((prosp == expect[None]).all() and (stable == expect[None]).all(),
          "consensus: values differ from the numpy sum of accepted ops")
    check(launches["pnc_apply"] > 0, "consensus: pnc_apply never launched")
    stepped = rounds + idle_rounds
    for name in CONSENSUS_KERNELS:  # one launch each per SafeKV round
        check(launches[name] == stepped, f"consensus: {name} launched "
              f"{launches[name]} times in {stepped} SafeKV rounds")
    # per writer lane: P and N of every view, prospective and stable, equal
    # an independent numpy scatter over [key, writer]
    exp_lane = {f: np.zeros((k, n), np.int64) for f in "pn"}
    for o in host:
        for f, code in (("p", 1), ("n", 2)):
            m = o["op"] == code
            np.add.at(exp_lane[f], (o["key"][m], o["writer"][m]),
                      o["a0"][m].astype(np.int64))
    for name, st in (("prospective", kv.prospective), ("stable", kv.stable)):
        for f in "pn":
            check(np.array_equal(st[f].cpu().numpy(),
                                 np.broadcast_to(wrap32(exp_lane[f]), (n, k, n))),
                  f"consensus: {name} {f} differs per writer lane from the "
                  f"numpy scatter")
    lag = kv.commit_latencies()

    # no host synchronisation while a round is queued (the one fetch per
    # round is in step_absorb)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pending = [kv.step_dispatch(batches[t], safe[t]) for t in range(4)]
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message)[:160] for c in caught
             if "synchroniz" in str(c.message).lower()]
    for packed, meta in pending:
        kv.step_absorb(packed, meta)
    check(not syncs, f"consensus: host syncs inside step_dispatch: {syncs[:3]}")

    # a round's wall time, split: dispatch (every launch queued), drain
    # (the device finishing the queue), absorb (the one fetch and the host
    # bookkeeping)
    split = dict.fromkeys(("dispatch", "drain", "absorb"), 0.0)
    for t in range(CONS["split_rounds"]):
        t0 = time.perf_counter()
        packed, meta = kv.step_dispatch(batches[t], safe[t])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kv.step_absorb(packed, meta)
        t3 = time.perf_counter()
        for part, sec in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[part] += 1e3 * sec / CONS["split_rounds"]

    # launches per round, counted by the profiler over a few rounds
    n_prof = CONS["profile_rounds"]
    from torch.profiler import ProfilerActivity, profile
    before = kernels.launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n_prof):
            kv.step(batches[4 + t], safe[4 + t])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    # the hand kernels the profiler saw, beside the wrappers' own counts
    hand_seen = {name: [sum(f"{name}_kernel" in e.name for e in dev_events),
                        kernels.launches()[name] - before[name]]
                 for name in kernels.WRAPPERS}
    memcpy = sum(1 for e in dev_events if "memcpy" in e.name.lower()
                 or "memset" in e.name.lower())
    dev_us = sum(e.time_range.elapsed_us() for e in dev_events)

    # the functional phases of a round, each alone on the current state
    cfg = kv.cfg
    by_phase = {
        "state_transfer": cuda_kernels_of(lambda: kv._state_transfer(
            kv.prospective, kv.stable, kv.dag, kv.commit, kv.prosp_applied,
            kv.stable_applied, kv.force_transfer)),
        "round_step": cuda_kernels_of(lambda: dagmod.round_step(cfg, kv.dag)),
        "causal_closure": cuda_kernels_of(
            lambda: kv._causal_closure(kv.dag, kv.prosp_applied)),
        "commit_view": cuda_kernels_of(lambda: tusk.commit_view(
            cfg, kv.dag, kv.commit, seed=kv.seed, steps=COMMIT_STEPS)),
    }
    per_round = (len(dev_events) - memcpy) / n_prof
    by_phase["rest"] = per_round - sum(by_phase.values())
    emit("consensus", nodes=n, window=w, ops_per_block=b, keys=k,
         rounds=rounds, idle_rounds_to_drain=idle_rounds, seconds=dt,
         ms_per_round=1e3 * dt / rounds,
         ops_per_s=rounds * n * b / dt,
         safe_ops_per_s=float(safe_sent.sum()) / dt,
         commit_lag_ticks_p50=float(np.percentile(lag, 50)),
         commit_lag_ticks_p99=float(np.percentile(lag, 99)),
         blocks_committed=int(lag.size), launches=launches,
         host_syncs_in_dispatch=len(syncs),
         profiled_rounds=n_prof,
         cuda_kernels_per_round=per_round,
         cuda_memcpy_memset_per_round=memcpy / n_prof,
         cuda_kernels_by_phase=by_phase,
         hand_kernels_seen_and_launched=hand_seen,
         profiled_device_us_per_round=dev_us / n_prof,
         split_rounds=CONS["split_rounds"],
         ms_per_round_split={f"{k}_ms": v for k, v in split.items()},
         gc_base_round=kv.base_round(), stats=kv.stats)
    return launches


def orset_kernel_checks(dev, kernels, workloads, cases):
    """slot_union, orset_capture, orset_replay and orset_apply against
    their plain versions on the card, bit-equal: (a) random canonical rows
    at several (K, C, B, r_cap), full rows among them, and non-canonical
    rows; (b) duplicate tags, SENTINEL lanes and keys in [-K, 2K); (c) all
    of path A's ops on one key at B=8192; (d) the recorded calls of a path
    A run and a path B run. Returns, per kernel, the (args, kwargs) of the
    recorded call the kernels line times."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.runtime.store import replicated_init
    from janus_tpu_torch.utils.ids import TagMinter

    log = CaseLog(ORSET_KERNELS)
    rng = np.random.default_rng(9)

    def on_dev(tree):
        return {f: torch.as_tensor(np.asarray(v), device=dev)
                for f, v in tree.items()}

    def slots(shape, c, **kw):
        return on_dev(workloads.orset_slots(rng, shape, c, **kw))

    def captured(st, ops, r_cap):
        cap = kernels.orset_capture_plain(st, ops, r_cap)
        host = {f: x.cpu().numpy() for f, x in ops.items()}
        host.update({f: x.cpu().numpy() for f, x in
                     zip(("rm_rep", "rm_ctr", "rm_elem"), cap)})
        return on_dev(workloads.with_capture_hazards(rng, host))

    # (a) + (b): random rows, hazard ops
    for lead, ca, cb, cap, canon in (((4, 100), 64, 64, 64, True),
                                     ((8, 500), 256, 256, 256, True),
                                     ((3, 5), 6, 6, 6, False),
                                     ((2, 4), 5, 3, 8, False)):
        a = slots(lead, ca, canonical=canon, dup_rows=0.3, full_rows=0.4)
        b = slots(lead, cb, canonical=canon, dup_rows=0.3, full_rows=0.4)
        log.add(kernels, "slot_union", (a, b, cap),
                f"random {'x'.join(map(str, lead))} C{ca}+{cb}->{cap}")
    for v, k, c, b, r_cap, canon in ((4, 100, 64, 8192, 4, True),
                                     (3, 5, 6, 24, 3, True),
                                     (2, 4, 8, 32, 8, False),
                                     (1, 7, 8, 16384, 2, True)):
        st = slots((v, k), c, canonical=canon, full_rows=0.4)
        ops = on_dev(workloads.orset_mixed_ops(rng, (v, b), k, c))
        log.add(kernels, "orset_capture", (st, ops, r_cap),
                f"random V{v} K{k} C{c} B{b} r{r_cap}")
        if b <= 8192:
            log.add(kernels, "orset_replay", (st, captured(st, ops, r_cap)),
                    f"random V{v} K{k} C{c} B{b} r{r_cap}")
    for r, k, c, b, canon in ((8, 500, 256, 64, True), (3, 5, 6, 24, False),
                              (4, 2, 4, 32, True)):
        st = slots((r, k), c, canonical=canon, full_rows=0.5)
        ops = on_dev(workloads.orset_mixed_ops(rng, (r, b), k, c))
        log.add(kernels, "orset_apply", (st, ops), f"random R{r} K{k} C{c} B{b}")

    # (c) path A's ops all on one key
    n, k, b, c, r_cap = (ORSET_CONS[x] for x in
                         ("nodes", "keys", "ops_per_block", "capacity", "rm"))
    minters = [TagMinter(i) for i in range(n)]
    hot = workloads.orset_add_remove(rng, minters, k, b)
    hot["key"][:] = 0
    st = slots((n, k), c, full_rows=0.5)
    ops = on_dev(hot)
    log.add(kernels, "orset_capture", (st, ops, r_cap), "hot key B8192")
    cap_ops = dict(ops, **dict(zip(("rm_rep", "rm_ctr", "rm_elem"),
                                   kernels.orset_capture_plain(st, ops, r_cap))))
    out, _ = log.add(kernels, "orset_replay", (st, cap_ops), "hot key B8192")
    log.add(kernels, "orset_apply", (st, ops), "hot key B8192")
    log.add(kernels, "slot_union",
            ({f: x[:2] for f, x in out.items()},
             {f: x[2:] for f, x in out.items()}, c), "hot key replayed views")

    # (d) recorded calls of the two paths
    def path_a():
        kv = SafeKV(DagConfig(n, ORSET_CONS["window"]), orset.SPEC,
                    ops_per_block=b, apply_budget=ORSET_CONS["budget"],
                    collect_logs=False, device=dev, num_keys=k, capacity=c,
                    rm_capacity=r_cap)
        mint = [TagMinter(i) for i in range(n)]
        for _ in range(ORSET_CONS["recorded_rounds"]):
            kv.step(workloads.ops_to_device(
                workloads.orset_add_remove(rng, mint, k, b), dev))

    R, K, C, B = (ORSET_STORE[x] for x in "RKCB")

    def path_b():
        state = replicated_init(orset.SPEC, R, device=dev, num_keys=K,
                                capacity=C, rm_capacity=ORSET_STORE["rm"])
        tick = make_tick(orset.SPEC, device=dev)
        mint = [TagMinter(i) for i in range(R)]
        for t in range(ORSET_STORE["recorded_ticks"]):
            tick(state, workloads.ops_to_device(workloads.orset_hot_window(
                rng, mint, K, B, t, ORSET_STORE["hot"]), dev))

    timing = {}
    for path, fn, names in (("A", path_a, ("orset_capture", "orset_replay")),
                            ("B", path_b, ("orset_apply", "slot_union"))):
        calls = record_calls(kernels, names, fn)
        torch.cuda.synchronize()
        for name in names:
            check(calls[name], f"recorded path {path}: no {name} call")
            for j, (args, kw) in enumerate(calls[name]):
                log.add(kernels, name, args, f"recorded path {path}", kw)
        if path == "A":
            timing["orset_capture"] = calls["orset_capture"][-1]
            # the widest replay: a delta apply of the whole budget
            timing["orset_replay"] = max(
                calls["orset_replay"], key=lambda c: c[0][1]["op"].shape[1])
        else:
            timing["orset_apply"] = calls["orset_apply"][-1]
            timing["slot_union"] = calls["slot_union"][0]  # first level
            levels = int(np.ceil(np.log2(R)))
            check(len(calls["slot_union"]) == levels * ORSET_STORE["recorded_ticks"],
                  f"recorded path B: {len(calls['slot_union'])} slot_union "
                  f"calls in {ORSET_STORE['recorded_ticks']} ticks")
        del calls
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "orset_kernels",
                      "cases": rec["cases"], "max_abs_err": rec["max_abs_err"]})
    emit("orset_kernels", by_kernel=log.by)
    return timing


def orset_store_model(host_ops, R, K, C):
    """Independent numpy model of path B: each tick, every replica applies
    its ops in lane order to its copy of the converged rows (add: set the
    elem of a present tag, else insert and keep the C smallest tags;
    remove/clear: tombstone), then the rows of all replicas are united per
    key, a tag's tombstone ORed over its copies, the C smallest tags kept.
    Returns ``{field: [K, C] array}`` in the canonical layout."""
    SENT = np.iinfo(np.int32).max
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, bool))
    rows = {}  # key -> (tag int64 sorted, elem, removed)
    for ops in host_ops:
        touched = {}
        for r in range(R):
            mine = {}
            for b in range(ops["op"].shape[1]):
                key, op = int(ops["key"][r, b]), int(ops["op"][r, b])
                if key not in mine:
                    tag, el, rm = rows.get(key, empty)
                    mine[key] = [tag.copy(), el.copy(), rm.copy()]
                tag, el, rm = mine[key]
                a0 = int(ops["a0"][r, b])
                if op == 1:
                    t = (int(ops["a1"][r, b]) << 32) + int(ops["a2"][r, b])
                    at = int(np.searchsorted(tag, t))
                    if at < tag.size and tag[at] == t:
                        el[at] = a0
                    else:
                        mine[key] = [np.insert(tag, at, t)[:C],
                                     np.insert(el, at, a0)[:C],
                                     np.insert(rm, at, False)[:C]]
                elif op == 2:
                    rm |= el == a0
                elif op == 3:
                    rm[:] = True
            for key, row in mine.items():
                touched.setdefault(key, []).append(row)
        for key, rs in touched.items():
            if len(rs) < R:  # replicas that did not touch the key hold it
                rs.append(list(rows.get(key, empty)))
            tag = np.concatenate([x[0] for x in rs])
            el = np.concatenate([x[1] for x in rs])
            rm = np.concatenate([x[2] for x in rs])
            order = np.argsort(tag, kind="stable")
            tag, el, rm = tag[order], el[order], rm[order]
            uniq, first = np.unique(tag, return_index=True)
            rm_or = np.logical_or.reduceat(rm, first)
            rows[key] = (uniq[:C], el[first][:C], rm_or[:C])
    out = {"tag_rep": np.full((K, C), SENT, np.int32),
           "tag_ctr": np.full((K, C), SENT, np.int32),
           "elem": np.zeros((K, C), np.int32),
           "removed": np.zeros((K, C), bool), "valid": np.zeros((K, C), bool)}
    for key, (tag, el, rm) in rows.items():
        m = tag.size
        out["tag_rep"][key, :m] = tag >> 32
        out["tag_ctr"][key, :m] = tag & 0xFFFFFFFF
        out["elem"][key, :m] = el
        out["removed"][key, :m] = rm
        out["valid"][key, :m] = True
    return out


def orset_store(dev, kernels, workloads):
    """Path B timed: the OR-Set anti-entropy store at R=64 replicas, K=500
    keys of 256 slots, B=64 uncaptured ops per replica per tick in a Zipf
    hot window of 32 keys, a full converge every tick. Replica rows are
    checked bit-equal after every tick, the final state against the numpy
    model."""
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import replicated_init
    from janus_tpu_torch.utils.ids import TagMinter

    R, K, C, B, hot, ticks = (ORSET_STORE[x] for x in
                              ("R", "K", "C", "B", "hot", "ticks"))
    rng = np.random.default_rng(3)
    minters = [TagMinter(i) for i in range(R)]
    host = [workloads.orset_hot_window(rng, minters, K, B, t, hot)
            for t in range(ticks + 1)]
    ops = [workloads.ops_to_device(o, dev) for o in host]
    state = replicated_init(orset.SPEC, R, device=dev, num_keys=K, capacity=C,
                            rm_capacity=ORSET_STORE["rm"])
    tick = make_tick(orset.SPEC, device=dev)
    kernels.reset_launches()
    state = tick(state, ops[0])  # warm-up tick
    torch.cuda.synchronize()
    before = kernels.launches()
    tick_ms = []
    for t in range(1, ticks + 1):
        t0 = time.perf_counter()
        state = tick(state, ops[t])
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for f in ("tag_rep", "tag_ctr", "elem", "removed", "valid"):
            x = state[f]
            check(torch.equal(x, x[:1].expand_as(x)),
                  f"orset_store: replica rows of {f} differ after tick {t}")
    launches = kernels.launches()
    grew = {name: launches[name] - before[name] for name in launches}
    levels = int(np.ceil(np.log2(R)))
    check(grew["orset_apply"] == ticks and grew["slot_union"] == levels * ticks,
          f"orset_store: {grew['orset_apply']} orset_apply and "
          f"{grew['slot_union']} slot_union launches in {ticks} ticks, "
          f"expected 1 and {levels} per tick")
    t0 = time.perf_counter()
    want = orset_store_model(host, R, K, C)
    model_s = time.perf_counter() - t0
    for f, x in want.items():
        check(np.array_equal(state[f][0].cpu().numpy(), x),
              f"orset_store: {f} differs from the numpy model")
    dt = sum(tick_ms) / 1e3
    live = int(orset.live_count(state)[0].sum())
    emit("orset_store", replicas=R, keys=K, capacity=C, ops_per_replica=B,
         hot_window=hot, ticks=ticks, seconds=dt, ms_per_tick=1e3 * dt / ticks,
         ms_per_tick_min=min(tick_ms), ms_per_tick_max=max(tick_ms),
         converged_ops_per_s=R * B * ticks / dt,
         launches_per_tick={"orset_apply": grew["orset_apply"] / ticks,
                            "slot_union": grew["slot_union"] / ticks},
         state_mb=R * K * C * 14 / 1e6, live_tags=live,
         occupied_slots=int(orset.element_count(state)[0].sum()),
         model_seconds=model_s, launches_incl_warmup=launches)
    return launches


def delta_kernel_checks(dev, kernels, workloads, cases):
    """dirty_rows, delta_select, replica_join_rows and slot_union_rows
    against their plain versions on the card, bit-equal, counts and
    accumulators included: (a) random ops with keys in [-K, 2K) and
    no-ops, into fresh and running masks; (b) selections of random masks,
    of no dirty row, every row, exactly D and D+1 dirty rows, at odd R, R=1
    and K past one block's threads; (c) the row-list joins on the rows
    those selections give: the PN-Counter's kernel on random states, the
    OR-Set's halving tree run once through the kernel and once through its
    plain version at R = 1, 2 (level 1 writes in place), 3, 5 and 8; (d)
    every call of a 2-tick run of the delta store at the mixed_delta
    geometry. Returns, per kernel, the (args, kwargs) of the recorded call
    the kernels line times."""
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.store import Store
    from janus_tpu_torch.utils.ids import TagMinter

    log = CaseLog(DELTA_KERNELS)
    rng = np.random.default_rng(11)
    g = STORE_DELTA
    R, K, C, B, D = (g[x] for x in ("R", "K", "C", "B", "budget"))

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    def mask(r, k, p=0.0, n_dirty=None):
        m = rng.random((r, k)) < p
        if n_dirty is not None:  # exactly n_dirty keys, each in one replica
            m[rng.integers(0, r, n_dirty),
              rng.choice(k, n_dirty, replace=False)] = True
        return torch.as_tensor(m, device=dev)

    def zeros():
        return torch.zeros((), dtype=torch.int32, device=dev)

    # (a) dirty marks
    for r, k, b in ((R, K, B), (5, 37, 333), (1, 3000, 4097)):
        op = i32(rng.integers(0, 3, (r, b)))
        key = i32(rng.integers(-k, 2 * k, (r, b)))
        log.add(kernels, "dirty_rows", (op, key, k), f"fresh R{r} K{k} B{b}")
        log.add(kernels, "dirty_rows", (op, key, k), f"running R{r} K{k} B{b}",
                {"out": mask(r, k, 0.05)})

    # (b) selections, (c) the PN-Counter's row-list join on each
    masks = {"random": mask(R, K, 0.002), "zero": mask(R, K),
             "all": mask(R, K, 1.0), "count_D": mask(R, K, n_dirty=D),
             "count_D+1": mask(R, K, n_dirty=D + 1), "R5": mask(5, K, 0.01),
             "R1": mask(1, K, 0.05), "R3_K3000": mask(3, 3000, 0.01)}
    sel = {}
    for name, m in masks.items():
        sel[name] = log.add(kernels, "delta_select", (m, D), name,
                            {"clear": True, "acc_count": zeros(),
                             "acc_overflow": zeros()})
        r, k = m.shape
        w = 7 if name == "R5" else 64  # the scalar path, and the vector one
        st = rand_state((r, k, w), dev,
                        torch.Generator(device=dev).manual_seed(r))
        log.add(kernels, "replica_join_rows",
                (st["p"], st["n"], sel[name].order, sel[name].n_join), name)
    counts = {name: (int(s.count), bool(s.overflowed), int(s.n_join))
              for name, s in sel.items()}
    check(counts["zero"] == (0, False, 0) and counts["all"] == (K, True, K)
          and counts["count_D"] == (D, False, D)
          and counts["count_D+1"] == (D + 1, True, K),
          f"delta_select: count, overflowed, n_join {counts}")

    # (c) the OR-Set's tree, kernel against plain, on small states
    tree_cases = []
    k, c, d = 64, 32, 16
    for r in (1, 2, 3, 5, 8):
        for what, m in (("random", mask(r, k, 0.05)), ("zero", mask(r, k)),
                        ("all", mask(r, k, 1.0)),
                        ("count_D", mask(r, k, n_dirty=d)),
                        ("count_D+1", mask(r, k, n_dirty=d + 1))):
            s = kernels.delta_select(m, d)
            st = {f: torch.as_tensor(x, device=dev) for f, x in
                  workloads.orset_slots(rng, (r, k), c, canonical=False,
                                        dup_rows=0.3).items()}
            st["_rm_cap"] = torch.zeros((r, 4, 0), dtype=torch.int32,
                                        device=dev)
            mine = tree_map(torch.Tensor.clone, st)
            ref = tree_map(torch.Tensor.clone, st)
            orset.join_replica_rows(mine, s.order, s.n_join)
            real = kernels.slot_union_rows
            kernels.slot_union_rows = kernels.slot_union_rows_plain
            try:
                orset.join_replica_rows(ref, s.order, s.n_join)
            finally:
                kernels.slot_union_rows = real
            torch.cuda.synchronize()
            err = tree_err(mine, ref)
            check(err == 0, f"slot_union_rows tree R{r} {what}: "
                  f"max_abs_err {err}")
            check(tuple(mine["_rm_cap"].shape) == (r, 4, 0),
                  "slot_union_rows tree: _rm_cap reshaped")
            tree_cases.append(f"R{r} {what}")

    # (d) the recorded calls of a 2-tick delta store run
    types = {"pnc": dict(num_keys=K, num_writers=R),
             "orset": dict(num_keys=K, capacity=C, rm_capacity=g["rm"])}

    def run():
        store = Store(R, types, dirty_budget=D, device=dev)
        minters = [TagMinter(i) for i in range(R)]
        for t in range(g["recorded_ticks"]):
            ops = workloads.store_delta_tick(rng, minters, K, B, t, D // 2)
            store.fused_tick({tc: workloads.ops_to_device(o, dev)
                              for tc, o in ops.items()})

    calls = record_calls(kernels, DELTA_KERNELS, run)
    torch.cuda.synchronize()
    ticks = g["recorded_ticks"]
    levels = int(np.ceil(np.log2(R)))
    want = {"dirty_rows": 2 * ticks, "delta_select": 2 * ticks,
            "replica_join_rows": ticks, "slot_union_rows": levels * ticks}
    got = {name: len(c) for name, c in calls.items()}
    check(got == want, f"recorded store_delta: calls {got}, expected {want}")
    for name, recorded in calls.items():
        for j, (args, kw) in enumerate(recorded):
            log.add(kernels, name, args, f"recorded store_delta call {j}", kw)
    timing = {name: recorded[-1] for name, recorded in calls.items()}
    # the first level of the OR-Set's tree: it gathers from the state
    timing["slot_union_rows"] = calls["slot_union_rows"][0]
    del calls
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "delta_kernels",
                      "cases": rec["cases"], "max_abs_err": rec["max_abs_err"]})
    emit("delta_kernels", by_kernel=log.by, selections=counts,
         slot_union_rows_tree_cases=tree_cases)
    return timing


def store_delta(dev, kernels, workloads):
    """The port's run_store_delta at harness preset mixed_delta: three
    Stores on the card get the same pre-generated two-type op streams
    through fused_tick (24 timed ticks after one warm-up tick, the arms in
    turns): one converges every row every tick, one only the dirty rows
    at the budget D=64, one at D=16, which overflows every tick and falls
    back to all rows. Replica rows are checked equal after every tick, and
    every arm equal to the full arm; after sync_all every leaf of every
    type is bit-equal across the arms (the harness's gate)."""
    from janus_tpu_torch.runtime.store import Store
    from janus_tpu_torch.utils.ids import TagMinter

    g = STORE_DELTA
    R, K, C, B, D, ticks = (g[x] for x in
                            ("R", "K", "C", "B", "budget", "ticks"))
    hot = D // 2
    types = {"pnc": dict(num_keys=K, num_writers=R),
             "orset": dict(num_keys=K, capacity=C, rm_capacity=g["rm"])}
    rng = np.random.default_rng(12)
    minters = [TagMinter(i) for i in range(R)]
    host = [workloads.store_delta_tick(rng, minters, K, B, t, hot)
            for t in range(ticks + 1)]
    batches = [{tc: workloads.ops_to_device(o, dev) for tc, o in h.items()}
               for h in host]
    kernels.reset_launches()
    over = g["overflow_budget"]
    arms = {"full": (Store(R, types, device=dev), False),
            f"delta_D{D}": (Store(R, types, dirty_budget=D, device=dev), True),
            f"delta_D{over}": (Store(R, types, dirty_budget=over, device=dev),
                               True)}
    for st, use_delta in arms.values():  # warm-up tick, off the clock
        st.fused_tick(batches[0], delta=use_delta)
        st.flush_metrics()
    torch.cuda.synchronize()
    tick_ms = {name: [] for name in arms}
    dispatch_ms = {name: [] for name in arms}  # until fused_tick returns
    grew = {name: dict.fromkeys(kernels.WRAPPERS, 0) for name in arms}
    names = list(arms)
    full = arms["full"][0]
    probe_ms = []
    for t in range(1, ticks + 1):
        probe_ms.append(host_probe_ms())
        for name in (names if t % 2 else names[::-1]):
            st, use_delta = arms[name]
            before = kernels.launches()
            t0 = time.perf_counter()
            st.fused_tick(batches[t], delta=use_delta)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            tick_ms[name].append(1e3 * (time.perf_counter() - t0))
            dispatch_ms[name].append(1e3 * (t1 - t0))
            for k, v in kernels.launches().items():
                grew[name][k] += v - before[k]
        for name, (st, _) in arms.items():
            for tc, state in st.states.items():
                for f, x in state.items():
                    check(torch.equal(x, x[:1].expand_as(x)),
                          f"store_delta {name}: replica rows of {tc}.{f} "
                          f"differ after tick {t}")
                    check(torch.equal(x, full.states[tc][f]),
                          f"store_delta {name}: {tc}.{f} differs from the "
                          f"full arm after tick {t}")
    launches = kernels.launches()
    overflows = {name: {tc: int(st._fused_acc.get(f"overflow_{tc}", 0))
                        for tc in types} for name, (st, _) in arms.items()}
    fracs = {name: st.flush_metrics() for name, (st, _) in arms.items()}
    for st, _ in arms.values():
        st.sync_all()
    for name, (st, _) in arms.items():
        for tc in types:
            for f, x in full.states[tc].items():
                y = st.states[tc][f]
                check(x.dtype == y.dtype and x.shape == y.shape
                      and torch.equal(x, y),
                      f"store_delta {name}: {tc}.{f} differs from the full "
                      f"arm after sync_all")
    levels = int(np.ceil(np.log2(R)))
    per_tick = {name: {k: v / ticks for k, v in counted.items() if v}
                for name, counted in grew.items()}
    want_full = {"pnc_apply": 1, "orset_apply": 1, "replica_join": 1,
                 "slot_union": levels}
    want_delta = {"pnc_apply": 1, "orset_apply": 1, "dirty_rows": 2,
                  "delta_select": 2, "replica_join_rows": 1,
                  "slot_union_rows": levels}
    for name, (st, _) in arms.items():
        want = want_full if name == "full" else want_delta
        check(per_tick[name] == want, f"store_delta {name}: launches per "
              f"tick {per_tick[name]}, expected {want}")
        check(st.fused_trace_count == 1,
              f"store_delta {name}: {st.fused_trace_count} plan builds")
    check(all(n == 0 for n in overflows[f"delta_D{D}"].values()),
          f"store_delta: overflows at D={D}: {overflows}")
    check(all(n == ticks for n in overflows[f"delta_D{over}"].values()),
          f"store_delta: overflows at D={over}: {overflows}")
    for tc, frac in fracs[f"delta_D{D}"].items():
        check(0 < frac <= hot / K, f"store_delta: dirty fraction of {tc} "
              f"{frac}, expected at most the hot window's {hot / K}")
    # device time per tick by the profiler, over a few more ticks of each
    # arm (after the checks; the arms stay in step)
    profiled = {}
    for name, (st, use_delta) in arms.items():
        more = iter(batches[1:4])
        seen, dev_ms = device_profile(
            lambda st=st, use_delta=use_delta: st.fused_tick(next(more),
                                                             delta=use_delta),
            reps=3)
        profiled[name] = {"cuda_kernels_per_tick": seen / 3,
                          "device_ms_per_tick": dev_ms / 3}
    # no host synchronisation inside fused_tick, in either mode
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for st, use_delta in arms.values():
            st.fused_tick(batches[4], delta=use_delta)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message)[:160] for c in caught
             if "synchroniz" in str(c.message).lower()]
    check(not syncs, f"store_delta: host syncs inside fused_tick: {syncs[:3]}")
    arm_out = {}
    for name, ms in tick_ms.items():
        sec = sum(ms) / 1e3
        arm_out[name] = dict(**profiled[name],
            ms_per_tick=sum(ms) / ticks, ms_per_tick_min=min(ms),
            ms_per_tick_max=max(ms),
            dispatch_ms_per_tick=sum(dispatch_ms[name]) / ticks,
            dispatch_ms_per_tick_median=float(np.median(dispatch_ms[name])),
            converged_ops_per_s=R * B * len(types) * ticks / sec,
            dirty_fraction=fracs[name], overflows=overflows[name],
            fused_trace_count=arms[name][0].fused_trace_count,
            launches_per_tick=per_tick[name])
    emit("store_delta", replicas=R, keys=K, capacity=C, writers=R,
         ops_per_replica_per_type=B, hot_window=hot, ticks=ticks,
         state_mb={"orset": R * K * C * 14 / 1e6,
                   "pnc": 2 * R * K * R * 4 / 1e6},
         arms=arm_out, host_syncs_in_fused_tick=len(syncs),
         host_probe_ms_median=float(np.median(probe_ms)),
         host_probe_ms_min=min(probe_ms), host_probe_ms_max=max(probe_ms),
         launches_incl_warmup=launches)
    return launches


def rga_inputs(dev, workloads, rng, lead, c, depth=8, **kw):
    """A random RGA state ``lead + (C,)`` on the card: ``rga_slots`` rows,
    a random Lamport floor per row and the ``_depth`` carrier."""
    st = {f: torch.as_tensor(x, device=dev)
          for f, x in workloads.rga_slots(rng, lead, c, **kw).items()}
    st["ctr_floor"] = torch.as_tensor(
        rng.integers(-2, c + 2, lead).astype(np.int32), device=dev)
    st["_depth"] = torch.zeros(lead[:-1] + (depth, 0), dtype=torch.int32,
                               device=dev)
    return st


def check_calls(kernels, log, names, fn, what, keep=None):
    """Run ``fn`` with every call of the named wrappers (module attributes
    of ``kernels``, which the model calls) first held against its plain
    version on clones of its inputs (``log.add``); ``keep`` (a dict) gets
    the (args, kwargs) of each name's first call, cloned, for timing."""
    real = {name: getattr(kernels, name) for name in names}

    def checked(name):
        def call(*args, **kw):
            log.add(kernels, name, args, what, kw)
            if keep is not None and name not in keep:
                keep[name] = tree_map(torch.Tensor.clone, (args, kw))
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(kernels, name, checked(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(kernels, name, real[name])


def rga_kernel_checks(dev, kernels, workloads, cases):
    """rga_union, rga_union_rows, rga_apply, rga_compact and rga_order
    against their plain versions on the card, bit-equal, drop and
    overflow counts included: (a) random canonical and non-canonical rows
    (full rows, negative and repeated ids, junk in invalid slots) at
    several shapes, the converge's trees run through the row-list kernel
    at R = 1, 2, 3, 5, 8; (b) uncaptured and captured applies with keys in
    [-K, 2K), deletes before inserts, re-inserts, full rows that drop, B
    past one tile; (c) compactions and linearizations of deep random trees
    (chains past max_depth, dangling and cyclic parents, dead interior
    nodes, invalid slots mid-row), with and without protect; (d) every
    call of the preset's warm-up tick, its warm-up compaction and tick 1,
    the apply and compaction of tick 3 and the text of document 0, and
    every call of two delta ticks of the preset through a Store (the
    row-list mode), at full size; there the other wrappers the path runs
    (``replica_join`` with one operand on ``ctr_floor``,
    ``replica_join_rows``, ``dirty_rows``, ``delta_select``) are held
    against their plain versions too. Returns, per kernel, the (args, kwargs)
    of the call the kernels line times: level 1 of tick 1's converge, tick
    3's apply and compaction (in place), the text, level 1 of the second
    delta tick."""
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import Store, replicated_init

    log = CaseLog(RGA_KERNELS + RGA_PATH_KERNELS)
    rng = np.random.default_rng(21)
    g = RGA_CHECKS
    # (a) unions, fresh and broadcast into an out
    for lead, ca, cb, canon in g["unions"]:
        a = rga_inputs(dev, workloads, rng, lead, ca, canonical=canon,
                       dup_rows=0.4, full_rows=0.5, negative=0.1)
        b = rga_inputs(dev, workloads, rng, lead, cb, canonical=canon,
                       dup_rows=0.4, full_rows=0.5, negative=0.1)
        m = min(ca, cb)
        take = torch.as_tensor(rng.random(lead + (m,)) < 0.5, device=dev)
        for f in ("id_ctr", "id_rep", "valid"):
            b[f][..., :m] = torch.where(take, a[f][..., :m], b[f][..., :m])
        cap = max(ca, cb)
        what = f"random {'x'.join(map(str, lead))} C{ca}+{cb}"
        log.add(kernels, "rga_union", (a, b, cap), what)
        out = {f: torch.zeros((2,) + lead + (cap,), dtype=a[f].dtype,
                              device=dev) for f in rga.FIELDS}
        log.add(kernels, "rga_union", (a, b, cap), what + " out", {"out": out})
    for r, k, c, n_rows in g["trees"]:
        st = rga_inputs(dev, workloads, rng, (r, k), c, canonical=False,
                        dup_rows=0.3)
        rows = torch.as_tensor(rng.permutation(k).astype(np.int32), device=dev)
        n = torch.tensor(n_rows, dtype=torch.int32, device=dev)
        check_calls(kernels, log, ("rga_union_rows",),
                    lambda: rga.join_replica_rows(st, rows, n),
                    f"tree R{r} K{k} C{c} {n_rows} rows")
        check_calls(kernels, log, ("rga_union",),
                    lambda: rga.join_replicas(st), f"tree R{r} K{k} C{c}")
    # (b) applies
    for r, k, c, b, captured, canon in g["applies"]:
        st = rga_inputs(dev, workloads, rng, (r, k), c, canonical=canon,
                        dup_rows=0.3, full_rows=0.4, negative=0.1)
        ops = workloads.ops_to_device(
            workloads.rga_mixed_ops(rng, (r, b), k, c, captured=captured), dev)
        log.add(kernels, "rga_apply", ({f: x for f, x in st.items()
                                        if f != "_depth"}, ops),
                f"random R{r} K{k} C{c} B{b}{' eff_ctr' if captured else ''}")
    # (c) compaction and order of deep trees
    for lead, c, depth, canon in g["trees_deep"]:
        rows = rga_inputs(dev, workloads, rng, lead, c, depth, canonical=canon,
                          dup_rows=0.5, dead=0.6, chain=0.6, dangling=0.1,
                          negative=0.1, full_rows=0.5)
        slots = {f: rows[f] for f in rga.FIELDS}
        prot = torch.as_tensor(rng.random(lead + (c,)) < 0.2, device=dev)
        what = f"deep {'x'.join(map(str, lead))} C{c} depth {depth}"
        log.add(kernels, "rga_compact", (slots, None), what)
        log.add(kernels, "rga_compact", (slots, prot), what + " protect")
        flat = {f: x.reshape(-1, c) for f, x in slots.items()}
        log.add(kernels, "rga_order", (flat, depth), what)
    # (d) the preset's first calls at full size
    p = RGA_REPLAY
    R, K, L, lag = p["R"], p["K"], p["lanes"], p["lag"]
    cap = R * L // K * (lag + p["compact_every"] + 2)
    host = np.random.default_rng(p["seed"])
    batches = [workloads.ops_to_device(workloads.rga_text_replay(
        host, R, K, L, lag, t), dev) for t in range(4)]
    state = replicated_init(rga.SPEC, R, device=dev, num_keys=K, capacity=cap,
                            max_depth=p["max_depth"])
    tick = make_tick(rga.SPEC, device=dev)
    timing = {}
    check_calls(kernels, log, ("rga_apply", "rga_union", "replica_join",
                               "rga_compact"),
                lambda: (tick(state, batches[0]), rga.compact(state)),
                "preset warm-up tick and compaction")
    check_calls(kernels, log, ("rga_apply", "rga_union", "replica_join"),
                lambda: tick(state, batches[1]), "preset tick 1",
                keep=timing)
    timing.pop("rga_apply")
    tick(state, batches[2])
    check_calls(kernels, log, ("rga_apply",), lambda: tick(state, batches[3]),
                "preset tick 3 apply", keep=timing)
    check_calls(kernels, log, ("rga_compact",), lambda: rga.compact(state),
                "preset tick 3 compaction", keep=timing)
    (rows, prot), _ = timing["rga_compact"]
    timing["rga_compact"] = ((rows, prot), {"out": rows})  # in place
    check_calls(kernels, log, ("rga_order",),
                lambda: rga.text({f: x[0] for f, x in state.items()}, 0),
                "preset text of document 0", keep=timing)
    del state
    # the row-list mode on the preset's first delta ticks
    st = Store(R, {"rga": dict(num_keys=K, capacity=cap,
                               max_depth=p["max_depth"])},
               dirty_budget=K, device=dev)
    st.fused_tick({"rga": batches[0]})
    check_calls(kernels, log, ("rga_union_rows", "replica_join_rows",
                               "dirty_rows", "delta_select"),
                lambda: st.fused_tick({"rga": batches[1]}),
                "preset delta tick 1", keep=timing)
    del st
    for name, rec in log.by.items():
        check(rec["cases"] > 0, f"rga_kernels: no case of {name}")
        cases.append({"kernel": name, "case": "rga_kernels",
                      "cases": rec["cases"], "max_abs_err": rec["max_abs_err"]})
    emit("rga_kernels", by_kernel=log.by)
    return timing


def rga_text_model(host_ops, K, key=0):
    """Independent numpy model of document ``key`` under the replay: each
    tick its inserts take the document's Lamport counter + 1 (one counter
    per tick, as every replica starts the tick from the converged row) and
    its deletes remove an id; every insert anchors at the root, so the live
    text is the live ids in descending (ctr, rep) order. Returns
    ``(ids [n, 2] int64 (ctr, rep), chars [n])`` in document order."""
    live = {}
    ctr = 0
    for ops in host_ops:
        L = ops["op"].shape[1] // 2
        ins = (ops["op"][:, :L] == 1) & (ops["key"][:, :L] % K == key)
        if ins.any():
            r, j = np.nonzero(ins)
            for rep, ch in zip(ops["writer"][r, j], ops["a0"][r, j]):
                live[(ctr + 1, int(rep))] = int(ch)
            ctr += 1
        dels = (ops["op"][:, L:] == 2) & (ops["key"][:, L:] % K == key)
        for r, j in zip(*np.nonzero(dels)):
            live.pop((int(ops["a2"][r, L + j]), int(ops["a1"][r, L + j])), None)
    ids = sorted(live, reverse=True)
    return (np.array(ids, np.int64).reshape(-1, 2),
            np.array([live[i] for i in ids], np.int32))


def rga_replay(dev, kernels, workloads):
    """Harness preset rga (BASELINE config 5), uncut, driven as
    janus_tpu/bench/harness.py run_rga_replay drives it: R=1,024 replicas,
    K=128 documents of C=1,024 slots (2.95 GB), 16 insert and 16 delete
    lanes per replica per tick (delete lag 2), 64 ticks of
    ``engine.make_tick`` (apply + full converge), ``rga.compact`` over all
    replicas after every fourth, the first tick and its compaction off the
    clock, the other 63 timed by the host clock to one final synchronize;
    then 8 chained ``text`` calls of document 0. The drop and overflow
    counts each call of ``rga_apply`` and ``rga_union`` returns are kept
    and summed after that synchronize, so the timed ticks run nothing
    the harness does not. A second arm runs the same
    ticks through ``Store.fused_tick`` with dirty budget K (the row-list
    converge; every document is dirty every tick). Checked: every leaf,
    ctr_floor included, equal across the 1,024 replicas and across the
    arms; 256 live elements in every document of every replica; nothing
    dropped or overflowed; no depth overflow; the text of document 0
    equal to ``rga_text_model``."""
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import Store, replicated_init

    p = RGA_REPLAY
    R, K, L, lag, every, ticks = (p[x] for x in ("R", "K", "lanes", "lag",
                                                 "compact_every", "ticks"))
    per_doc = R * L // K
    cap = per_doc * (lag + every + 2)
    host_rng = np.random.default_rng(p["seed"])
    extra = p["profile_ticks"]
    host = [workloads.rga_text_replay(host_rng, R, K, L, lag, t)
            for t in range(ticks + extra)]
    batches = [workloads.ops_to_device(o, dev) for o in host]
    dims = dict(num_keys=K, capacity=cap, max_depth=p["max_depth"])
    state = replicated_init(rga.SPEC, R, device=dev, **dims)
    tick = make_tick(rga.SPEC, device=dev)
    # drop and overflow accounting: each apply's and merge level's counts,
    # summed after the run
    kept = {"dropped": [], "overflow": []}
    real = {"rga_apply": kernels.rga_apply, "rga_union": kernels.rga_union}

    def counted_apply(*a, **kw):
        dropped = real["rga_apply"](*a, **kw)
        kept["dropped"].append(dropped)
        return dropped

    def counted_union(*a, **kw):
        out, overflow = real["rga_union"](*a, **kw)
        kept["overflow"].append(overflow)
        return out, overflow

    kernels.rga_apply, kernels.rga_union = counted_apply, counted_union
    try:
        kernels.reset_launches()
        tick(state, batches[0])  # warm-up tick and compaction, off the clock
        rga.compact(state)
        torch.cuda.synchronize()
        before = kernels.launches()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(ticks)]
        compactions = []
        t0 = time.perf_counter()
        for t in range(1, ticks):
            tick(state, batches[t])
            if t % every == every - 1:
                ev[t][0].record()
                rga.compact(state)
                ev[t][1].record()
                compactions.append(t)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        kernels.rga_apply, kernels.rga_union = (real["rga_apply"],
                                                real["rga_union"])
    grew = {k: v - before[k] for k, v in kernels.launches().items()}
    counts = {k: int(torch.stack([x.sum() for x in v]).sum())
              for k, v in kept.items()}
    del kept
    # the text of document 0, 8 chained calls to one synchronize
    doc0 = {f: x[0] for f, x in state.items()}
    out = rga.text(doc0, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(p["text_calls"]):
        out = rga.text(doc0, 0)
    torch.cuda.synchronize()
    text_ms = 1e3 * (time.perf_counter() - t1) / p["text_calls"]
    # the delta arm: the same ticks through the Store's row-list path
    store = Store(R, {"rga": dims}, dirty_budget=K, device=dev)
    delta_before = kernels.launches()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for t in range(ticks):
        store.fused_tick({"rga": batches[t]})
        if t % every == every - 1 or t == 0:
            rga.compact(store.states["rga"])
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t2
    delta_grew = {k: v - delta_before[k]
                  for k, v in kernels.launches().items()}
    delta_overflows = int(store._fused_acc["overflow_rga"])
    delta_frac = store.flush_metrics()["rga"]
    launches = kernels.launches()
    # checks
    for f, x in state.items():
        check(torch.equal(x, x[:1].expand_as(x)),
              f"rga_replay: replicas differ on {f}")
        check(torch.equal(x, store.states["rga"][f]),
              f"rga_replay: the Store's delta arm differs on {f}")
    live = (state["valid"] & ~state["dead"]).sum(-1)
    check(bool((live == per_doc * lag).all()),
          f"rga_replay: live counts {torch.unique(live).tolist()} != "
          f"{per_doc * lag}")
    check(counts["dropped"] == 0 and counts["overflow"] == 0,
          f"rga_replay: dropped {counts['dropped']}, merge overflow "
          f"{counts['overflow']}")
    check(not bool(out["overflow"]), "rga_replay: depth overflow")
    ids, chars = rga_text_model(host[:ticks], K)
    m = out["live"]
    got_ids = torch.stack([out["id_ctr"][m], out["id_rep"][m]], -1).cpu()
    check(np.array_equal(got_ids.numpy().astype(np.int64), ids)
          and np.array_equal(out["chr"][m].cpu().numpy(), chars),
          f"rga_replay: text of document 0 ({int(m.sum())} live) differs "
          f"from the numpy model ({len(chars)})")
    levels = int(np.ceil(np.log2(R)))
    timed = ticks - 1
    per_tick = {k: v / timed for k, v in grew.items() if v}
    want = {"rga_apply": 1, "rga_union": levels, "replica_join": 1,
            "rga_compact": len(compactions) / timed}
    check(per_tick == want, f"rga_replay: launches per tick {per_tick}, "
          f"expected {want}")
    check(delta_overflows == 0 and delta_frac == 1.0,
          f"rga_replay: delta arm overflows {delta_overflows}, dirty "
          f"fraction {delta_frac}")
    check(delta_grew["rga_union_rows"] == levels * ticks
          and delta_grew["replica_join_rows"] == ticks,
          f"rga_replay: delta arm launches {delta_grew}")
    # device time and kernels per tick by the profiler, over more ticks of
    # the trace on a copy of the state (no accounting reductions)
    copy = {f: x.clone() for f, x in state.items()}
    more = iter(batches[ticks:])
    seen, dev_ms = device_profile(lambda: tick(copy, next(more)), reps=extra)
    del copy
    inserts = R * L * timed
    deletes = R * L * sum(1 for t in range(1, ticks) if t >= lag)
    comp_ms = [ev[t][0].elapsed_time(ev[t][1]) for t in compactions]
    emit("rga_replay", replicas=R, documents=K, capacity=cap,
         lanes=L, delete_lag=lag, compact_every=every, ticks=ticks,
         timed_ticks=timed, seconds=elapsed, ms_per_tick=1e3 * elapsed / timed,
         sequence_ops=inserts + deletes,
         sequence_ops_per_s=(inserts + deletes) / elapsed,
         replica_applications_per_s=(inserts + deletes) * R / elapsed,
         device_ms_per_tick=dev_ms / extra, cuda_kernels_per_tick=seen / extra,
         launches_per_tick=per_tick, compactions=len(compactions),
         ms_per_compaction=sum(comp_ms) / len(comp_ms),
         ms_per_compaction_min=min(comp_ms), ms_per_compaction_max=max(comp_ms),
         text_ms=text_ms, text_calls=p["text_calls"],
         elements_per_doc=rga.element_count(doc0).tolist()[:4],
         elements_per_doc_max=int(rga.element_count(doc0).max()),
         live_per_doc=int(rga.length(doc0, 0)), slot_capacity=cap,
         depth_overflow=bool(out["overflow"]), slots_dropped=counts["dropped"],
         merge_overflow=counts["overflow"],
         state_gb=R * K * cap * 22 / 1e9,
         delta_arm={"ms_per_tick": 1e3 * delta_s / ticks,
                    "dirty_fraction": delta_frac, "overflows": delta_overflows,
                    "launches_per_tick": {k: v / ticks
                                          for k, v in delta_grew.items() if v}},
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches_incl_warmup=launches)
    del store
    return launches


def rga_rows_touched(state, ops):
    """The ``(replica, row)`` pairs an ``rga_apply`` call must move: the
    rows its op lanes gather (JAX's clamp rule) and those it writes back
    (in-range keys), counted once each."""
    from janus_tpu_torch.models.base import gather_index, scatter_index

    R, K, _ = state["valid"].shape
    r = torch.arange(R, device=ops["key"].device).view(R, 1).expand_as(ops["key"])
    wi, ok = scatter_index(ops["key"], K)
    return (torch.unique(r * K + gather_index(ops["key"], K)).numel(),
            torch.unique((r * K + wi)[ok]).numel())


def rga_kernel_rows(kernels, calls):
    """The kernels line's entries of the five RGA wrappers, on the calls
    ``rga_kernel_checks`` kept from the preset, with what each must move
    (22 bytes an RGA slot): the union's two input rows read and its row
    written (level 1 of tick 1's converge: 512 x 128 rows of 1,024 +
    1,024 slots); the same per listed row for the row-list mode (level 1
    of a delta tick); the apply's op fields, drop counts and the rows its
    lanes gather and write back, with their floors; the compaction's row
    read and written; the linearization's five fields read and its order
    and depths written. Operations: one per slot field read (a lower
    bound), and for the linearization the C log2 C comparisons a
    comparison sort needs."""
    rows = []
    (a, b, cap), kw = calls["rga_union"]
    lead = tuple(a["valid"].shape[:-1])
    n = int(np.prod(lead))
    ca, cb = a["valid"].shape[-1], b["valid"].shape[-1]
    repeat = kw["out"]["valid"].shape[0] if "out" in kw else 1
    rows.append(dict(
        name="rga_union", args=(a, b, cap), kw=kw,
        shape=f"level 1 of the preset's converge: {' x '.join(map(str, lead))}"
              f" rows, {ca} + {cb} slots",
        bytes=22 * n * (ca + cb + repeat * cap) + 4 * n,
        operations=7 * n * (ca + cb)))
    args, kw = calls["rga_union_rows"]
    a, n_rows = args[0], args[4]
    m = int(n_rows)
    pairs, k, c = a["valid"].shape
    rows.append(dict(
        name="rga_union_rows", args=args, kw=kw,
        shape=f"level 1 of a delta tick's tree: {pairs} x {m} rows, "
              f"{c} + {c} slots", rows_joined=m,
        bytes=3 * pairs * m * 22 * c + 4 * m + 4,
        operations=2 * pairs * m * c * 7))
    (state, ops), kw = calls["rga_apply"]
    r, k, c = state["valid"].shape
    b = ops["op"].shape[1]
    read, written = rga_rows_touched(state, ops)
    rows.append(dict(
        name="rga_apply", args=(state, ops), kw=kw,
        shape=f"the preset's apply at tick 3: R{r} K{k} C{c} B{b}",
        rows_read=read, rows_written=written,
        bytes=4 * 6 * r * b + 4 * r + (22 * c + 4) * (read + written),
        operations=7 * c * read))
    (slots, prot), kw = calls["rga_compact"]
    shape = tuple(slots["valid"].shape)
    n = int(np.prod(shape[:-1]))
    c = shape[-1]
    rows.append(dict(
        name="rga_compact", args=(slots, prot), kw=kw,
        shape=f"the preset's compaction at tick 3: {' x '.join(map(str, shape))}"
              f", in place",
        bytes=2 * 22 * n * c, operations=7 * n * c))
    (flat, depth), kw = calls["rga_order"]
    n, c = flat["valid"].shape
    rows.append(dict(
        name="rga_order", args=(flat, depth), kw=kw,
        shape=f"text of document 0: {n} row of {c} slots, depth {depth}",
        bytes=n * c * (17 + 8) + n,
        operations=n * c * int(np.ceil(np.log2(max(c, 2))))))
    for row in rows:
        fn = kernels.WRAPPERS[row["name"]]
        a_, k_ = row.pop("args"), row.pop("kw")
        row["library"] = None
        row["library_note"] = RGA_LIBRARY_NOTES[row["name"]]
        row["call"] = lambda fn=fn, a_=a_, k_=k_: fn(*a_, **k_)
        row["plain"] = (lambda name=row["name"], a_=a_, k_=k_:
                        plain_of(kernels, name)(*a_, **k_))
    return rows


def canonical_rows(st) -> bool:
    """Rows sorted by tag with every valid slot before every invalid one,
    no tag twice, invalid slots SENTINEL keys and zero payloads."""
    v = st["valid"]
    SENT = torch.iinfo(torch.int32).max
    if bool((v[..., 1:] & ~v[..., :-1]).any()):
        return False
    tag = st["tag_rep"].long() * 2**32 + st["tag_ctr"].long()
    both = v[..., 1:] & v[..., :-1]
    if bool((both & (tag[..., 1:] <= tag[..., :-1])).any()):
        return False
    inv = ~v
    return bool(((st["tag_rep"] == SENT) | v).all()
                and ((st["tag_ctr"] == SENT) | v).all()
                and ((st["elem"] == 0) | v).all()
                and (~(st["removed"] & inv)).all())


def orset_consensus(dev, kernels, workloads):
    """Path A timed: SafeKV for the OR-Set at 4 nodes, window 8, 8192-op
    blocks, 100 keys of 64 slots, capture width 4, apply budget 8, 50/50
    add/remove. The first rounds are held bit-equal against the same run
    on the CPU (through a GC advance and a compaction); then 24 timed
    rounds after warm-up, idle rounds until drained, and the checks: every
    view's stable state bit-equal, rows canonical, no tag twice."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig, tusk
    from janus_tpu_torch.consensus import dag as dagmod
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime import safecrdt
    from janus_tpu_torch.runtime.safecrdt import COMMIT_STEPS, SafeKV
    from janus_tpu_torch.utils.ids import TagMinter

    g = ORSET_CONS
    n, w, k, b = g["nodes"], g["window"], g["keys"], g["ops_per_block"]
    rounds, warm = g["rounds"], g["warmup"]

    def make_kv(device):
        return SafeKV(DagConfig(n, w), orset.SPEC, ops_per_block=b,
                      apply_budget=g["budget"], collect_logs=False,
                      device=device, num_keys=k, capacity=g["capacity"],
                      rm_capacity=g["rm"])

    def device_state(kv):
        return convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})

    def same(a, b_):
        if isinstance(a, dict):
            return a.keys() == b_.keys() and all(same(a[x], b_[x]) for x in a)
        return a.dtype == b_.dtype and np.array_equal(a, b_)

    # the first rounds against the CPU
    rng = np.random.default_rng(6)
    minters = [TagMinter(i) for i in range(n)]
    first = [workloads.orset_add_remove(rng, minters, k, b)
             for _ in range(g["cpu_rounds"])]
    card, cpu = make_kv(dev), make_kv("cpu")
    t0 = time.perf_counter()
    for t, host_ops in enumerate(first):
        packed = {}
        for name, kv in (("card", card), ("cpu", cpu)):
            packed[name], meta = kv.step_dispatch(
                workloads.ops_to_device(host_ops, kv.device))
            kv.step_absorb(packed[name], meta)
        check(torch.equal(packed["card"].cpu(), packed["cpu"]),
              f"orset_consensus: packed output of round {t} differs from "
              f"the CPU run")
        check(same(device_state(card), device_state(cpu)),
              f"orset_consensus: device state after round {t} differs from "
              f"the CPU run")
    cpu_s = time.perf_counter() - t0
    check(card.stats == cpu.stats and card.stats["gc_advances"] > 0
          and card.stats["compactions"] > 0,
          f"orset_consensus: CPU rounds stats {card.stats} / {cpu.stats}: "
          f"need equal, with a GC advance and a compaction")
    cpu_stats = dict(card.stats)
    del card, cpu

    # the timed run
    rng = np.random.default_rng(7)
    minters = [TagMinter(i) for i in range(n)]
    host = [workloads.orset_add_remove(rng, minters, k, b)
            for _ in range(warm + rounds + g["profile_rounds"])]
    batches = [workloads.ops_to_device(o, dev) for o in host]
    idle = workloads.ops_to_device(
        {f: np.zeros((n, b), np.int32) for f in host[0]}, dev)
    kv = make_kv(dev)
    for t in range(warm):
        kv.step(batches[t])
    torch.cuda.synchronize()
    kv.latency_log.clear()
    stats0 = dict(kv.stats)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for t in range(warm, warm + rounds):
        info = kv.step(batches[t])
        check(info["accepted"].all(), f"orset_consensus: round {t} rejected")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    committed = kv.stats["own_commits"] - stats0["own_commits"]
    idle_rounds = 0

    def views_agree():
        return all(torch.equal(x, x[:1].expand_as(x))
                   for f, x in kv.stable.items() if f != "_rm_cap")

    while idle_rounds < g["max_idle"]:
        if idle_rounds >= g["min_idle"] and views_agree():
            break
        kv.step(idle, record=False)
        idle_rounds += 1
    torch.cuda.synchronize()
    launches = kernels.launches()
    check(views_agree(), f"orset_consensus: stable states of the views "
          f"differ after {idle_rounds} idle rounds")
    for name, st in (("stable", kv.stable), ("prospective", kv.prospective)):
        check(canonical_rows(st), f"orset_consensus: {name} rows not "
              f"canonical (or a tag twice in a row)")
    stepped = rounds + idle_rounds
    expect = {"orset_capture": stepped, "orset_replay": 3 * stepped,
              **{name: stepped for name in CONSENSUS_KERNELS}}
    for name, want in expect.items():
        check(launches[name] == want, f"orset_consensus: {name} launched "
              f"{launches[name]} times in {stepped} rounds, expected {want}")
    check(kv.stats["compactions"] > stats0["compactions"],
          "orset_consensus: no compaction in the timed rounds")
    lag = kv.commit_latencies()

    # kernels per round and per phase, by the profiler
    from torch.profiler import ProfilerActivity, profile
    extra = batches[warm + rounds:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for ops in extra:
            kv.step(ops)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    per_round = len(dev_events) / len(extra)
    dev_us = sum(e.time_range.elapsed_us() for e in dev_events) / len(extra)
    cfg = kv.cfg
    everything = torch.ones((n, w, n), dtype=torch.bool, device=dev)
    order = torch.zeros((n, w, n), dtype=torch.int32, device=dev)
    by_phase = {
        "submit": cuda_kernels_of(lambda: kv._submit_device(
            kv.prospective, kv.dag, kv.ops_buffer, kv.buffer_filled,
            kv.prosp_applied, extra[0])),
        "state_transfer": cuda_kernels_of(lambda: kv._state_transfer(
            kv.prospective, kv.stable, kv.dag, kv.commit, kv.prosp_applied,
            kv.stable_applied, kv.force_transfer)),
        "round_step": cuda_kernels_of(lambda: dagmod.round_step(cfg, kv.dag)),
        "causal_closure": cuda_kernels_of(
            lambda: kv._causal_closure(kv.dag, kv.prosp_applied)),
        "commit_view": cuda_kernels_of(lambda: tusk.commit_view(
            cfg, kv.dag, kv.commit, seed=kv.seed, steps=COMMIT_STEPS)),
        "delta_apply_x2": 2 * cuda_kernels_of(lambda: kv._delta_apply(
            kv.stable, kv.ops_buffer, everything, order)),
        "compaction_at_gc": cuda_kernels_of(lambda: kv._compact_device(
            kv.prospective, kv.stable, kv.ops_buffer)),
    }
    emit("orset_consensus", nodes=n, window=w, ops_per_block=b, keys=k,
         capacity=g["capacity"], rm_capacity=g["rm"],
         apply_budget=g["budget"], warmup_rounds=warm, rounds=rounds,
         idle_rounds_to_drain=idle_rounds, seconds=dt,
         ms_per_round=1e3 * dt / rounds, ops_per_s=rounds * n * b / dt,
         committed_ops_per_s=committed * b / dt,
         commit_lag_ticks_p50=float(np.percentile(lag, 50)),
         commit_lag_ticks_p99=float(np.percentile(lag, 99)),
         blocks_committed=int(lag.size), launches=launches,
         profiled_rounds=len(extra), cuda_kernels_per_round=per_round,
         profiled_device_us_per_round=dev_us, cuda_kernels_by_phase=by_phase,
         slots_dropped=kv.stats["slots_dropped"] - stats0["slots_dropped"],
         compactions=kv.stats["compactions"] - stats0["compactions"],
         gc_advances=kv.stats["gc_advances"] - stats0["gc_advances"],
         stats=kv.stats, cpu_check={"rounds": g["cpu_rounds"],
                                    "seconds": cpu_s, "stats": cpu_stats})
    return launches


def apply_rows_touched(state, ops):
    """The ``(replica, row)`` pairs an ``orset_apply`` call must move: the
    rows its op lanes gather (JAX's clamp rule) and those it writes back
    (in-range keys), counted once each."""
    from janus_tpu_torch.models.base import gather_index, scatter_index

    R, K, _ = state["valid"].shape
    r = torch.arange(R, device=ops["key"].device).view(R, 1).expand_as(ops["key"])
    wi, ok = scatter_index(ops["key"], K)
    return dict(rows_read=torch.unique(r * K + gather_index(ops["key"], K)).numel(),
                rows_written=torch.unique((r * K + wi)[ok]).numel())


def delta_kernel_rows(kernels, calls):
    """The kernels line's entries of the four delta kernels, on the last
    recorded call of the 2-tick store run (``slot_union_rows`` on the first
    level of the OR-Set's tree), with what the call must move: the op and
    key fields read and one byte stored for each distinct (replica, key)
    its live ops mark (``dirty_rows`` never reads the mask); the
    mask read and zeroed and the order written (``delta_select``); and, for
    the row-list joins, the rows this run's selection lists (its ``n_join``),
    each read from every replica and written back (``replica_join_rows``),
    or read from 2 x 32 replicas and written to 32 (``slot_union_rows``)."""
    from janus_tpu_torch.models.base import scatter_index

    rows = []
    args, kw = calls["dirty_rows"]
    op, key, k = args
    r, b = op.shape
    idx, ok = scatter_index(key, k)
    live = (op != 0) & ok
    hit = live.to(torch.int32)
    counts = torch.zeros((r, k), dtype=torch.int32, device=op.device)
    rep = torch.arange(r, device=op.device).view(r, 1).expand_as(idx)
    marked = torch.unique((rep * k + idx)[live]).numel()
    rows.append(dict(
        name="dirty_rows", args=args, kw=kw,
        library=lambda: counts.scatter_add_(-1, idx, hit),
        library_note="scatter_add_ of the live ops' hits (the plain "
                     "version's scatter, without its mask OR)",
        shape=f"R{r} B{b} K{k}, a store_delta tick",
        bytes=8 * r * b + marked, operations=r * b, keys_marked=marked))
    args, kw = calls["delta_select"]
    r, k = args[0].shape
    rows.append(dict(
        name="delta_select", args=args, kw=kw, library=None,
        library_note="no single PyTorch call computes it: a union, a count "
                     "and a stable partition",
        shape=f"R{r} K{k} D{args[1]}, a store_delta tick",
        bytes=2 * r * k + 4 * k + 4 + 4 + 1, operations=r * k))
    args, kw = calls["replica_join_rows"]
    p, n, order, n_rows = args
    m = int(n_rows)
    pick = order[:m].long()
    r, k, w = p.shape
    rows.append(dict(
        name="replica_join_rows", args=args, kw=kw,
        library=lambda: [x.index_copy_(1, pick, x.index_select(1, pick)
                                       .amax(0, keepdim=True).expand(r, -1, -1))
                         for x in (p, n)],
        library_note="index_select + amax(0) + index_copy_ back, per "
                     "polarity",
        shape=f"R{r} K{k} W{w}, {m} rows joined",
        bytes=2 * 2 * r * m * w * 4 + 4 * m + 4,
        operations=2 * (r - 1) * m * w, rows_joined=m))
    args, kw = calls["slot_union_rows"]
    a, n_rows = args[0], args[4]
    m = int(n_rows)
    pairs, k, c = a["valid"].shape
    row_bytes = sum(a[f][0, 0].numel() * a[f].element_size() for f in a)
    rows.append(dict(
        name="slot_union_rows", args=args, kw=kw, library=None,
        library_note="no single PyTorch call computes it: a tag-keyed union "
                     "with a tombstone fold and a capacity cut",
        shape=f"first level of the OR-Set's tree: {pairs} x {m} rows, "
              f"{c} + {c} slots",
        bytes=3 * pairs * m * row_bytes + 4 * m + 4,
        operations=2 * pairs * m * c * len(a), rows_joined=m))
    for row in rows:
        fn = kernels.WRAPPERS[row["name"]]
        a_, k_ = row.pop("args"), row.pop("kw")
        row["call"] = lambda fn=fn, a_=a_, k_=k_: fn(*a_, **k_)
        row["plain"] = (lambda name=row["name"], a_=a_, k_=k_:
                        plain_of(kernels, name)(*a_, **k_))
    return rows


def kernels_line(dev, kernels, path_launches, fast_ops, cases, timing_calls,
                 orset_calls, delta_calls, rga_calls):
    """Time each kernel beside its plain version, its bound and one
    PyTorch call computing the same function: pnc_apply and replica_join
    at the fast-path shape, the consensus kernels on the last recorded
    call of the 4-node SafeKV run (no single PyTorch call computes
    them, so their library_ms is null). ``ms`` is a call's time by CUDA
    events, host work of the wrapper included; ``device_ms`` is a
    launch's device time by CUDA events around a burst the host queued
    before the device started it. The profiler's count of the kernels it
    saw over 20 calls is given beside the wrappers' own count of those
    launches, and a consensus row gives its plain version's device time by
    the profiler. A consensus or OR-Set kernel's bytes are the operands its
    wrapper hands it plus its outputs (``orset_capture`` reads no
    tombstone; ``orset_apply`` reads only the rows its ops gather and
    writes back only those in range), and its operations one per input
    element it reads, a lower bound on its work. The OR-Set kernels are timed
    on recorded calls of the two OR-Set paths: ``slot_union`` on the first
    level of path B's converge, ``orset_apply`` on path B's apply (repeated
    on the state it leaves), ``orset_capture`` on a path A submit and
    ``orset_replay`` on a path A delta apply of the whole budget. The RGA
    kernels are timed on calls of the rga preset (``rga_kernel_rows``)."""
    from janus_tpu_torch.kernels import operands

    gen = torch.Generator(device=dev).manual_seed(1)
    R, K, W, B = (FAST[k] for k in "RKWB")
    state = rand_state((R, K, W), dev, gen, lo=-1000, hi=1000)
    err = {c["kernel"]: max(x["max_abs_err"] for x in cases
                            if x["kernel"] == c["kernel"]) for c in cases}

    # pnc_apply: the cells this run's ops touch, and a flat index for the
    # library call (index_put_ with accumulate, which the port never calls)
    op, key, wr, a0 = (fast_ops[f].long() for f in ("op", "key", "writer", "a0"))
    r = torch.arange(R, device=dev).view(R, 1)
    flat = (r * K + key) * W + wr
    lib_idx = {c: flat[op == c] for c in (1, 2)}
    lib_val = {c: fast_ops["a0"][op == c] for c in (1, 2)}
    live = op > 0
    cells = torch.unique(flat[live] + (op[live] == 2) * (R * K * W)).numel()
    pnc_bytes = 4 * 4 * R * B + 8 * cells  # four op fields, cell read+write
    kerns = [
        dict(name="pnc_apply",
             call=lambda: kernels.pnc_apply(state["p"], state["n"], fast_ops),
             plain=lambda: kernels.pnc_apply_plain(state["p"], state["n"],
                                                   fast_ops),
             library=lambda: (
                 state["p"].view(-1).index_put_((lib_idx[1],), lib_val[1],
                                                accumulate=True),
                 state["n"].view(-1).index_put_((lib_idx[2],), lib_val[2],
                                                accumulate=True)),
             bytes=pnc_bytes, operations=int(live.sum()), cells_touched=cells),
        # P and N, each read once and written once
        dict(name="replica_join",
             call=lambda: kernels.replica_join(state["p"], state["n"]),
             plain=lambda: kernels.replica_join_plain(state["p"], state["n"]),
             library=lambda: [x.copy_(torch.amax(x, 0).expand_as(x))
                              for x in (state["p"], state["n"])],
             bytes=2 * 2 * R * K * W * 4, operations=2 * (R - 1) * K * W),
    ]
    for name in CONSENSUS_KERNELS:
        args, _ = timing_calls[name][-1]
        fn = kernels.WRAPPERS[name]
        ins, outs = kernel_operands(operands, fn, args)
        kerns.append(dict(
            name=name, call=lambda fn=fn, args=args: fn(*args),
            plain=lambda name=name, args=args: plain_of(kernels, name)(*args),
            library=None, shape=f"N{args[0].num_nodes} W{args[0].num_rounds}, "
            f"last recorded SafeKV call",
            bytes=sum(t.numel() * t.element_size() for t in ins + outs),
            operations=sum(t.numel() for t in ins),
            library_note="no single PyTorch call computes it: a protocol "
                         "rule over the DAG's masks"))
    shapes = {
        "slot_union": "first converge level of path B: 32 x 500 rows, "
                      "256 + 256 slots",
        "orset_apply": "path B apply: R64 K500 C256 B64",
        "orset_capture": "path A submit: V4 K100 C64 B8192 r4",
        "orset_replay": "path A delta apply: V4 K100 C64 B65536 r4",
    }
    for name in ORSET_KERNELS:
        args, kw = orset_calls[name]
        fn = kernels.WRAPPERS[name]
        ins, outs = kernel_operands(operands, lambda *a, fn=fn, kw=kw: fn(*a, **kw),
                                    args)
        extra = {}
        if name == "orset_capture":  # reads no tombstone
            ins = [t for t in ins if t is not args[0]["removed"]]
        if name == "orset_apply":
            # the op lanes, the drop counts, and each row an op gathers
            # (read) or writes back (written), not the whole state
            rows = args[0]
            ins = [t for t in ins if not any(t is x for x in rows.values())]
            extra = apply_rows_touched(rows, args[1])
            row_bytes = sum(x[0, 0].numel() * x.element_size()
                            for x in rows.values())
            row_elems = sum(x[0, 0].numel() for x in rows.values())
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        nops = sum(t.numel() for t in ins)
        if extra:
            nbytes += row_bytes * (extra["rows_read"] + extra["rows_written"])
            nops += row_elems * extra["rows_read"]
        kerns.append(dict(
            name=name, call=lambda fn=fn, args=args, kw=kw: fn(*args, **kw),
            plain=lambda name=name, args=args, kw=kw: plain_of(kernels, name)(
                *args, **kw),
            library=None, shape=shapes[name], bytes=nbytes, operations=nops,
            **extra,
            library_note="no single PyTorch call computes it: a tag-keyed "
                         "union with a tombstone fold and a capacity cut"
                         if name in ("slot_union", "orset_replay") else
                         "no single PyTorch call computes it: a per-row "
                         "sequential apply" if name == "orset_apply" else
                         "no single PyTorch call computes it: per-lane "
                         "observed-tag capture"))

    kerns += delta_kernel_rows(kernels, delta_calls)
    kerns += rga_kernel_rows(kernels, rga_calls)

    # the profiler's count of a plain torch kernel, as a control, and of
    # causal_closure profiled right after a large profile (tusk_commit's
    # plain version, ~13,000 kernels), an order in which the profiler has
    # dropped 1-2 of 20 kernels
    x = torch.zeros(1, device=dev)
    time_cuda(lambda: x.add_(1))
    control_seen, _ = device_profile(lambda: x.add_(1), reps=20)
    by_name = {k["name"]: k for k in kerns}
    device_profile(by_name["tusk_commit"]["plain"], reps=3)
    after_large_seen, _ = device_profile(by_name["causal_closure"]["call"],
                                         reps=20)
    out = []
    for kern in kerns:
        name = kern["name"]
        row = {k: kern[k] for k in ("bytes", "operations", "shape",
                                    "cells_touched", "keys_marked",
                                    "rows_read", "rows_written", "rows_joined",
                                    "library_note")
               if k in kern}
        row["ms"] = time_cuda(kern["call"])
        row["plain_ms"] = time_cuda(kern["plain"], reps=plain_reps(kern["plain"]),
                                    warmup=1)
        row["library_ms"] = (None if kern["library"] is None
                             else time_cuda(kern["library"]))
        row["device_ms"] = device_burst_ms(kern["call"])
        before = kernels.WRAPPERS[name].launches
        row["profiler_kernels_seen"], _ = device_profile(kern["call"], reps=20)
        row["profiled_launches"] = kernels.WRAPPERS[name].launches - before
        if "shape" in kern:
            seen, plain_dev_ms = device_profile(kern["plain"], reps=3)
            row.update(plain_device_ms=plain_dev_ms / 3,
                       plain_kernels_per_call=seen / 3)
        t_bytes = 1e3 * row["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * row["operations"] / INT32_OPS_PER_S
        out.append({
            "name": name, "route": "cuda",
            "source": f"janus_tpu_torch/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in path_launches.values()),
            "launches_by_path": {path: p[name]
                                 for path, p in path_launches.items()},
            "max_abs_err": err[name],
            "ms": row.pop("ms"), "plain_ms": row.pop("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": row.pop("library_ms"), **row,
        })
        check(out[-1]["launches"] > 0, f"{name} never launched on the main path")
    emit("profiler_check", calls=20, add_kernels_seen=control_seen,
         causal_closure_seen_after_tusk_commit_plain=after_large_seen)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from janus_tpu_torch import kernels
    from janus_tpu_torch.bench import workloads
    from janus_tpu_torch.kernels import build

    started = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    res = build.build_all()
    ptxas = [ln.strip() for log in res["log"].values() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=res["seconds"], nvcc=build.nvcc(),
         flags=" ".join(build.NVCC_FLAGS), ptxas=ptxas)

    phase_s = {"build": res["seconds"]}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    fast_ops, cases = timed("kernels", kernel_checks, dev, kernels, workloads)
    timing_calls = timed("dag_kernels", consensus_kernel_checks, dev, kernels,
                         workloads, cases)
    orset_calls = timed("orset_kernels", orset_kernel_checks, dev, kernels,
                        workloads, cases)
    delta_calls = timed("delta_kernels", delta_kernel_checks, dev, kernels,
                        workloads, cases)
    rga_calls = timed("rga_kernels", rga_kernel_checks, dev, kernels,
                      workloads, cases)
    paths = {"fast_path": timed("fast_path", fast_path, dev, kernels, workloads),
             "consensus": timed("consensus", consensus_path, dev, kernels,
                                workloads, cases),
             "orset_store": timed("orset_store", orset_store, dev, kernels,
                                  workloads),
             "orset_consensus": timed("orset_consensus", orset_consensus, dev,
                                      kernels, workloads),
             "store_delta": timed("store_delta", store_delta, dev, kernels,
                                  workloads),
             "rga_replay": timed("rga_replay", rga_replay, dev, kernels,
                                 workloads)}
    line = timed("kernels_line", kernels_line, dev, kernels, paths, fast_ops,
                 cases, timing_calls, orset_calls, delta_calls, rga_calls)
    emit("timing", seconds=time.perf_counter() - started, by_phase=phase_s)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

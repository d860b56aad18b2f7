#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (janus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card through its own entry points and
checks every result; any failed check raises, so the script exits
non-zero. Phases, one JSON line each:

1. device     the card's name and power limit (nvidia-smi)
2. build      both hand kernels compiled from csrc/ with nvcc, in parallel
3. kernels    each hand kernel against its plain PyTorch version on the
              card, bit-equal, at the fast-path shapes, at the consensus
              path's submit and delta-apply shapes, and at ragged ones
4. fast_path  R=256 replicas, K=1024 keys, W=256 writers, B=1024 ops per
              replica: 80 engine ticks (apply + converge), checked against
              an independent numpy expectation
5. consensus  SafeKV for the PN-Counter at 4 nodes, window 8, 4000-op
              blocks, 100 keys: 64 rounds with half the ops safe, then idle
              rounds until drained; checked for acceptance, safe acks,
              identical total order, stable == prospective == numpy sum,
              and P and N per writer lane against a numpy scatter; the
              pnc_apply calls of its warm-up rounds are recorded and
              replayed through the kernel and its plain version, bit-equal
6. the kernels line, the nvidia-smi line, and the result line.

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

FAST = dict(R=256, K=1024, W=256, B=1024, ticks=80)
CONS = dict(nodes=4, window=8, ops_per_block=4000, keys=100, rounds=64,
            max_idle=64, profile_rounds=4)


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

    # launches per round, counted by the profiler over a few rounds
    n_prof = CONS["profile_rounds"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n_prof):
            kv.step(batches[4 + t], safe[4 + t])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    memcpy = sum(1 for e in dev_events if "memcpy" in e.name.lower()
                 or "memset" in e.name.lower())
    dev_us = sum(e.time_range.elapsed_us() for e in dev_events)

    def launches_of(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in p.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    # the functional phases of a round, each alone on the current state
    cfg = kv.cfg
    by_phase = {
        "state_transfer": launches_of(lambda: kv._state_transfer(
            kv.prospective, kv.stable, kv.dag, kv.commit, kv.prosp_applied,
            kv.stable_applied, kv.force_transfer)),
        "round_step": launches_of(lambda: dagmod.round_step(cfg, kv.dag)),
        "causal_closure": launches_of(
            lambda: kv._causal_closure(kv.dag, kv.prosp_applied)),
        "commit_view": launches_of(lambda: tusk.commit_view(
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
         profiled_device_us_per_round=dev_us / n_prof,
         gc_base_round=kv.base_round(), stats=kv.stats)
    return launches


def kernels_line(dev, kernels, fast_launches, cons_launches, fast_ops, cases):
    """Time each kernel at the fast-path shape beside its plain version,
    its bound and one PyTorch call computing the same function."""
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
    pnc = dict(
        name="pnc_apply", route="cuda", source="janus_tpu_torch/csrc/pnc_apply.cu",
        replaces="janus_tpu/models/pncounter.py:36",
        ms=time_cuda(lambda: kernels.pnc_apply(state["p"], state["n"], fast_ops)),
        plain_ms=time_cuda(lambda: kernels.pnc_apply_plain(
            state["p"], state["n"], fast_ops)),
        library_ms=time_cuda(lambda: (
            state["p"].view(-1).index_put_((lib_idx[1],), lib_val[1], accumulate=True),
            state["n"].view(-1).index_put_((lib_idx[2],), lib_val[2], accumulate=True))),
        bytes=pnc_bytes, operations=int(live.sum()), cells_touched=cells)
    join_bytes = 2 * 2 * R * K * W * 4  # P and N, each read once, written once
    join = dict(
        name="replica_join", route="cuda",
        source="janus_tpu_torch/csrc/replica_join.cu",
        replaces="janus_tpu/runtime/store.py:76",
        ms=time_cuda(lambda: kernels.replica_join(state["p"], state["n"])),
        plain_ms=time_cuda(lambda: kernels.replica_join_plain(state["p"], state["n"])),
        library_ms=time_cuda(lambda: [x.copy_(torch.amax(x, 0).expand_as(x))
                                      for x in (state["p"], state["n"])]),
        bytes=join_bytes, operations=2 * (R - 1) * K * W)
    out = []
    for kern in (pnc, join):
        t_bytes = 1e3 * kern["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * kern["operations"] / INT32_OPS_PER_S
        name = kern["name"]
        out.append({
            **{k: kern[k] for k in ("name", "route", "source", "replaces")},
            "launches": fast_launches[name] + cons_launches[name],
            "launches_by_path": {"fast_path": fast_launches[name],
                                 "consensus": cons_launches[name]},
            "max_abs_err": err[name],
            "ms": kern["ms"], "plain_ms": kern["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": kern["library_ms"],
            "bytes": kern["bytes"], "operations": kern["operations"],
        })
        check(out[-1]["launches"] > 0, f"{name} never launched on the main path")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from janus_tpu_torch import kernels
    from janus_tpu_torch.bench import workloads
    from janus_tpu_torch.kernels import build

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

    fast_ops, cases = kernel_checks(dev, kernels, workloads)
    fast_launches = fast_path(dev, kernels, workloads)
    cons_launches = consensus_path(dev, kernels, workloads, cases)
    line = kernels_line(dev, kernels, fast_launches, cons_launches, fast_ops,
                        cases)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

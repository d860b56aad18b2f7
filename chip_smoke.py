#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (janus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card through its own entry points and
checks every result; any failed check raises, so the script exits
non-zero. Phases, one JSON line each:

1. device     the card's name and power limit (nvidia-smi)
2. build      all five hand kernels compiled from csrc/ with nvcc, in
              parallel
3. kernels    each hand kernel against its plain PyTorch version on the
              card, bit-equal: pnc_apply and replica_join at the fast-path
              shapes, at the consensus path's submit and delta-apply shapes
              and at ragged ones; tusk_commit, causal_closure and dag_round
              (phase dag_kernels) on random states at four (N, W), on a
              constructed back-chain DAG, and on the recorded calls of real
              SafeKV rounds at 4 nodes and at 16 nodes, each with a crashed
              node
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
6. profiler_check  the kernels torch.profiler saw over 20 calls of a
              plain torch kernel, and of causal_closure right after a
              profile of tusk_commit's plain version (the kernels line
              gives each wrapper's count beside its own launch count)
7. the kernels line, the nvidia-smi line, and the result line.

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
# the TPU-era functions each hand kernel replaces
REPLACES = {
    "pnc_apply": "janus_tpu/models/pncounter.py:36",
    "replica_join": "janus_tpu/runtime/store.py:76",
    "tusk_commit": "janus_tpu/consensus/tusk.py:219",
    "causal_closure": "janus_tpu/runtime/safecrdt.py:349",
    "dag_round": "janus_tpu/consensus/dag.py:328",
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
        return type(tree)(tree_map(fn, v) for v in tree)
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
    (module attributes of ``kernels``, which the consensus modules call)
    cloned just before the call; returns ``{name: [args, ...]}``."""
    calls = {name: [] for name in names}
    real = {name: getattr(kernels, name) for name in names}

    def recorder(name):
        def call(*args):
            calls[name].append(tree_map(torch.Tensor.clone, args))
            return real[name](*args)
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
    """Per-kernel counts of the consensus kernels' checks."""

    def __init__(self):
        self.by = {name: {"cases": 0, "max_abs_err": 0} for name in CONSENSUS_KERNELS}
        self.by["tusk_commit"]["committed_cases"] = 0

    def add(self, kernels, name, args, what):
        """The kernel against its plain version on one input, bit-equal;
        returns the kernel's output."""
        out = kernels.WRAPPERS[name](*args)
        err = tree_err(out, plain_of(kernels, name)(*args))
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

    log = CaseLog()
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
                    for j, args in enumerate(calls[name])]
            if name == "tusk_commit":
                committing = sum(bool((out[4] != args[2]["commit_counter"]).any())
                                 for out, args in zip(outs, calls[name]))
        bases = [args[1]["base_round"].item() for args in calls["tusk_commit"]]
        crashed = sum(args[2] is not None and not bool(args[2].all())
                      for args in calls["dag_round"])
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
         hand_kernels_seen_and_launched=hand_seen,
         profiled_device_us_per_round=dev_us / n_prof,
         split_rounds=CONS["split_rounds"],
         ms_per_round_split={f"{k}_ms": v for k, v in split.items()},
         gc_base_round=kv.base_round(), stats=kv.stats)
    return launches


def kernels_line(dev, kernels, fast_launches, cons_launches, fast_ops, cases,
                 timing_calls):
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
    the profiler. A consensus kernel's bytes are the operands its wrapper
    hands it plus its outputs, and its operations one per input element, a
    lower bound on its work."""
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
        args = timing_calls[name][-1]
        fn = kernels.WRAPPERS[name]
        ins, outs = kernel_operands(operands, fn, args)
        kerns.append(dict(
            name=name, call=lambda fn=fn, args=args: fn(*args),
            plain=lambda name=name, args=args: plain_of(kernels, name)(*args),
            library=None, shape=f"N{args[0].num_nodes} W{args[0].num_rounds}, "
            f"last recorded SafeKV call",
            bytes=sum(t.numel() * t.element_size() for t in ins + outs),
            operations=sum(t.numel() for t in ins)))

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
                                    "cells_touched") if k in kern}
        row["ms"] = time_cuda(kern["call"])
        row["plain_ms"] = time_cuda(kern["plain"])
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
            "source": f"janus_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": fast_launches[name] + cons_launches[name],
            "launches_by_path": {"fast_path": fast_launches[name],
                                 "consensus": cons_launches[name]},
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
    timing_calls = consensus_kernel_checks(dev, kernels, workloads, cases)
    fast_launches = fast_path(dev, kernels, workloads)
    cons_launches = consensus_path(dev, kernels, workloads, cases)
    line = kernels_line(dev, kernels, fast_launches, cons_launches, fast_ops,
                        cases, timing_calls)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

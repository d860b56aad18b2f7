#!/usr/bin/env python
"""A/B of the design constants of the hand kernels on the card.

``rga_compact`` (csrc/rga_compact.cu: the blocks an SM its launch bound
asks for, ``MIN_BLOCKS``) on the rga preset's compaction at tick 3
(R=1,024, K=128, C=1,024, in place, as ``chip_smoke.py`` times it), and
``mvr_apply`` (csrc/mvr_apply.cu: the lanes in flight ahead of the walk,
``RING``) on a captured delta apply at the mvr_consensus phase's geometry
(64 views, 500 keys under Zipf-0.99, V = 8, W = 64: 64 origins' blocks of
64 writes, each captured at its origin, in a batch of 16,384 lanes a
view), and ``slot_union`` (csrc/slot_union.cu: the rows a block of the
OR-Set's warp merge holds, ``WARP_ROWS``) on level 1 of the OR-Set
store's converge (32 x 500 rows of 256 + 256 slots, path B's first tick)
and on level 1 of a delta tick's row-list tree (``slot_union_rows``, the
two-type store at mixed_delta's geometry); and the 2P layouts of the same
source (``WARP_ROWS`` again) on level 1 of each tree of ``chip_smoke.py``'s
``tp_store`` phase (``tp_union`` on the 2P-Set's 256-slot rows and on the
Graph's 32-slot vertex rows, ``edge_union``, and their row-list modes) at
its first two ticks and at ``TP_CHECKS["late_tick"]``, the first tick
whose edge adds find their vertices. Each variant is a copy of
the source with one ``constexpr int`` set to another value, built by
``nvcc`` into ``janus_tpu_torch/build/ab/`` with the package's flags,
put in the loader's place for the time of its turn, and held bit-equal to
the plain version (on a slice of the inputs, or on every 2P call); the
variants are then timed
in turns (first to last, then last to first), each turn by CUDA events
around ``REPS`` calls queued behind a sleeping kernel after a warm-up.
The LWW layout of ``slot_union.cu`` (``WARP_ROWS`` as it is) is timed on
level 1 of ``chip_smoke.py``'s ``typed_store`` LWW tree, full and
row-list, at its first two ticks and at ``TYPED_CHECKS["late_tick"]``;
and ``graph_apply.cu``'s walk (the warps a block, ``WARPS``) on the four
walk wrappers' calls ``chip_smoke.py`` times (the delta applies and the
captures of its graph_consensus and tpset_consensus phases) and on the
applies of its ``tp_store`` phase at ticks 0, 1 and ``late_tick``, every
call checked against the plain version. Prints one JSON line per kernel
and the card's name and power limit:

    python scripts/kernel_ab.py [--parent DIR] [--parts compact,mvr,...]

With ``--parent``, ``DIR/janus_tpu_torch/csrc/slot_union.cu`` (an earlier
checkout, e.g. unpacked by ``git archive``) joins the slot_union turns, the
2P turns and the LWW turns as one more variant, ``parent``, and
``DIR/janus_tpu_torch/csrc/graph_apply.cu`` the walk's (the source before
the walk's redesign, called as its own wrapper called it:
``parent_walk``). ``--parts`` picks
the parts to run, of ``compact``, ``mvr``, ``orset``, ``tp``, ``lww``,
``walk``, ``rga``, ``ring``, ``replay``, ``lwwwalk``, ``orsetapply``,
``select``, ``safekv`` and ``round`` (all by default).

Part ``rga`` prints how the lanes of ``chip_smoke.py``'s rga_consensus
delta applies fall on their (view, row) groups (``RGA_ROUNDS`` rounds
recorded by ``chip_smoke.record_rga_churn``), then times ``rga_apply`` on
the rga preset's tick-3 apply and on the heaviest delta apply under the
package's build (``tree``), ``RGA_VARIANTS`` and, with ``--parent``, that
checkout's ``rga_apply.cu`` called as its wrapper called it; every
variant held bit-equal to the plain version (computed once a call). Part
``ring`` times ``ring_resize`` on the adaptive presets' OR-Set ring
halved and grown back, and to and from 2,557 lanes: ms a call with host
work and device ms, the package's build and the parent's source with its
wrapper in turns (tree, parent, parent, tree), beside the library calls
and the bound.

Part ``replay`` records every ``orset_replay`` call of four runs
(chip_smoke's orset_consensus phase, harness presets ``orset`` and
``orset4``, a split OR-Set cluster) and part ``lwwwalk`` every
``lww_apply`` / ``lww_capture`` call of lww_consensus's first
``LWW_ROUNDS`` rounds and typed_store's first ``LWW_TICKS`` ticks; each
prints how the calls' records fall on their (view, row) groups
(``chip_smoke.replay_walk_stats``, ``lww_walk_stats``), holds every call
bit-equal to the plain version under the package's build and, with
``--parent``, that checkout's source called as its wrapper called it,
prints each kernel's device µs a call by the profiler on the timed
calls, then times in turns (tree, parent, parent, tree) the timed calls
(device ms and ms a call) and each run's whole list of calls (device ms
in bursts of ``BURST_CALLS``, and ms with host work). ~4 min for both.

Part ``orsetapply`` records every ``orset_apply`` call of chip_smoke's
orset_store and store_delta phases and one at its "hot key B8192" shape,
and prints how their lanes fall on (replica, row) groups
(``chip_smoke.apply_walk_stats``); part ``select`` the first
``SELECT_CALLS`` ``block_select`` calls of the consensus,
orset_consensus and rga_consensus phases, harness presets pnc, orset and
mixed and a split cluster, with each call's V, W, N, A, ring fields and
chosen share (``select_stats``). Both then run ``calls_ab`` as the two
parts above do. ~5 min for both.

Part ``safekv`` records the SafeKV round's accept + board
(``safekv_submit``, ``safekv_board``) and GC (``gc_frontier`` with the
ring clear) calls of chip_smoke's recorded SafeKV runs at 4, 16 and 64
nodes and of its 16-node 2P-Set and Graph phases (``safekv_inputs``),
holds every call bit-equal to the plain versions under the package's
build, ``SAFEKV_VARIANTS`` and, with ``--parent``, that checkout's two
sources under that checkout's own wrapper modules (``parent_module``);
then splits each run's timed calls into their
kernels (the profiler), the GC kernel into its phases (clock stamps at
its barriers, ``stamped``) and the operand checks' host time
(``placement_us``), and times them in turns: device ms, ms a call and
the host's queueing µs a call, and each run's calls in bursts (~1-2
min).

Part ``round`` records every ``dag_round`` call of chip_smoke's recorded
SafeKV runs at 4, 16 and 64 nodes and of its split PN-Counter cluster
(``round_inputs``), and every GC advance of the OR-Set in its
orset_consensus runs and in one run of harness preset orset
(``fence_inputs``: the fused ``orset_compact_fences`` call, or the
watermark and two compactions of a checkout without it), holds each
bit-equal to the plain versions under the package's build and, with
``--parent``, DIR's ``dag_round.cu`` and ``orset_compact.cu`` under
DIR's own wrapper modules; prints each advance's rows, rows that drop a
slot and rows it changes with its byte bound, the timed calls' kernels
(profiler), dag_round's one block split into its steps by clock stamps
(``stamped``) and the card's launch floors (an empty kernel, an empty
pair by programmatic dependent launch), then times the calls in turns:
device ms, ms a call, queueing µs (an advance on fresh copies, and
repeated in place) and each run's dag_round calls in bursts (~2 min).
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from janus_tpu_torch import kernels  # noqa: E402
from janus_tpu_torch.bench import workloads  # noqa: E402
from janus_tpu_torch.kernels import build  # noqa: E402

REPS = 20
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock
COMPACT_VARIANTS = {f"min{b}": {"MIN_BLOCKS": b} for b in (6, 8, 4)}
WALK_VARIANTS = {f"ring{r}": {"RING": r} for r in (8, 16)}
UNION_VARIANTS = {f"rows{r}": {"WARP_ROWS": r} for r in (2, 4, 8, 16)}
TP_VARIANTS = {f"rows{r}": {"WARP_ROWS": r} for r in (2, 4)}
LWW_VARIANTS = {"rows2": {"WARP_ROWS": 2}}
GRAPH_WALK_VARIANTS = {f"warps{w}": {"WARPS": w} for w in (8, 4, 16)}
# rounds of the rga_consensus phase whose delta applies are recorded
RGA_ROUNDS = 6
# rga_apply.cu's buckets held to 64 lanes (the heaviest recorded delta
# apply fills them exactly)
RGA_VARIANTS = {"lanes64": {"GROUP_LANES": 64}}
PARTS = ("compact", "mvr", "orset", "tp", "lww", "walk", "rga", "ring",
         "replay", "lwwwalk", "orsetapply", "select", "safekv", "round")
# the recorded runs of part replay; rounds of lww_consensus and ticks of
# typed_store part lwwwalk records
REPLAY_PRESETS = ("orset", "orset4")
LWW_ROUNDS = 4
LWW_TICKS = 18
# a burst of up to BURST_CALLS of a run's calls sleeps this long first
# (~100 ms: the host queues them meanwhile)
BURST_SLEEP_CYCLES = 200_000_000
BURST_CALLS = 64
# the block_select calls part select keeps of each recorded run (its first)
SELECT_CALLS = 64
# rounds of the tpset_consensus and graph_consensus phases part safekv
# records
TP_ROUNDS = 4
# part safekv's variants of the two sources: (tag, source, constants)
SAFEKV_VARIANTS = (("gc256", "gc_frontier", {"GC_THREADS": 256}),
                   ("chunk2048", "safekv_submit", {"CHUNK": 2048}))


def build_variant(name, constants, tag) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with each named ``constexpr int`` set to its
    value, built into ``build/ab/lib<name>_<tag>.so`` and loaded."""
    text = (build.CSRC / f"{name}.cu").read_text()
    for const, value in constants.items():
        text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{name}.cu: no single constant {const}")
    return build_text(name, text, tag)


def build_text(name, text, tag) -> ctypes.CDLL:
    """The source ``text`` of kernel ``name`` built with the package's
    flags (the package's headers on the include path) into
    ``build/ab/lib<name>_<tag>.so`` and loaded."""
    ab = build.BUILD / "ab"
    ab.mkdir(parents=True, exist_ok=True)
    src, out = ab / f"{name}_{tag}.cu", ab / f"lib{name}_{tag}.so"
    src.write_text(text)
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
    return ctypes.CDLL(str(out))


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def use(name, lib) -> None:
    """Make ``lib`` the library the wrapper of ``name`` launches (None:
    the package's own build again, at its next load); a wrapper on the
    lean launch path binds its entry again at its next call."""
    import importlib

    if lib is None:
        build._LIBS.pop(name, None)
    else:
        build._LIBS[name] = lib
    module = importlib.import_module(f"janus_tpu_torch.kernels.{name}")
    for x in vars(module).values():
        if isinstance(x, build.LeanLaunch) and x.name == name:
            x._fn = None


def device_ms(fn, reps=REPS) -> float:
    """Device milliseconds a call, by CUDA events around ``reps`` calls
    queued behind a sleeping kernel: the host queues the whole burst
    before the device starts it, so the span holds no host time (as
    ``chip_smoke.device_burst_ms``). Raises if the host took longer to
    queue than the device slept."""
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
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError(f"queueing took {host_ms} ms, longer than the "
                           f"sleep")
    return ev[1].elapsed_time(ev[2]) / reps


def same(a, b) -> bool:
    if isinstance(a, dict):
        return all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return a == b


def clone(tree):
    """Clones of a nest's tensors (dicts, tuples and lists of them; other
    leaves as they are)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def compaction_input(dev):
    """The rga preset's state after its warm-up tick and compaction and
    ticks 1-3, as ``chip_smoke.rga_kernel_checks`` records it."""
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import replicated_init

    R, K, L, lag = 1024, 128, 16, 2
    cap = R * L // K * (lag + 4 + 2)
    host = np.random.default_rng(0)
    state = replicated_init(rga.SPEC, R, device=dev, num_keys=K, capacity=cap,
                            max_depth=8)
    tick = make_tick(rga.SPEC, device=dev)
    for t in range(4):
        tick(state, workloads.ops_to_device(
            workloads.rga_text_replay(host, R, K, L, lag, t), dev))
        if t == 0:
            rga.compact(state)
    return {f: state[f] for f in rga.FIELDS}


def walk_input(dev):
    """(state, captured ops) of a delta apply at the mvr_consensus
    geometry: each origin's 64 Zipf writes captured against an empty
    row set (its clocks chain per key, concurrent across origins), every
    view then applying all 4,096 of them among 16,384 lanes."""
    from janus_tpu_torch.models import mvregister

    N, K, vc, b, B = 64, 500, 8, 64, 16384
    rng = np.random.default_rng(22)
    empty = mvregister.init(K, N, vc, device=dev)
    views = {f: x.unsqueeze(0).expand((N,) + x.shape).contiguous()
             for f, x in empty.items()}
    own = workloads.ops_to_device(workloads.mvr_writes(rng, N, K, b), dev)
    wclock, _ = kernels.mvr_capture(clone(views), own)
    ops = {f: torch.zeros((N, B), dtype=torch.int32, device=dev)
           for f in own}
    ops["wclock"] = torch.zeros((N, B, N), dtype=torch.int32, device=dev)
    for f, x in own.items():
        ops[f][:, : N * b] = x.reshape(1, N * b)
    ops["wclock"][:, : N * b] = wclock.reshape(1, N * b, N)
    return views, ops


def union_inputs(dev):
    """(args, kwargs) of the first level-1 call of ``slot_union`` in a
    tick of the OR-Set store at R=64, K=500, C=256, B=64 (a Zipf hot
    window of 32 keys), and of ``slot_union_rows`` in a delta tick of the
    two-type store at R=64, K=500, budget 64: the calls ``chip_smoke.py``
    times, at their geometry."""
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import Store, replicated_init
    from janus_tpu_torch.utils.ids import TagMinter

    R, K, C, B = 64, 500, 256, 64
    rng = np.random.default_rng(9)
    calls = {}
    real = {n: getattr(kernels, n) for n in ("slot_union", "slot_union_rows")}

    def spy(name):
        def call(*args, **kw):
            calls.setdefault(name, clone((args, kw)))
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(kernels, name, spy(name))
    try:
        state = replicated_init(orset.SPEC, R, device=dev, num_keys=K,
                                capacity=C, rm_capacity=8)
        mint = [TagMinter(i) for i in range(R)]
        make_tick(orset.SPEC, device=dev)(state, workloads.ops_to_device(
            workloads.orset_hot_window(rng, mint, K, B, 0, 32), dev))
        store = Store(R, {"pnc": dict(num_keys=K, num_writers=R),
                          "orset": dict(num_keys=K, capacity=C,
                                        rm_capacity=8)},
                      dirty_budget=64, device=dev)
        mint = [TagMinter(i) for i in range(R)]
        ops = workloads.store_delta_tick(rng, mint, K, B, 0, 32)
        store.fused_tick({tc: workloads.ops_to_device(o, dev)
                          for tc, o in ops.items()})
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    return calls["slot_union"], calls["slot_union_rows"]


def tp_union_inputs(dev):
    """(wrapper name, args, kwargs) of the level-1 calls of the 2P unions in
    ``chip_smoke.py``'s ``tp_store`` phase (its streams and both arms) at
    ticks 0, 1 and ``TP_CHECKS["late_tick"]``: the 2P-Set's tree and the
    Graph's vertex and edge trees, full and row-list, labelled
    ``<tree>_t<tick>`` and ``<tree>_rows_t<tick>``."""
    import chip_smoke

    late = chip_smoke.TP_CHECKS["late_tick"]
    calls, tick = {}, [0]
    names = ("tp_union", "tp_union_rows", "edge_union", "edge_union_rows")
    real = {n: getattr(kernels, n) for n in names}

    def spy(name):
        def call(*args, **kw):
            tree = chip_smoke.tp_level1(name, args, kw)
            if tree is not None and tick[0] in (0, 1, late):
                rows = "_rows" if name.endswith("_rows") else ""
                calls.setdefault(f"{tree}{rows}_t{tick[0]}",
                                 (name, clone((args, kw))))
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(kernels, name, spy(name))
    try:
        arms = chip_smoke.tp_store_arms(dev)
        for t, host in enumerate(chip_smoke.tp_store_stream(workloads,
                                                            late + 1)):
            tick[0] = t
            batch = {tc: workloads.ops_to_device(o, dev)
                     for tc, o in host.items()}
            for st, use_delta in arms.values():
                st.fused_tick(batch, delta=use_delta)
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    return dict(sorted(calls.items()))


def lww_union_inputs(dev):
    """(wrapper name, args, kwargs) of the level-1 calls of the LWW union
    in ``chip_smoke.py``'s ``typed_store`` phase (its streams and both
    arms) at ticks 0, 1 and ``TYPED_CHECKS["late_tick"]``, full and
    row-list, labelled ``lww_t<tick>`` and ``lww_rows_t<tick>``."""
    import chip_smoke

    late = chip_smoke.TYPED_CHECKS["late_tick"]
    calls, tick = {}, [0]
    names = ("lww_union", "lww_union_rows")
    real = {n: getattr(kernels, n) for n in names}

    def spy(name):
        def call(*args, **kw):
            if chip_smoke.typed_level1(name, args, kw) and tick[0] in (
                    0, 1, late):
                rows = "_rows" if name.endswith("_rows") else ""
                calls.setdefault(f"lww{rows}_t{tick[0]}",
                                 (name, clone((args, kw))))
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(kernels, name, spy(name))
    try:
        arms = chip_smoke.typed_store_arms(dev)
        for t, host in enumerate(chip_smoke.typed_store_stream(workloads,
                                                               late + 1)):
            tick[0] = t
            batch = {tc: workloads.ops_to_device(o, dev)
                     for tc, o in host.items()}
            for st, use_delta in arms.values():
                st.fused_tick(batch, delta=use_delta)
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    return dict(sorted(calls.items()))


def walk_inputs(dev):
    """(wrapper name, args, kwargs) of the walk's calls: the four wrappers'
    calls ``chip_smoke.py`` times (the delta applies and the captures with
    the most live lanes among the first ``TP_CHECKS["rounds"]`` rounds of
    graph_consensus and tpset_consensus), labelled by wrapper, and the
    applies of its ``tp_store`` phase (full arm) at ticks 0, 1 and
    ``TP_CHECKS["late_tick"]``, labelled ``<wrapper>_store_t<tick>``."""
    import chip_smoke

    codes = {"graph_apply": (1, 2, 3, 4), "tpset_apply": (1, 2),
             "graph_capture": (1, 2, 3, 4), "tpset_capture": (1, 2)}
    late = chip_smoke.TP_CHECKS["late_tick"]
    best, calls, tag = {}, {}, {"run": "", "tick": -1}
    real = {n: getattr(kernels, n) for n in codes}

    def spy(name):
        def call(state, ops):
            if tag["run"] == "consensus":
                live = chip_smoke.live_lanes(ops, codes[name])
                if live > best.get(name, (-1,))[0]:
                    best[name] = (live, (name, clone(((state, ops), {}))))
            elif tag["tick"] in (0, 1, late):
                calls.setdefault(f"{name}_store_t{tag['tick']}",
                                 (name, clone(((state, ops), {}))))
            return real[name](state, ops)
        return call

    for name in codes:
        setattr(kernels, name, spy(name))
    try:
        tag["run"] = "consensus"
        for kind, g in (("tpset", chip_smoke.TPSET_CONS),
                        ("graph", chip_smoke.GRAPH_CONS)):
            kv = chip_smoke.tp_kv(dev, kind, g)
            for ops in chip_smoke.tp_stream(workloads, kind, g,
                                            chip_smoke.TP_CHECKS["rounds"]):
                kv.step(workloads.ops_to_device(ops, dev))
            del kv
        tag["run"] = "tp_store"
        st, _ = chip_smoke.tp_store_arms(dev)["full"]
        for t, host in enumerate(chip_smoke.tp_store_stream(workloads,
                                                            late + 1)):
            tag["tick"] = t
            st.fused_tick({tc: workloads.ops_to_device(o, dev)
                           for tc, o in host.items()})
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    return {**{name: call for name, (_, call) in sorted(best.items())},
            **dict(sorted(calls.items()))}


def rga_apply_inputs(dev):
    """(args, kwargs) of the ``rga_apply`` calls ``chip_smoke.py`` times:
    the rga preset's apply at tick 3 (R=1,024, K=128, C=1,024, 32 lanes a
    replica), labelled ``replay``, and the delta applies of the first
    ``RGA_ROUNDS`` rounds of the rga_consensus phase (4 views, 128
    documents of 1,024 slots, 16,384 lanes a view), as ``chip_smoke.
    record_rga_churn`` records them, in order."""
    import chip_smoke
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import replicated_init

    R, K, L, lag = 1024, 128, 16, 2
    cap = R * L // K * (lag + 4 + 2)
    host = np.random.default_rng(0)
    state = replicated_init(rga.SPEC, R, device=dev, num_keys=K, capacity=cap,
                            max_depth=8)
    tick = make_tick(rga.SPEC, device=dev)
    real, kept = kernels.rga_apply, []

    def spy(*args, **kw):
        kept[:] = [clone((args, kw))]
        return real(*args, **kw)

    for t in range(4):
        kernels.rga_apply = spy if t == 3 else real
        try:
            tick(state, workloads.ops_to_device(
                workloads.rga_text_replay(host, R, K, L, lag, t), dev))
        finally:
            kernels.rga_apply = real
        if t == 0:
            rga.compact(state)
    del state
    calls, _ = chip_smoke.record_rga_churn(dev, kernels, workloads,
                                           RGA_ROUNDS, ("rga_apply",))
    torch.cuda.synchronize()
    return kept[0], calls["rga_apply"]


def plain_checked(calls):
    """A check of ``calls`` as ``check_calls`` makes it, with each call's
    plain result computed once and kept (a plain walk of 16,384 lanes a
    view takes seconds), so that every variant is held against it."""
    kept = {}

    def check():
        ok = True
        for label, (name, call) in calls.items():
            if label not in kept:
                pargs, pkw = clone(call)
                kept[label] = (getattr(kernels, name + "_plain")(*pargs,
                                                                 **pkw),
                               pargs)
            (args, kw), (want, pargs) = clone(call), kept[label]
            ok &= same(getattr(kernels, name)(*args, **kw), want)
            ok &= same(args, pargs)
        return ok
    return check


def parent_rga(lib, state, ops):
    """One ``rga_apply`` call through the kernel of ``git show cd8c641:
    janus_tpu_torch/csrc/rga_apply.cu`` built as ``lib``, as that
    checkout's wrapper made it (no scratch: a block a (replica, row)
    scanned every lane)."""
    from janus_tpu_torch.kernels.rga_rows import FIELDS, OP_FIELDS

    R, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    dev = state["valid"].device
    dropped = torch.zeros((R,), dtype=torch.int32, device=dev)
    ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    entry = lib.rga_apply_launch
    entry.argtypes = [arr, ptr, arr, ptr] + [ctypes.c_int] * 4 + [ptr]
    entry.restype = ctypes.c_int
    eff = ops.get("eff_ctr")
    st = (ptr * 7)(*(state[f].data_ptr() for f in FIELDS))
    op = (ptr * 7)(*(ops[f].data_ptr() for f in OP_FIELDS),
                   None if eff is None else eff.data_ptr())
    rc = entry(st, state["ctr_floor"].data_ptr(), op, dropped.data_ptr(), R,
               K, C, B, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rga_apply (parent): CUDA error {rc}")
    return dropped


def parent_rga_runs(calls):
    """``run_ab``'s ``parent_wrap`` for rga_apply: the parent's calls and
    check through ``parent_rga``."""
    def wrap(lib):
        timed = {label: (lambda a=args: parent_rga(lib, *a))
                 for label, (_, (args, _)) in calls.items()}
        check_plain = plain_checked(calls)

        def check():
            real = kernels.rga_apply
            kernels.rga_apply = lambda st, ops: parent_rga(lib, st, ops)
            try:
                return check_plain()
            finally:
                kernels.rga_apply = real
        return timed, check
    return wrap


def parent_ring(lib, ring, new_b):
    """One ``ring_resize`` call through the kernel of ``git show cd8c641:
    janus_tpu_torch/csrc/ring_resize.cu`` built as ``lib``, with that
    checkout's wrapper's host work: the operand check, a fresh tensor a
    field and a zeroed flag, the widths read by indexing, the device
    switch and the stream."""
    from janus_tpu_torch.kernels import operands

    names = list(ring)
    w, n, b = (int(x) for x in ring["op"].shape)
    dev = operands.placement("ring_resize", [
        (f"ring.{f}", ring[f], torch.int32,
         (w, n, b) + tuple(ring[f].shape[3:])) for f in names])
    out = {f: torch.empty((w, n, new_b) + tuple(ring[f].shape[3:]),
                          dtype=torch.int32, device=dev) for f in names}
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    k = len(names)
    src = (ctypes.c_void_p * k)(*(ring[f].data_ptr() for f in names))
    dst = (ctypes.c_void_p * k)(*(out[f].data_ptr() for f in names))
    width = (ctypes.c_longlong * k)(*(ring[f][0, 0, 0].numel()
                                      for f in names))
    fn = lib.ring_resize_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(src, dst, width, k, w * n, b, new_b, names.index("op"),
                flag.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ring_resize (parent): CUDA error {rc}")
    return out, flag


def host_ms(fn, reps=REPS) -> float:
    """Milliseconds a call, host work included: CUDA events around
    ``reps`` calls after a warm-up (as ``chip_smoke.time_cuda``)."""
    for _ in range(3):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def ring_ab(parent, smi):
    """ring_resize on the adaptive presets' OR-Set ring (W 8, N 16, 9
    fields, 72 bytes a lane) halved (5,120 -> 2,560) and grown back, and
    on a shrink and a grow to lane counts that are not multiples of 4
    (5,120 -> 2,557 and 2,557 -> 5,120), under the package's build and,
    given ``parent``, that source with its wrapper (``parent_ring``), in
    turns (tree, parent, parent, tree): ms a call with host work, device
    ms, both held bit-equal to the plain version; and the library calls
    (a slice made contiguous a field and the tail's any(), or F.pad)."""
    import chip_smoke
    from janus_tpu_torch.kernels.ring_resize import ring_resize_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    extras = workloads.RING_EXTRAS["orset"]
    cases = {}
    for label, b, new_b in (("shrink", 5120, 2560), ("grow", 2560, 5120),
                            ("shrink_odd", 5120, 2557),
                            ("grow_odd", 2557, 5120)):
        ring = workloads.ops_to_device(workloads.ring_resize_case(
            rng, 8, 16, b, new_b, extras, False), dev)
        cases[label] = (ring, new_b)
    libs = {"tree": None}
    if parent is not None:
        libs["parent"] = build_text("ring_resize",
                                    pathlib.Path(parent).read_text(),
                                    "parent")

    def call(tag, ring, new_b):
        if tag == "tree":
            return lambda: kernels.ring_resize(ring, new_b)
        return lambda: parent_ring(libs[tag], ring, new_b)

    for tag in libs:
        for label, (ring, new_b) in cases.items():
            got = call(tag, ring, new_b)()
            want = ring_resize_plain(ring, new_b)
            if not same(got, want):
                raise AssertionError(f"ring_resize {tag} {label}: differs "
                                     f"from plain")
    out = {tag: {label: {"ms": [], "device_ms": []} for label in cases}
           for tag in libs}
    for tag in list(libs) + list(reversed(libs)):
        for label, (ring, new_b) in cases.items():
            out[tag][label]["ms"].append(host_ms(call(tag, ring, new_b)))
            out[tag][label]["device_ms"].append(
                device_ms(call(tag, ring, new_b)))
    lib_ms = {label: host_ms(chip_smoke.ring_library(ring, new_b))
              for label, (ring, new_b) in cases.items()}
    bound = {label: 1e3 * chip_smoke.ring_bytes(ring, new_b)
             / chip_smoke.HBM_BYTES_PER_S
             for label, (ring, new_b) in cases.items()}
    print(json.dumps({"kernel": "ring_resize", "nvidia_smi": smi,
                      "library_ms": lib_ms, "bound_ms": bound, **out}),
          flush=True)


def check_calls(calls):
    """Every call of ``calls`` (label: (wrapper name, (args, kwargs)))
    through the wrapper and its plain version on clones, bit-equal, the
    in-place updates included."""
    ok = True
    for name, call in calls.values():
        (args, kw), (pargs, pkw) = clone(call), clone(call)
        ok &= same(getattr(kernels, name)(*args, **kw),
                   getattr(kernels, name + "_plain")(*pargs, **pkw))
        ok &= same(args, pargs)
    return ok


def timed_calls(calls):
    """Labels to functions calling each wrapper on its recorded inputs
    (which the in-place wrappers update, as ``chip_smoke.py`` times
    them)."""
    return {label: (lambda n=name, a=args, k=kw: getattr(kernels, n)(*a, **k))
            for label, (name, (args, kw)) in calls.items()}


def run_ab(name, variants, calls, check, parent=None, parent_wrap=None,
           own=False):
    """Build each variant (and, given ``parent``, that source as one more,
    ``parent``), check it, then time every call of ``calls`` (a dict of
    labels to functions) under all of them in turns. ``parent_wrap(lib)``,
    where the parent's source has another C interface than the package's
    wrapper calls, gives the parent's own ``(calls, check)`` on ``lib``.
    ``own`` adds the package's own build as one more variant, ``tree``."""
    libs = {"tree": build.load(name)} if own else {}
    for tag, constants in variants.items():
        libs[tag] = build_variant(name, constants, tag)
    if parent is not None:
        libs["parent"] = build_text(name, pathlib.Path(parent).read_text(),
                                    "parent")
    runs = {tag: (calls, check) for tag in libs}
    if parent is not None and parent_wrap is not None:
        runs["parent"] = parent_wrap(libs["parent"])
    for tag, lib in libs.items():
        use(name, lib)
        if not runs[tag][1]():
            raise AssertionError(f"{name} {tag}: differs from plain")
    order = list(libs) + list(reversed(libs))
    times = {tag: {label: [] for label in calls} for tag in libs}
    for tag in order:
        use(name, libs[tag])
        for label, call in runs[tag][0].items():
            times[tag][label].append(device_ms(call))
    use(name, None)
    return {tag: {"constants": variants.get(tag, "parent source"),
                  **{label: {"device_ms": t, "mean_ms": sum(t) / len(t)}
                     for label, t in by.items()}}
            for tag, by in times.items()}


def parent_walk(lib, name, state, ops):
    """One call of wrapper ``name`` (graph_apply, graph_capture, tpset_apply
    or tpset_capture) through the walk of ``git show c0936e7:janus_tpu_torch
    /csrc/graph_apply.cu`` built as ``lib``, as that checkout's wrapper
    made it: its scratch is lane_buckets' count, start and lanes
    (the redesigned source takes a count and a bucket of records)."""
    from janus_tpu_torch.kernels.graph_apply import (OP_FIELDS, TP_OP_FIELDS,
                                                     _vertices)
    from janus_tpu_torch.kernels.tp_rows import GRAPH_FIELDS, VERTEX_LEAVES

    edges, capture = name.startswith("graph"), name.endswith("capture")
    st = state if edges else _vertices(state)
    fields = GRAPH_FIELDS if edges else VERTEX_LEAVES
    op_fields = OP_FIELDS if edges else TP_OP_FIELDS
    V, K, CV = st["v"].shape
    CE = st["src"].shape[-1] if edges else 0
    B = ops["op"].shape[1]
    dev = st["v"].device
    i32 = torch.int32
    dropped = torch.zeros((V,), dtype=i32, device=dev)
    ok_out = torch.ones((V, B, 1), dtype=i32, device=dev) if capture else None
    ok = None if capture else ops.get("ok")
    scratch = (torch.zeros((V, K), dtype=i32, device=dev),
               torch.empty((V, K + 1), dtype=i32, device=dev),
               torch.empty((V, B), dtype=i32, device=dev))
    ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    entry = getattr(lib, f"{'graph' if edges else 'tpset'}_"
                         f"{'capture' if capture else 'apply'}_launch")
    geo = (V, K, CV, CE, B) if edges else (V, K, CV, B)
    entry.argtypes = ([arr, arr] + ([ptr] if capture else []) + [ptr, arr]
                      + [ctypes.c_int] * len(geo) + [ptr])
    entry.restype = ctypes.c_int
    st_p = (ptr * len(fields))(*(st[f].data_ptr() for f in fields))
    op_p = (ptr * (len(op_fields) + 1))(
        *(ops[f].data_ptr() for f in op_fields),
        None if ok is None else ok.data_ptr())
    sc = (ptr * 3)(*(x.data_ptr() for x in scratch))
    stream = torch.cuda.current_stream(dev).cuda_stream
    extra = [ok_out.data_ptr()] if capture else []
    rc = entry(st_p, op_p, *extra, dropped.data_ptr(), sc, *geo, stream)
    if rc != 0:
        raise RuntimeError(f"{name} (parent): CUDA error {rc}")
    return (ok_out, dropped) if capture else dropped


def parent_walk_runs(calls):
    """``run_ab``'s ``parent_wrap`` for the walk: the parent's calls and
    check through ``parent_walk``."""
    def wrap(lib):
        timed = {label: (lambda n=name, a=args: parent_walk(lib, n, *a))
                 for label, (name, (args, _)) in calls.items()}

        def check():
            ok = True
            for name, call in calls.values():
                (args, _), (pargs, _) = clone(call), clone(call)
                ok &= same(parent_walk(lib, name, *args),
                           getattr(kernels, name + "_plain")(*pargs))
                ok &= same(args, pargs)
            return ok
        return timed, check
    return wrap


def burst_ms(fns, sleep=BURST_SLEEP_CYCLES) -> float:
    """Device milliseconds of one pass over ``fns`` (a list of calls),
    by CUDA events around the pass queued behind a sleeping kernel, as
    ``device_ms`` times a burst of one call; the sleep doubles until the
    host queues the pass before it ends (raises after four tries)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(sleep)
        ev[1].record()
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        host = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        if host < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2])
        sleep *= 2
    raise RuntimeError(f"queueing took {host} ms, longer than the sleep")


def pass_ms(fns) -> float:
    """Milliseconds of one pass over ``fns``, host work included, by CUDA
    events after a warm-up pass."""
    for fn in fns:
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for fn in fns:
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def replay_inputs(dev):
    """Every ``orset_replay`` call (args, kwargs) of the recorded runs, by
    run: ``orset_consensus`` (``chip_smoke.record_orset_consensus``: the
    phase's two runs, its submits and delta applies), the harness presets
    of ``REPLAY_PRESETS`` (``run_tensor`` uncut, labelled
    ``harness_<preset>``) and ``split_orset`` (chip_smoke's split_run of
    the OR-Set at ``SPLIT_ORSET``: its four processes' calls)."""
    import chip_smoke
    from janus_tpu_torch.bench import harness

    names = ("orset_replay",)
    runs = {"orset_consensus": chip_smoke.record_orset_consensus(
        dev, kernels, workloads, names)[0]["orset_replay"]}
    for preset in REPLAY_PRESETS:
        runs[f"harness_{preset}"] = chip_smoke.record_calls(
            kernels, names, lambda p=preset: harness.run_tensor(
                harness.PRESETS[p], device=dev), aliased=True)["orset_replay"]
    runs["split_orset"] = chip_smoke.record_calls(
        kernels, names, lambda: chip_smoke.split_run(
            dev, kernels, workloads, "orset", chip_smoke.SPLIT_ORSET, 22),
        aliased=True)["orset_replay"]
    torch.cuda.synchronize()
    return runs


def lww_inputs(dev):
    """Every ``lww_apply`` and ``lww_capture`` call of the first
    ``LWW_ROUNDS`` rounds of chip_smoke's lww_consensus phase and the
    first ``LWW_TICKS`` ticks of its typed_store phase (both arms), by
    run and wrapper: ``{"lww_consensus/lww_apply": [(args, kwargs),
    ...], ...}``."""
    import chip_smoke

    names = ("lww_apply", "lww_capture")
    runs = {}

    def consensus():
        kv = chip_smoke.typed_kv(dev, "lww", chip_smoke.LWW_CONS)
        for ops in chip_smoke.typed_stream(workloads, "lww",
                                           chip_smoke.LWW_CONS, LWW_ROUNDS):
            kv.step(workloads.ops_to_device(ops, dev))

    def store():
        arms = chip_smoke.typed_store_arms(dev)
        for tick in chip_smoke.typed_store_stream(workloads, LWW_TICKS):
            batch = {tc: workloads.ops_to_device(o, dev)
                     for tc, o in tick.items()}
            for st, use_delta in arms.values():
                st.fused_tick(batch, delta=use_delta)

    for run, fn in (("lww_consensus", consensus), ("typed_store", store)):
        calls = chip_smoke.record_calls(kernels, names, fn, aliased=True)
        for name in names:
            if calls[name]:
                runs[f"{run}/{name}"] = calls[name]
    torch.cuda.synchronize()
    return runs


def parent_replay(lib, state, ops):
    """One ``orset_replay`` call through the kernel of ``git show
    8b328be:janus_tpu_torch/csrc/orset_replay.cu`` built as ``lib``, with
    that checkout's wrapper's host work: the operand check, the device
    context, five allocations (the outputs, zeroed counts, offsets,
    cursors and a 16-byte record per state slot and op record)."""
    from janus_tpu_torch.kernels import operands
    from janus_tpu_torch.kernels.orset_rows import (CAPTURE_FIELDS, DTYPES,
                                                    FIELDS, op_operands,
                                                    slot_operands)

    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    R = ops["rm_rep"].shape[-1]
    dev = operands.placement("orset_replay", [
        *slot_operands("state.", state, (V, K, C)), *op_operands(ops, (V, B)),
        *op_operands(ops, (V, B, R), CAPTURE_FIELDS)])
    out = {f: torch.empty((V, K, C), dtype=DTYPES[f], device=dev)
           for f in FIELDS}
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    counts = torch.zeros((V, K + 1), dtype=torch.int32, device=dev)
    offsets = torch.empty((V, K + 2), dtype=torch.int32, device=dev)
    cursor = torch.empty((V, K + 1), dtype=torch.int32, device=dev)
    records = torch.empty((V * (K * C + B * R), 4), dtype=torch.int32,
                          device=dev)
    entry = lib.orset_replay_launch
    if entry.argtypes is None:
        entry.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        entry.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*(state[f].data_ptr() for f in FIELDS),
                   *(ops[f].data_ptr() for f in ("op", "key", "a0", "a1",
                                                 "a2")),
                   *(ops[f].data_ptr() for f in CAPTURE_FIELDS),
                   *(out[f].data_ptr() for f in FIELDS), dropped.data_ptr(),
                   counts.data_ptr(), offsets.data_ptr(), cursor.data_ptr(),
                   records.data_ptr(), V, K, C, B, R, stream)
    if rc != 0:
        raise RuntimeError(f"orset_replay (parent): CUDA error {rc}")
    return out, dropped


def parent_lww(lib, name, state, ops):
    """One ``lww_apply`` or ``lww_capture`` call through the kernel of
    ``git show 8b328be:janus_tpu_torch/csrc/lww_apply.cu`` built as
    ``lib``, with that checkout's wrapper's host work (the operand check,
    the device context, lane_buckets' three scratch tensors)."""
    from janus_tpu_torch.kernels import operands
    from janus_tpu_torch.kernels.lww_rows import (FIELDS, OP_FIELDS,
                                                  slot_operands)

    capture = name == "lww_capture"
    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    ok = None if capture else ops.get("ok")
    dev = operands.placement(name, [
        *slot_operands("state.", state, (V, K, C)),
        *[(f"op field {f!r}", ops[f], torch.int32, (V, B)) for f in OP_FIELDS],
        ("op field 'ok'", ok, torch.int32, (V, B, 1))])
    i32 = torch.int32
    ok_out = torch.ones((V, B, 1), dtype=i32, device=dev) if capture else None
    dropped = torch.zeros((V,), dtype=i32, device=dev)
    scratch = (torch.zeros((V, K), dtype=i32, device=dev),
               torch.empty((V, K + 1), dtype=i32, device=dev),
               torch.empty((V, B), dtype=i32, device=dev))
    ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    entry = getattr(lib, f"{name}_launch")
    entry.argtypes = ([arr, arr] + ([ptr] if capture else []) + [ptr, arr]
                      + [ctypes.c_int] * 4 + [ptr])
    entry.restype = ctypes.c_int
    st = (ptr * 6)(*(state[f].data_ptr() for f in FIELDS))
    op = (ptr * 6)(*(ops[f].data_ptr() for f in OP_FIELDS),
                   None if ok is None else ok.data_ptr())
    sc = (ptr * 3)(*(t.data_ptr() for t in scratch))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        extra = [ok_out.data_ptr()] if capture else []
        rc = entry(st, op, *extra, dropped.data_ptr(), sc, V, K, C, B, stream)
    if rc != 0:
        raise RuntimeError(f"{name} (parent): CUDA error {rc}")
    return (ok_out, dropped) if capture else dropped


def run_stats(stats) -> dict:
    """A run's call statistics summed or maxed over its calls."""
    if not stats:
        return {"calls": 0}
    out = {"calls": len(stats)}
    for k, x in stats[0].items():
        if (isinstance(x, bool) or not isinstance(x, (int, float))
                or "mean" in k or k == "B"):
            continue
        if k.startswith(("longest", "bucket", "V", "K", "C", "R")):
            out[f"max_{k}"] = max(s[k] for s in stats)
        else:
            out[k] = sum(s[k] for s in stats)
    held = ("records_in_rows", "groups_with_records")
    if "live" in out:
        held = ("live", "groups_live")
    out["per_group_mean"] = out[held[0]] / max(out[held[1]], 1)
    bins = {}
    for s in stats:
        for k, n in s.get("records_per_group_bins",
                          s.get("live_per_group_bins", {})).items():
            bins[k] = bins.get(k, 0) + n
    out["group_bins"] = dict(sorted(bins.items(),
                                    key=lambda kv: int(kv[0].split("-")[0])))
    out["B_values"] = sorted({s["B"] for s in stats})
    return out


def kernel_split(fn, reps=5) -> dict:
    """Device microseconds a call of each CUDA kernel ``fn`` launches (by
    name), by torch.profiler over ``reps`` calls after a warm-up."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return chip_smoke.device_us_by_kernel(
        [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA], reps)


def calls_ab(kernel, runs, timed, wrappers, parent_call, smi):
    """The A/B of one redesigned kernel: every recorded call of ``runs``
    (label: [(wrapper name, (args, kwargs)), ...]) held bit-equal to the
    plain version under each variant (the package's build, ``tree``, and,
    given ``parent_call(name, *args)``, the parent's source as its
    wrapper called it), then in turns (tree, parent, parent, tree): each
    of ``timed`` (label: one call) by ``device_ms`` and ``host_ms``, and
    each run's whole list of calls by ``burst_ms`` (device) and
    ``pass_ms`` (host work included), on fresh clones of the calls (the
    LWW wrappers update in place)."""
    variants = {"tree": lambda name, *a: wrappers[name](*a)}
    if parent_call is not None:
        variants["parent"] = parent_call
    want = {}
    for label, calls in runs.items():
        for j, (name, (args, kw)) in enumerate(calls):
            pargs = clone(args)
            want[label, j] = (getattr(kernels, name + "_plain")(*pargs), pargs)
    for tag, fn in variants.items():
        for label, calls in runs.items():
            for j, (name, (args, kw)) in enumerate(calls):
                mine = clone(args)
                got = fn(name, *mine)
                if not (same(got, want[label, j][0])
                        and same(mine, want[label, j][1])):
                    raise AssertionError(f"{kernel} {tag}: {label} call {j} "
                                         f"differs from plain")
    del want
    torch.cuda.synchronize()
    split = {tag: {label: kernel_split(lambda n=name, a=clone(args):
                                       fn(n, *a))
                   for label, (name, (args, kw)) in timed.items()}
             for tag, fn in variants.items()}
    print(json.dumps({"kernel": kernel, "nvidia_smi": smi,
                      "device_us_by_kernel": split}), flush=True)
    out = {tag: {"timed": {label: {"device_ms": [], "ms": []}
                           for label in timed},
                 "runs": {label: {"device_ms": [], "ms": []}
                          for label in runs}} for tag in variants}
    for tag in list(variants) + list(reversed(variants)):
        fn = variants[tag]
        for label, (name, (args, kw)) in timed.items():
            mine = clone(args)
            call = (lambda n=name, a=mine: fn(n, *a))
            out[tag]["timed"][label]["device_ms"].append(device_ms(call))
            out[tag]["timed"][label]["ms"].append(host_ms(call))
        for label, calls in runs.items():
            mine = [(name, clone(args)) for name, (args, kw) in calls]
            fns = [(lambda n=name, a=a: fn(n, *a)) for name, a in mine]
            # bursts of BURST_CALLS calls: a longer one fills the launch
            # queue, and the host then waits for the sleeping device
            out[tag]["runs"][label]["device_ms"].append(sum(
                burst_ms(fns[k:k + BURST_CALLS])
                for k in range(0, len(fns), BURST_CALLS)))
            out[tag]["runs"][label]["ms"].append(pass_ms(fns))
            del mine, fns
        torch.cuda.empty_cache()
    print(json.dumps({"kernel": kernel, "nvidia_smi": smi, **out}),
          flush=True)


def replay_ab(dev, parent, smi):
    """Part ``replay``: each recorded run's ``orset_replay`` calls
    described (``chip_smoke.replay_walk_stats`` summed over the run, and
    per call for the timed ones), then ``calls_ab`` with the timed calls
    ``widest`` (chip_smoke's: the orset_consensus delta apply with the
    most lanes) and each run's call with the most op records."""
    import chip_smoke

    runs = replay_inputs(dev)
    stats = {label: [chip_smoke.replay_walk_stats(*args)
                     for args, _ in calls] for label, calls in runs.items()}
    cons = runs["orset_consensus"]
    timed = {"widest": ("orset_replay", max(
        cons, key=lambda c: c[0][1]["op"].shape[1]))}
    for label, calls in runs.items():
        j = max(range(len(calls)), key=lambda i: stats[label][i]["records"])
        timed[f"{label}_most_records"] = ("orset_replay", calls[j])
    print(json.dumps({"kernel": "orset_replay", "nvidia_smi": smi,
                      "runs": {label: run_stats(s)
                               for label, s in stats.items()},
                      "timed_calls": {
                          label: chip_smoke.replay_walk_stats(*call[1][0])
                          for label, call in timed.items()}}), flush=True)
    lib = (build_text("orset_replay", pathlib.Path(parent).read_text(),
                      "parent") if parent is not None else None)
    calls_ab("orset_replay",
             {label: [("orset_replay", c) for c in calls]
              for label, calls in runs.items()}, timed,
             {"orset_replay": kernels.orset_replay},
             None if lib is None else
             (lambda name, *a: parent_replay(lib, *a)), smi)
    del runs, timed
    torch.cuda.empty_cache()


def lww_ab(dev, parent, smi):
    """Part ``lwwwalk``: the recorded ``lww_apply`` / ``lww_capture``
    calls described (``chip_smoke.lww_walk_stats``), then ``calls_ab``
    with the timed calls ``lww_apply`` and ``lww_capture`` (chip_smoke's:
    the lww_consensus call with the most live lanes) and typed_store's
    apply with the most live lanes."""
    import chip_smoke

    runs = lww_inputs(dev)
    stats = {label: [chip_smoke.lww_walk_stats(*args) for args, _ in calls]
             for label, calls in runs.items()}
    timed = {}
    for label, calls in runs.items():
        j = max(range(len(calls)), key=lambda i: stats[label][i]["live"])
        timed[label.replace("/", "_")] = (label.split("/")[1], calls[j])
    print(json.dumps({"kernel": "lww_apply", "nvidia_smi": smi,
                      "runs": {label: run_stats(s)
                               for label, s in stats.items()},
                      "timed_calls": {
                          label: chip_smoke.lww_walk_stats(*call[1][0])
                          for label, call in timed.items()}}), flush=True)
    lib = (build_text("lww_apply", pathlib.Path(parent).read_text(),
                      "parent") if parent is not None else None)
    calls_ab("lww_apply",
             {label: [(label.split("/")[1], c) for c in calls]
              for label, calls in runs.items()}, timed,
             {"lww_apply": kernels.lww_apply,
              "lww_capture": kernels.lww_capture},
             None if lib is None else
             (lambda name, *a: parent_lww(lib, name, *a)), smi)
    del runs, timed
    torch.cuda.empty_cache()


def apply_inputs(dev):
    """Every ``orset_apply`` call (args, kwargs) of chip_smoke's
    orset_store phase (its stream of ``ORSET_STORE["ticks"]`` + 1 ticks,
    the warm-up first) and of its store_delta phase (the three arms'
    OR-Set applies, tick by tick), and one call at chip_smoke's "hot key
    B8192" shape (path A's geometry, every lane on key 0, half the rows
    full), by run."""
    import chip_smoke
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.store import Store, replicated_init
    from janus_tpu_torch.utils.ids import TagMinter

    names = ("orset_apply",)
    g = chip_smoke.ORSET_STORE

    def store():
        R, K, C, B = (g[x] for x in "RKCB")
        rng = np.random.default_rng(3)
        mint = [TagMinter(i) for i in range(R)]
        state = replicated_init(orset.SPEC, R, device=dev, num_keys=K,
                                capacity=C, rm_capacity=g["rm"])
        tick = make_tick(orset.SPEC, device=dev)
        for t in range(g["ticks"] + 1):
            state = tick(state, workloads.ops_to_device(
                workloads.orset_hot_window(rng, mint, K, B, t, g["hot"]), dev))

    def delta():
        d = chip_smoke.STORE_DELTA
        R, K, C, B, D = (d[x] for x in ("R", "K", "C", "B", "budget"))
        types = {"pnc": dict(num_keys=K, num_writers=R),
                 "orset": dict(num_keys=K, capacity=C, rm_capacity=d["rm"])}
        rng = np.random.default_rng(12)
        mint = [TagMinter(i) for i in range(R)]
        arms = [(Store(R, types, device=dev), False),
                (Store(R, types, dirty_budget=D, device=dev), True),
                (Store(R, types, dirty_budget=d["overflow_budget"],
                       device=dev), True)]
        for t in range(d["ticks"] + 1):
            batch = {tc: workloads.ops_to_device(o, dev) for tc, o in
                     workloads.store_delta_tick(rng, mint, K, B, t,
                                                D // 2).items()}
            for st, use_delta in arms:
                st.fused_tick(batch, delta=use_delta)

    runs = {label: chip_smoke.record_calls(kernels, names, fn)["orset_apply"]
            for label, fn in (("orset_store", store), ("store_delta", delta))}
    c = chip_smoke.ORSET_CONS
    n, k, b, cap = (c[x] for x in ("nodes", "keys", "ops_per_block",
                                   "capacity"))
    rng = np.random.default_rng(9)
    hot = workloads.orset_add_remove(rng, [TagMinter(i) for i in range(n)],
                                     k, b)
    hot["key"][:] = 0
    st = {f: torch.as_tensor(np.asarray(x), device=dev) for f, x in
          workloads.orset_slots(rng, (n, k), cap, full_rows=0.5).items()}
    runs["hot_key"] = [((st, workloads.ops_to_device(hot, dev)), {})]
    torch.cuda.synchronize()
    return runs


def parent_apply(lib, state, ops):
    """One ``orset_apply`` call through the kernel of ``git show
    5d2467b:janus_tpu_torch/csrc/orset_apply.cu`` built as ``lib``, with
    that checkout's wrapper's host work: the operand check, the drop
    counts zeroed, the device context, a 20-argument ctypes call."""
    from janus_tpu_torch.kernels import operands
    from janus_tpu_torch.kernels.orset_rows import (CAPTURE_FIELDS, FIELDS,
                                                    op_operands,
                                                    slot_operands)

    R, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    captured = "rm_rep" in ops
    r_cap = ops["rm_rep"].shape[-1] if captured else 0
    dev = operands.placement("orset_apply", [
        *slot_operands("state.", state, (R, K, C)), *op_operands(ops, (R, B)),
        *(op_operands(ops, (R, B, r_cap), CAPTURE_FIELDS) if captured
          else ())])
    dropped = torch.zeros((R,), dtype=torch.int32, device=dev)
    entry = lib.orset_apply_launch
    if entry.argtypes is None:
        ptr = ctypes.c_void_p
        entry.argtypes = [ptr] * 13 + [ctypes.c_int, ptr] + [
            ctypes.c_int] * 4 + [ptr]
        entry.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*(state[f].data_ptr() for f in FIELDS),
                   *(ops[f].data_ptr() for f in ("op", "key", "a0", "a1",
                                                 "a2")),
                   *((ops[f].data_ptr() for f in CAPTURE_FIELDS) if captured
                     else (None,) * 3), r_cap,
                   dropped.data_ptr(), R, K, C, B, stream)
    if rc != 0:
        raise RuntimeError(f"orset_apply (parent): CUDA error {rc}")
    return dropped


def apply_ab(dev, parent, smi):
    """Part ``orsetapply``: the recorded ``orset_apply`` calls described
    (``chip_smoke.apply_walk_stats``), then ``calls_ab`` with the timed
    calls ``path_b`` (orset_store's tick-1 apply: R64 K500 C256 B64, the
    shape chip_smoke's kernels line times) and ``hot_key``."""
    import chip_smoke

    runs = apply_inputs(dev)
    stats = {label: [chip_smoke.apply_walk_stats(*args) for args, _ in calls]
             for label, calls in runs.items()}
    timed = {"path_b": ("orset_apply", runs["orset_store"][1]),
             "hot_key": ("orset_apply", runs["hot_key"][0])}
    print(json.dumps({"kernel": "orset_apply", "nvidia_smi": smi,
                      "runs": {label: run_stats(s)
                               for label, s in stats.items()},
                      "timed_calls": {
                          label: chip_smoke.apply_walk_stats(*call[1][0])
                          for label, call in timed.items()}}), flush=True)
    lib = (build_text("orset_apply", pathlib.Path(parent).read_text(),
                      "parent") if parent is not None else None)
    calls_ab("orset_apply",
             {label: [("orset_apply", c) for c in calls]
              for label, calls in runs.items()}, timed,
             {"orset_apply": kernels.orset_apply},
             None if lib is None else
             (lambda name, *a: parent_apply(lib, *a)), smi)
    del runs, timed
    torch.cuda.empty_cache()


def select_stats(cfg, ring, ready, applied, budget, slot_round, base_round,
                 commit_seq=None) -> dict:
    """What one ``block_select`` call selects and gathers: V views of W x N
    blocks, A = min(budget, W N) rows a view, the ring's fields and the
    bytes of a row of each, whether commit order keys it, and the share
    of the V A output rows that are chosen (the blocks ``ready &
    ~applied``, at most A a view); the bytes the call must move
    (``chip_smoke.select_bytes``: each ring row it gathers read once) and
    their time at the card's memory rate."""
    import chip_smoke

    v, w, n = ready.shape
    a = min(budget, w * n)
    picked = (ready & ~applied).reshape(v, -1).sum(1).clamp(max=a)
    nbytes = chip_smoke.select_bytes(kernels.block_select_plain, (
        cfg, ring, ready, applied, budget, slot_round, base_round,
        commit_seq))
    return dict(V=v, W=w, N=n, A=a, commit_order=commit_seq is not None,
                fields={f: x[0, 0].numel() * x.element_size()
                        for f, x in ring.items()},
                row_bytes=sum(x[0, 0].numel() * x.element_size()
                              for x in ring.values()),
                chosen_share=float(picked.sum()) / max(v * a, 1),
                bytes=nbytes,
                bound_ms=1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S)


def select_inputs(dev):
    """The first ``SELECT_CALLS`` ``block_select`` calls (args, kwargs) of
    each of chip_smoke's recorded runs, by run: the consensus phase's
    geometry (``RECORDED[0]``, node 3 crashed for some rounds),
    orset_consensus, rga_consensus's first ``RGA_ROUNDS`` rounds, harness
    presets pnc, orset and mixed (``run_tensor`` uncut) and a split
    PN-Counter cluster (four processes' calls)."""
    import chip_smoke
    from janus_tpu_torch.bench import harness

    names = ("block_select",)

    def first(fn):
        kept = []

        def take(name, args, kwargs):
            if len(kept) < SELECT_CALLS:
                kept.append(chip_smoke.clone_aliased((args, kwargs)))
        chip_smoke.record_calls(kernels, names, fn, take=take)
        return kept

    runs = {
        "consensus": first(lambda: chip_smoke.run_recorded(
            dev, workloads, chip_smoke.RECORDED[0])),
        "orset_consensus": first(lambda: chip_smoke.record_orset_consensus(
            dev, kernels, workloads, ())),
        "rga_consensus": first(lambda: chip_smoke.record_rga_churn(
            dev, kernels, workloads, RGA_ROUNDS, ())),
    }
    for preset in ("pnc", "orset", "mixed"):
        runs[f"harness_{preset}"] = first(
            lambda p=preset: harness.run_tensor(harness.PRESETS[p],
                                                device=dev))
    runs["split_pnc"] = first(lambda: chip_smoke.split_run(
        dev, kernels, workloads, "pnc", chip_smoke.SPLIT_PNC, 22))
    torch.cuda.synchronize()
    return runs


def parent_select(lib, cfg, ops_buffer, ready, applied, budget, slot_round,
                  base_round, commit_seq=None):
    """One ``block_select`` call through the kernels of ``git show
    5d2467b:janus_tpu_torch/csrc/block_select.cu`` built as ``lib``, with
    that checkout's wrapper's host work: the operand check, one
    allocation per batch field and for ``idx`` and ``chosen``, three
    ctypes arrays, the device context, a 17-argument ctypes call."""
    from janus_tpu_torch.kernels import operands

    w, n = cfg.num_rounds, cfg.num_nodes
    v = ready.shape[0]
    a = min(budget, w * n)
    names = list(ops_buffer)
    bl, i32 = torch.bool, torch.int32
    dev = operands.placement("block_select", [
        ("ready", ready, bl, (v, w, n)), ("applied", applied, bl, (v, w, n)),
        ("commit_seq", commit_seq, i32, (v, w, n)),
        ("slot_round", slot_round, i32, (w,)),
        ("base_round", base_round, i32, ()),
        *((f"ops_buffer.{f}", ops_buffer[f], i32,
           (w, n) + tuple(ops_buffer[f].shape[2:])) for f in names)])
    batch = {f: torch.empty((v, a * x.shape[2]) + tuple(x.shape[3:]),
                            dtype=i32, device=dev)
             for f, x in ops_buffer.items()}
    idx = torch.empty((v, a), dtype=i32, device=dev)
    chosen = torch.empty((v, a), dtype=bl, device=dev)
    row = (ctypes.c_longlong * len(names))(
        *(ops_buffer[f][0, 0].numel() for f in names))
    src = (ctypes.c_void_p * len(names))(
        *(ops_buffer[f].data_ptr() for f in names))
    dst = (ctypes.c_void_p * len(names))(*(batch[f].data_ptr() for f in names))
    entry = lib.block_select_launch
    if entry.argtypes is None:
        entry.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        entry.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(ready.data_ptr(), applied.data_ptr(),
                   None if commit_seq is None else commit_seq.data_ptr(),
                   slot_round.data_ptr(), base_round.data_ptr(),
                   idx.data_ptr(), chosen.data_ptr(), src, dst, row,
                   len(names), names.index("op"), v, n, w, a, stream)
    if rc != 0:
        raise RuntimeError(f"block_select (parent): CUDA error {rc}")
    return batch, idx, chosen


def layout_us(args, reps=2000) -> dict:
    """Host microseconds of the wrapper's ring table for the call
    ``args``: built (``block_select.Layout``, what a call without the
    cache would do) and looked up in the cache (``block_select.layout``),
    each the least of five loops of ``reps``."""
    import importlib

    bs = importlib.import_module("janus_tpu_torch.kernels.block_select")
    cfg, ring, ready, _, budget = args[:5]
    v, a = ready.shape[0], min(budget, cfg.num_rounds * cfg.num_nodes)

    def least(fn):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) / reps)
        return 1e6 * best

    return {"fields": len(ring), "built": least(lambda: bs.Layout(ring, v, a)),
            "cached": least(lambda: bs.layout(ring, v, a))}


def select_ab(dev, parent, smi):
    """Part ``select``: the recorded ``block_select`` calls described
    (``select_stats``), then ``calls_ab`` with the timed calls
    ``consensus_last`` (the consensus geometry's last stable delta apply,
    the call chip_smoke's kernels line times) and each run's call that
    gathers the most bytes."""
    import chip_smoke

    runs = select_inputs(dev)
    stats = {label: [select_stats(*args) for args, _ in calls]
             for label, calls in runs.items()}
    timed = {"consensus_last": ("block_select", runs["consensus"][-1])}
    for label, calls in runs.items():
        j = max(range(len(calls)), key=lambda i: stats[label][i]["V"]
                * stats[label][i]["A"] * stats[label][i]["row_bytes"])
        timed[f"{label}_widest"] = ("block_select", calls[j])

    def summary(s):
        return {"calls": len(s), **{k: sorted({str(x[k]) for x in s})
                                    for k in ("V", "W", "N", "A",
                                              "commit_order", "fields")},
                "max_row_bytes": max(x["row_bytes"] for x in s),
                "chosen_share_mean": sum(x["chosen_share"] for x in s)
                / len(s)}

    print(json.dumps({"kernel": "block_select", "nvidia_smi": smi,
                      "runs": {label: summary(s) for label, s in stats.items()},
                      "timed_calls": {
                          label: select_stats(*call[1][0])
                          for label, call in timed.items()}}), flush=True)
    print(json.dumps({"kernel": "block_select", "nvidia_smi": smi,
                      "layout_us": layout_us(runs["consensus"][-1][0])}),
          flush=True)
    lib = (build_text("block_select", pathlib.Path(parent).read_text(),
                      "parent") if parent is not None else None)
    calls_ab("block_select",
             {label: [("block_select", c) for c in calls]
              for label, calls in runs.items()}, timed,
             {"block_select": kernels.block_select},
             None if lib is None else
             (lambda name, *a: parent_select(lib, *a)), smi)
    del runs, timed
    torch.cuda.empty_cache()


def safekv_inputs(dev):
    """Every call of the SafeKV round's two redesigned pairs in
    ``chip_smoke.safekv_recorded_runs`` (the runs ``safekv_kernel_checks``
    records: the PN-Counter at 4 and 16 nodes, the OR-Set at 4, both
    types at 64) and in the first ``TP_ROUNDS`` rounds of chip_smoke's
    tpset_consensus and graph_consensus phases (16 nodes, 5,120-op
    blocks, ring rows with the captures' extras), by run: ``{"submit":
    [(accept args, board args)], "gc": [(gc_frontier args without the
    ring, ring)]}``."""
    import chip_smoke

    names = ("safekv_submit", "safekv_board", "gc_frontier")

    def tp_run(kind, g):
        def run():
            kv = chip_smoke.tp_kv(dev, kind, g)
            for ops in chip_smoke.tp_stream(workloads, kind, g, TP_ROUNDS):
                kv.step(workloads.ops_to_device(ops, dev))
        return run

    runs = {}
    for tag, fn in chip_smoke.safekv_recorded_runs(
            dev, workloads, np.random.default_rng(21)) + [
            ("tpset N16", tp_run("tpset", chip_smoke.TPSET_CONS)),
            ("graph N16", tp_run("graph", chip_smoke.GRAPH_CONS))]:
        calls = chip_smoke.record_calls(kernels, names, fn, aliased=True)
        submit = [(a, b) for (a, _), (b, _) in zip(calls["safekv_submit"],
                                                  calls["safekv_board"])]
        gc = [(args[:13], args[13]) for args, _ in calls["gc_frontier"]]
        runs[tag.replace(" ", "_")] = {"submit": submit, "gc": gc}
    torch.cuda.synchronize()
    return runs


def parent_module(root, name, lib, tag):
    """The wrapper module ``janus_tpu_torch/kernels/<name>.py`` of the
    checkout at ``root``, loaded beside the package's under a name of its
    own, its wrappers launching ``lib`` (that checkout's source, built by
    ``build_text``): through its ``build.load`` calls, or through its
    lean launches, bound here to ``lib``."""
    import importlib.util
    import types

    path = pathlib.Path(root) / "janus_tpu_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}_{tag}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.build = types.SimpleNamespace(load=lambda _: lib,
                                         check_launch=build.check_launch)
    held = build._LIBS.get(name)
    build._LIBS[name] = lib
    try:
        for x in vars(module).values():
            if isinstance(x, build.LeanLaunch):
                x._bind()
    finally:
        build._LIBS.pop(name)
        if held is not None:
            build._LIBS[name] = held
    return module


def parent_gc(module):
    """One round's GC through the parent's ``gc_frontier`` module: its
    ``gc_frontier``, then its ``gc_clear_ring`` where that checkout
    clears the ring in a call of its own."""
    if not hasattr(module, "gc_clear_ring"):
        return lambda g_args, ring: module.gc_frontier(*g_args, ring)

    def gc(g_args, ring):
        out = module.gc_frontier(*g_args)
        module.gc_clear_ring(g_args[0], ring, out[1])
        return out
    return gc


def parent_submit(module):
    """One round's accept and board through the parent's
    ``safekv_submit`` module."""
    def submit(a_args, b_args):
        out = module.safekv_submit(*a_args)
        module.safekv_board(*b_args)
        return out
    return submit


def gc_plain(g_args, ring):
    """The plain versions of one round's GC: the frontier, then the ring
    clear at its dead slots."""
    return kernels.gc_round_plain(*g_args, ring)


def submit_plain(a_args, b_args):
    """The plain versions of one round's accept and board."""
    out = kernels.safekv_submit_plain(*a_args)
    kernels.safekv_board_plain(*b_args)
    return out


def tree_gc(g_args, ring):
    """One round's GC under this checkout's wrapper (the ring cleared in
    the same call)."""
    return kernels.gc_frontier(*g_args, ops_buffer=ring)


def tree_submit(a_args, b_args):
    """One round's accept and board under this checkout's wrappers."""
    out = kernels.safekv_submit(*a_args)
    kernels.safekv_board(*b_args)
    return out


def stamped(text, fn="__global__ void gc_kernel",
            start="const int tid = threadIdx.x;",
            who="threadIdx.x == 0") -> str:
    """A kernel source's ``text`` with a ``clock64()`` and a
    ``%globaltimer`` stamp taken by the thread ``who`` names at the
    function ``fn``'s line ``start``, after each ``__syncthreads()`` of
    that function and at its end, into a device array (declared at the
    top of the source's anonymous namespace) that ``stamps_out`` copies
    out: the parent's one-block ``gc_kernel`` and ``gc_block`` of this
    checkout's ``gc_frontier.cu``, and ``dag_round.cu``'s block (the
    parent's one block, block 0 of this checkout's)."""
    head, rest = text.split(fn, 1)
    end = rest.index("\n}\n") + 1
    body, tail = rest[:end], rest[end + 1:]
    stamp = (f"if ({who}) {{ long long t_; asm volatile("
             "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
             "g_stamp[2 * n_stamp] = clock64(); g_stamp[2 * n_stamp + 1] = "
             "t_; } ++n_stamp;")
    body = body.replace("__syncthreads();", "__syncthreads(); " + stamp)
    body = body.replace(start, start + " int n_stamp = 0; " + stamp, 1)
    body = body[:-1] + stamp + "\n}"
    head = head.replace("namespace {\n",
                        "namespace {\n__device__ long long g_stamp[64];\n", 1)
    return (head + fn + body + tail
            + '\nextern "C" int stamps_out(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_stamp, "
            "sizeof(g_stamp));\n}\n")


def stamp_phases(lib, call, args, reps=5) -> dict:
    """The kernel of ``lib`` (a ``stamped`` build) split into its phases,
    ``call(*args)`` running it (the least of ``reps`` calls on fresh
    clones of ``args``): cycles and ns from the kernel's start to each
    barrier and to its end."""
    buf = (ctypes.c_longlong * 64)()
    lib.stamps_out.argtypes = [ctypes.c_void_p]
    best = None
    for _ in range(reps):
        call(*clone(args))
        torch.cuda.synchronize()
        if lib.stamps_out(buf):
            raise RuntimeError("stamps_out failed")
        cyc = [buf[2 * i] - buf[0] for i in range(32)]
        ns = [buf[2 * i + 1] - buf[1] for i in range(32)]
        k = next((i for i in range(1, 32) if cyc[i] <= 0), 32)
        got = {"cycles": cyc[:k], "ns": ns[:k]}
        if best is None or got["cycles"][-1] < best["cycles"][-1]:
            best = got
    return best


def placement_us(fn, name, reps=200) -> float:
    """Host microseconds of the operand check of the wrapper call ``fn``:
    ``operands.lean_placement`` (or ``placement``) on the operand list
    the call passes it, captured once, the least of five loops."""
    from janus_tpu_torch.kernels import operands

    got = []
    real = {f: getattr(operands, f) for f in ("placement", "lean_placement")}

    def spy(f):
        def check(label, ops):
            if label == name and not got:
                got.append((f, list(ops)))
            return real[f](label, ops)
        return check

    for f in real:
        setattr(operands, f, spy(f))
    try:
        fn()
    finally:
        for f, x in real.items():
            setattr(operands, f, x)
    f, ops = got[0]
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            real[f](name, ops)
        best = min(best, (time.perf_counter() - t0) / reps)
    return 1e6 * best


def queue_us(fn, reps=REPS) -> float:
    """Host microseconds a call spends queueing its work: ``reps`` calls
    timed on the host clock while the device sleeps behind them (the
    wrapper's host work, none of the device's)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / reps


def safekv_ab(dev, parent, smi):
    """Part ``safekv``: the recorded calls of the SafeKV round's two pairs
    (``safekv_inputs``), each held bit-equal to the plain versions under
    the package's build (``tree``, when its ``gc_frontier`` clears the
    ring itself) and the parent's source with its wrappers (``parent``);
    then per run the timed calls (the last submit, and the first GC that
    frees a slot, as chip_smoke's kernels line picks them), each split by
    the profiler into its kernels and, for the parent, its GC kernel into
    phases by clock stamps, and timed in turns (tree, parent, parent,
    tree): device ms (``device_ms``, on the state the call leaves), ms a
    call (``host_ms``) and the host's queueing work a call
    (``queue_us``); and each run's whole list of calls in bursts.
    ``parent``: the parent checkout's root, or None."""
    build.build_all()
    runs = safekv_inputs(dev)
    variants = {"tree": {"gc": tree_gc, "submit": tree_submit}}
    libs = {}
    text = (build.CSRC / "gc_frontier.cu").read_text()
    stamped_libs = {"tree": (build_text("gc_frontier", stamped(
        text, "__device__ void gc_block(",
        "const int warps = blockDim.x >> 5;"), "stamped_tree"), tree_gc)}
    # the design's variants under the same wrappers, each library put in
    # the loader's place for its turn (``use``)
    for tag, name, constants in SAFEKV_VARIANTS:
        libs[tag] = (name, build_variant(name, constants, tag))
        variants[tag] = {"gc": tree_gc, "submit": tree_submit}
    if parent is not None:
        csrc = pathlib.Path(parent) / "janus_tpu_torch" / "csrc"
        text = (csrc / "gc_frontier.cu").read_text()
        plib = build_text("gc_frontier", stamped(text), "stamped")
        stamped_libs["parent"] = (plib, parent_gc(parent_module(
            parent, "gc_frontier", plib, "stamped")))
        slib = build_text("safekv_submit",
                          (csrc / "safekv_submit.cu").read_text(), "parent")
        variants["parent"] = {
            "gc": parent_gc(parent_module(
                parent, "gc_frontier",
                build_text("gc_frontier", text, "parent"), "parent")),
            "submit": parent_submit(parent_module(
                parent, "safekv_submit", slib, "parent"))}

    def turn(tag):
        """Put the variant's library in the loader's place (or the
        package's build back)."""
        for name in ("gc_frontier", "safekv_submit"):
            use(name, libs[tag][1] if tag in libs and libs[tag][0] == name
                else None)
    plains = {"gc": gc_plain, "submit": submit_plain}
    checked = {}
    for tag, fns in variants.items():
        turn(tag)
        for label, pairs in runs.items():
            for kind, calls in pairs.items():
                for j, call in enumerate(calls):
                    mine, ref = clone(call), clone(call)
                    got, want = fns[kind](*mine), plains[kind](*ref)
                    if not (same(got, want) and same(mine, ref)):
                        raise AssertionError(f"safekv {tag}: {label} {kind} "
                                             f"call {j} differs from plain")
                checked[f"{label}/{kind}"] = len(calls)
    timed = {}
    for label, pairs in runs.items():
        timed[f"{label}/submit"] = ("submit", pairs["submit"][-1])
        gc = pairs["gc"]
        j = next((i for i, (_, r) in enumerate(gc)
                  if bool(gc_plain(*clone(gc[i]))[1].any())), len(gc) - 1)
        timed[f"{label}/gc"] = ("gc", gc[j])
    shapes = {}
    for key, (kind, call) in timed.items():
        cfg = call[0][0]
        if kind == "gc":
            dead = gc_plain(*clone(call))[1]
            shapes[key] = dict(N=cfg.num_nodes, W=cfg.num_rounds,
                               dead=int(dead.sum()), logs=bool(call[0][12]),
                               ring_fields=len(call[1]))
        else:
            b_args = call[1]
            shapes[key] = dict(N=cfg.num_nodes, W=cfg.num_rounds,
                               B=int(call[0][3]["op"].shape[1]),
                               accepted=int(b_args[5].sum()),
                               ring_fields=len(b_args[1]))
    split = {}
    for tag, fns in variants.items():
        turn(tag)
        split[tag] = {key: kernel_split(lambda k=kind, c=clone(call), f=fns:
                                        f[k](*c))
                      for key, (kind, call) in timed.items()}
    phases = {}
    for tag, (lib, call) in stamped_libs.items():
        if tag == "tree":
            use("gc_frontier", lib)
        phases[tag] = {key: stamp_phases(lib, call, c)
                       for key, (kind, c) in timed.items() if kind == "gc"}
    turn("tree")
    checks = {}  # the operand checks' share of the host work
    for key, (kind, call) in timed.items():
        c = clone(call)
        checks[key] = (
            {"accept": placement_us(lambda: tree_submit(*c),
                                    "safekv_submit"),
             "board": placement_us(lambda: tree_submit(*c),
                                   "safekv_board")}
            if kind == "submit" else
            {"gc": placement_us(lambda: tree_gc(*c), "gc_frontier")})
    print(json.dumps({"kernel": "safekv", "nvidia_smi": smi,
                      "calls_checked": checked, "timed_calls": shapes,
                      "device_us_by_kernel": split, "gc_phases": phases,
                      "placement_us": checks}), flush=True)
    out = {tag: {"timed": {key: {"device_ms": [], "ms": [], "queue_us": []}
                           for key in timed},
                 "runs": {label: {"device_ms": [], "ms": []}
                          for label in runs}} for tag in variants}
    for tag in list(variants) + list(reversed(variants)):
        fns = variants[tag]
        turn(tag)
        for key, (kind, call) in timed.items():
            mine = clone(call)
            fn = (lambda k=kind, c=mine: fns[k](*c))
            rec = out[tag]["timed"][key]
            rec["device_ms"].append(device_ms(fn))
            rec["ms"].append(host_ms(fn))
            rec["queue_us"].append(queue_us(fn))
        for label, pairs in runs.items():
            mine = [(kind, clone(c)) for kind in ("submit", "gc")
                    for c in pairs[kind]]
            calls = [(lambda k=kind, c=c: fns[k](*c)) for kind, c in mine]
            out[tag]["runs"][label]["device_ms"].append(sum(
                burst_ms(calls[k:k + BURST_CALLS])
                for k in range(0, len(calls), BURST_CALLS)))
            out[tag]["runs"][label]["ms"].append(pass_ms(calls))
            del mine, calls
        torch.cuda.empty_cache()
    turn("tree")
    print(json.dumps({"kernel": "safekv", "nvidia_smi": smi, **out}),
          flush=True)
    del runs, timed
    torch.cuda.empty_cache()


# part round: the recorded SafeKV runs whose dag_round calls it times
# (chip_smoke.safekv_recorded_runs' tags), fresh copies of a GC advance
# timed in one burst, and the markers of dag_round.cu's one-block kernel
# for its clock stamps (this checkout's and the parent's)
ROUND_RUNS = ("pnc N4", "pnc N16", "mixed N64")
FENCE_REPS = 20
DAG_STAMP_MARKERS = (
    ("__global__ void dag_round_kernel",
     "const int tid = threadIdx.x, nt = blockDim.x;", "threadIdx.x == 0"),
    ("    dag_round_kernel(DagIn in, DagOut out, int n, int w, int quorum) {",
     "const int s = blockIdx.x, tid = threadIdx.x;",
     "threadIdx.x == 0 && blockIdx.x == 0"))
# an empty kernel, and an empty pair the second of which is launched by
# programmatic dependent launch: the launch floors of the card
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void first_kernel() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__global__ void second_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int pair_launch(void* stream) {
  first_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, second_kernel);
}
"""


def round_inputs(dev):
    """Every ``dag_round`` call of chip_smoke's recorded SafeKV runs
    ``ROUND_RUNS`` (the PN-Counter at 4 and 16 nodes, both types at
    harness preset mixed's 64) and of the split PN-Counter cluster's
    pass (the split mode), by run: ``{run: [(args, kwargs)]}``."""
    import chip_smoke

    runs = {}
    for tag, fn in chip_smoke.safekv_recorded_runs(
            dev, workloads, np.random.default_rng(21)):
        if tag in ROUND_RUNS:
            runs[tag.replace(" ", "_")] = chip_smoke.record_calls(
                kernels, ("dag_round",), fn)["dag_round"]
    runs["split_N4"] = chip_smoke.record_calls(
        kernels, ("dag_round",), lambda: chip_smoke.split_run(
            dev, kernels, workloads, "pnc", chip_smoke.SPLIT_PNC, 21))[
        "dag_round"]
    torch.cuda.synchronize()
    return runs


def fence_names() -> tuple:
    """The wrappers one GC advance of the OR-Set calls in this checkout."""
    return (("orset_compact_fences",)
            if hasattr(kernels, "orset_compact_fences")
            else ("orset_watermark", "orset_compact"))


def advances_of(calls) -> list:
    """Recorded GC advances as ``(states, live_op, live_a2)``: the fused
    call's arguments, or a watermark's and its two compactions' rows."""
    if "orset_compact_fences" in calls:
        return [(tuple(a[0]), a[1], a[2])
                for a, _ in calls["orset_compact_fences"]]
    wms, cps = calls["orset_watermark"], calls["orset_compact"]
    return [((cps[2 * i][0][0], cps[2 * i + 1][0][0]), *wms[i][0])
            for i in range(len(wms))]


def fence_inputs(dev):
    """Every GC advance of chip_smoke's orset_consensus runs
    (``record_orset_consensus``: 4 views x 100 keys x C 64) and of one
    run of harness preset orset (16 views x 1,000 keys x C 64, a ring of
    8 x 16 x 5,120 lanes), by geometry."""
    import chip_smoke
    from janus_tpu_torch.bench import harness

    names = fence_names()
    calls, _ = chip_smoke.record_orset_consensus(dev, kernels, workloads,
                                                 names)
    out = {"orset_cons": advances_of(calls)}
    calls = chip_smoke.record_calls(
        kernels, names, lambda: harness.run_tensor(harness.PRESETS["orset"],
                                                   device=dev), aliased=True)
    out["preset_orset"] = advances_of(calls)
    torch.cuda.synchronize()
    return out


def fence_plain(states, op, a2):
    """The plain versions of one GC advance: the watermark, then each
    state compacted in place behind it."""
    wm = kernels.orset_watermark_plain(op, a2)
    for st in states:
        kernels.orset_compact_plain(st, wm, out=st)
    return states


def fence_call(module):
    """One GC advance through ``module``'s wrappers: its fused call where
    it has one, else its watermark and one compaction a state."""
    if hasattr(module, "orset_compact_fences"):
        return module.orset_compact_fences

    def advance(states, op, a2):
        wm = module.orset_watermark(op, a2)
        for st in states:
            module.orset_compact(st, wm=wm, out=st)
        return states
    return advance


def fence_stats(adv) -> dict:
    """One advance's rows, the rows that drop a slot and the rows the
    compaction changes (plain versions), the ring's lanes, whether the
    watermark is SENTINEL, and the bytes it must move: the ring's op and
    a2 read, every slot read (14 bytes) and the changed rows written."""
    states, op, a2 = adv
    wm = kernels.orset_watermark_plain(op, a2)
    rows = drops = changed = 0
    row_bytes = 0
    for st in states:
        keep = st["valid"] & (~st["removed"] | (st["tag_ctr"] >= wm[0]))
        drop = (st["valid"] & ~keep).any(-1)
        out = kernels.orset_compact_plain(st, wm)
        diff = torch.zeros_like(drop)
        for f, x in st.items():
            diff |= (out[f] != x).any(-1)
        rows += drop.numel()
        drops += int(drop.sum())
        changed += int(diff.sum())
        row_bytes = 14 * st["valid"].shape[-1]
    nbytes = 8 * op.numel() + row_bytes * (rows + changed)
    return {"rows": rows, "rows_dropping": drops, "rows_changed": changed,
            "ring_lanes": op.numel(),
            "wm_sentinel": int(wm[0]) == torch.iinfo(torch.int32).max,
            "shape": list(states[0]["valid"].shape), "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / 3.35e12}


def fresh_ms(call, adv, reps=FENCE_REPS) -> dict:
    """One GC advance on fresh clones of ``adv`` (each call its own, made
    beforehand): device ms a call (the calls queued behind a sleeping
    kernel, after a warm-up call) and ms a call with host work (CUDA
    events around the calls)."""
    out = {}
    for kind in ("device_ms", "ms"):
        copies = [clone(adv) for _ in range(reps + 1)]
        call(*copies[0])
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        if kind == "device_ms":
            torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for c in copies[1:]:
            call(*c)
        host = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        if kind == "device_ms" and host >= ev[0].elapsed_time(ev[1]):
            raise RuntimeError(f"queueing took {host} ms, longer than the "
                               f"sleep")
        out[kind] = ev[1].elapsed_time(ev[2]) / reps
        del copies
    return out


def cycling(call, adv, copies=8):
    """A call of no arguments that runs ``call`` on the next of
    ``copies`` fresh clones of ``adv`` (for the profiler's few calls)."""
    pool = [clone(adv) for _ in range(copies)]
    at = [0]

    def go():
        c = pool[at[0] % copies]
        at[0] += 1
        return call(*c)
    return go


def round_ab(dev, parent, smi):
    """Part ``round``: ``dag_round`` on every recorded call of
    ``round_inputs`` and one GC advance of the OR-Set on every recorded
    advance of ``fence_inputs``, each held bit-equal to the plain
    versions under this checkout's wrappers (``tree``) and, with
    ``parent``, the parent checkout's two sources under its own wrapper
    modules (``parent``). Then: each fence geometry's advances (rows,
    rows dropping a slot, rows changed, bytes and bound); the timed calls
    (each run's last dag_round call, each geometry's last advance) split
    by the profiler into their kernels, dag_round's one block into its
    phases by clock stamps (``stamped``), and timed in turns (tree,
    parent, parent, tree): dag_round's device ms, ms a call and queueing
    µs a call and each run's whole list of calls in bursts; the
    advance's device ms and ms a call on fresh copies and its device ms
    repeated in place (rows that no longer change); beside them the
    card's launch floors (an empty kernel, and an empty pair by
    programmatic dependent launch), timed as the kernels line's device
    ms is."""
    build.build_all()
    runs = round_inputs(dev)
    fences = fence_inputs(dev)
    variants = {"tree": {"round": kernels.dag_round,
                         "fence": fence_call(kernels)}}
    def marked(text):
        return next(m for m in DAG_STAMP_MARKERS
                    if m[0] in text and m[1] in text)

    stamps = {}
    text = (build.CSRC / "dag_round.cu").read_text()
    stamps["tree"] = (build_text("dag_round", stamped(text, *marked(text)),
                                 "stamped_tree"), None)
    if parent is not None:
        csrc = pathlib.Path(parent) / "janus_tpu_torch" / "csrc"
        ptext = (csrc / "dag_round.cu").read_text()
        plib = build_text("dag_round", stamped(ptext, *marked(ptext)),
                          "stamped")
        stamps["parent"] = (plib, parent_module(parent, "dag_round", plib,
                                                "stamped").dag_round)
        variants["parent"] = {
            "round": parent_module(parent, "dag_round", build_text(
                "dag_round", ptext, "parent"), "parent").dag_round,
            "fence": fence_call(parent_module(
                parent, "orset_compact", build_text(
                    "orset_compact", (csrc / "orset_compact.cu").read_text(),
                    "parent"), "parent"))}
    checked = {}
    for tag, fns in variants.items():
        for label, calls in runs.items():
            for j, (args, kw) in enumerate(calls):
                got = fns["round"](*args, **kw)
                want = kernels.dag_round_plain(*args, **kw)
                if not same(got, want):
                    raise AssertionError(f"round {tag}: {label} call {j} "
                                         f"differs from plain")
            checked[f"dag_round/{label}"] = len(calls)
        for label, advs in fences.items():
            for j, adv in enumerate(advs):
                mine, ref = clone(adv), clone(adv)
                fns["fence"](*mine)
                fence_plain(*ref)
                if not same(mine, ref):
                    raise AssertionError(f"round {tag}: {label} advance {j} "
                                         f"differs from plain")
            checked[f"fence/{label}"] = len(advs)
    stats = {label: [fence_stats(a) for a in advs]
             for label, advs in fences.items()}
    timed = {f"dag_round/{label}": ("round", calls[-1])
             for label, calls in runs.items()}
    timed.update({f"fence/{label}": ("fence", advs[-1])
                  for label, advs in fences.items()})
    shapes = {}
    for key, (kind, call) in timed.items():
        if kind == "round":
            cfg = call[0][0]
            shapes[key] = dict(N=cfg.num_nodes, W=cfg.num_rounds,
                               split=call[1].get("owned") is not None,
                               masks=[x is not None for x in call[0][2:]])
        else:
            shapes[key] = fence_stats(call)
    split = {}
    for tag, fns in variants.items():
        split[tag] = {}
        for key, (kind, call) in timed.items():
            if kind == "round":
                split[tag][key] = kernel_split(
                    lambda f=fns["round"], c=call: f(*c[0], **c[1]))
            else:
                split[tag][key] = kernel_split(cycling(fns["fence"], call))
    phases = {}
    for tag, (lib, fn) in stamps.items():
        if fn is None:
            use("dag_round", lib)
            fn = kernels.dag_round
        phases[tag] = {key: stamp_phases(
            lib, lambda a, kw, f=fn: f(*a, **kw), call)
            for key, (kind, call) in timed.items() if kind == "round"}
    use("dag_round", None)
    floor_lib = build_text("empty", EMPTY_SOURCE, "floor")
    for entry in ("empty_launch", "pair_launch"):
        getattr(floor_lib, entry).argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    floors = {}
    for entry in ("empty_launch", "pair_launch"):
        fn = (lambda e=getattr(floor_lib, entry): e(stream))
        floors[entry] = {"device_ms": device_ms(fn), "ms": host_ms(fn),
                         "queue_us": queue_us(fn)}
    print(json.dumps({"kernel": "round", "nvidia_smi": smi,
                      "calls_checked": checked, "fence_advances": stats,
                      "timed_calls": shapes, "device_us_by_kernel": split,
                      "dag_round_phases": phases, "launch_floors": floors}),
          flush=True)
    out = {tag: {"timed": {key: {} for key in timed},
                 "runs": {label: {"device_ms": [], "ms": []}
                          for label in runs}} for tag in variants}
    for tag in list(variants) + list(reversed(variants)):
        fns = variants[tag]
        for key, (kind, call) in timed.items():
            rec = out[tag]["timed"][key]
            if kind == "round":
                fn = (lambda f=fns["round"], c=call: f(*c[0], **c[1]))
                got = {"device_ms": device_ms(fn), "ms": host_ms(fn),
                       "queue_us": queue_us(fn)}
            else:
                got = fresh_ms(fns["fence"], call)
                mine = clone(call)
                got["in_place_device_ms"] = device_ms(
                    lambda f=fns["fence"], c=mine: f(*c))
                del mine
            for k, v in got.items():
                rec.setdefault(k, []).append(v)
        for label, calls in runs.items():
            fs = [(lambda f=fns["round"], c=c: f(*c[0], **c[1]))
                  for c in calls]
            out[tag]["runs"][label]["device_ms"].append(sum(
                burst_ms(fs[k:k + BURST_CALLS])
                for k in range(0, len(fs), BURST_CALLS)))
            out[tag]["runs"][label]["ms"].append(pass_ms(fs))
        torch.cuda.empty_cache()
    print(json.dumps({"kernel": "round", "nvidia_smi": smi, **out}),
          flush=True)
    del runs, fences, timed
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi()
    parent, walk_parent, rga_parent, ring_parent = None, None, None, None
    replay_parent, lww_parent, apply_parent, select_parent = (None,) * 4
    root = None
    if "--parent" in sys.argv:
        root = pathlib.Path(sys.argv[sys.argv.index("--parent") + 1])
        parent = root / "janus_tpu_torch" / "csrc" / "slot_union.cu"
        walk_parent = root / "janus_tpu_torch" / "csrc" / "graph_apply.cu"
        rga_parent = root / "janus_tpu_torch" / "csrc" / "rga_apply.cu"
        ring_parent = root / "janus_tpu_torch" / "csrc" / "ring_resize.cu"
        replay_parent = root / "janus_tpu_torch" / "csrc" / "orset_replay.cu"
        lww_parent = root / "janus_tpu_torch" / "csrc" / "lww_apply.cu"
        apply_parent = root / "janus_tpu_torch" / "csrc" / "orset_apply.cu"
        select_parent = root / "janus_tpu_torch" / "csrc" / "block_select.cu"
    parts = (sys.argv[sys.argv.index("--parts") + 1].split(",")
             if "--parts" in sys.argv else PARTS)

    if "compact" in parts:
        rows = compaction_input(dev)
        part = {f: x[:8].clone() for f, x in rows.items()}
        mine = clone(rows)
        print(json.dumps({"kernel": "rga_compact", "nvidia_smi": smi, **run_ab(
            "rga_compact", COMPACT_VARIANTS,
            {"call": lambda: kernels.rga_compact(mine, None, out=mine)},
            lambda: same(kernels.rga_compact(part),
                         kernels.rga_compact_plain(part)))}), flush=True)
        del rows, mine, part
        torch.cuda.empty_cache()

    if "mvr" in parts:
        views, ops = walk_input(dev)
        small = ({f: x[:4].clone() for f, x in views.items()},
                 {f: x[:4].clone() for f, x in ops.items()})

        def check_walk():
            a, b = clone(small[0]), clone(small[0])
            return same((kernels.mvr_apply(a, small[1]), a),
                        (kernels.mvr_apply_plain(b, small[1]), b))

        mine = clone(views)
        print(json.dumps({"kernel": "mvr_apply", "nvidia_smi": smi, **run_ab(
            "mvr_apply", WALK_VARIANTS,
            {"call": lambda: kernels.mvr_apply(mine, ops)}, check_walk)}),
            flush=True)
        del views, ops, mine, small
        torch.cuda.empty_cache()

    if "orset" in parts:
        (ua, ukw), (ra, rkw) = union_inputs(dev)
        part = tuple({f: x[:2, :40].clone() for f, x in t.items()}
                     for t in ua[:2])

        def check_union():
            return same(kernels.slot_union(*part, ua[2]),
                        kernels.slot_union_plain(*part, ua[2]))

        print(json.dumps({"kernel": "slot_union", "nvidia_smi": smi, **run_ab(
            "slot_union", UNION_VARIANTS,
            {"level1": lambda: kernels.slot_union(*ua, **ukw),
             "rows_level1": lambda: kernels.slot_union_rows(*ra, **rkw)},
            check_union, parent)}), flush=True)
        del ua, ra, part
        torch.cuda.empty_cache()

    for part_name, inputs, name, variants, label in (
            ("tp", tp_union_inputs, "slot_union", TP_VARIANTS,
             "tp_union/edge_union"),
            ("lww", lww_union_inputs, "slot_union", LWW_VARIANTS,
             "lww_union"),
            ("walk", walk_inputs, "graph_apply", GRAPH_WALK_VARIANTS,
             "graph_walk")):
        if part_name not in parts:
            continue
        calls = inputs(dev)
        walk = part_name == "walk"
        print(json.dumps({"kernel": label, "nvidia_smi": smi, **run_ab(
            name, variants, timed_calls(calls),
            lambda c=calls: check_calls(c), walk_parent if walk else parent,
            parent_walk_runs(calls) if walk else None)}), flush=True)
        del calls
        torch.cuda.empty_cache()
    if "rga" in parts:
        import chip_smoke

        replay, cons = rga_apply_inputs(dev)
        stats = [chip_smoke.rga_walk_stats(*args) for args, _ in cons]
        heavy = max(range(len(cons)), key=lambda j: stats[j]["live"])
        print(json.dumps({"kernel": "rga_apply", "nvidia_smi": smi,
                          "replay": chip_smoke.rga_walk_stats(*replay[0]),
                          "consensus_calls": stats,
                          "timed_consensus_call": heavy}), flush=True)
        calls = {"replay": ("rga_apply", replay),
                 "consensus": ("rga_apply", cons[heavy])}
        print(json.dumps({"kernel": "rga_apply", "nvidia_smi": smi, **run_ab(
            "rga_apply", RGA_VARIANTS, timed_calls(calls),
            plain_checked(calls), rga_parent,
            parent_rga_runs(calls) if rga_parent else None, own=True)}),
            flush=True)
        del replay, cons, calls
        torch.cuda.empty_cache()
    if "ring" in parts:
        ring_ab(ring_parent, smi)
    if "replay" in parts:
        replay_ab(dev, replay_parent, smi)
    if "lwwwalk" in parts:
        lww_ab(dev, lww_parent, smi)
    if "orsetapply" in parts:
        apply_ab(dev, apply_parent, smi)
    if "select" in parts:
        select_ab(dev, select_parent, smi)
    if "safekv" in parts:
        safekv_ab(dev, root, smi)
    if "round" in parts:
        round_ab(dev, root, smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Where the time of a ``graph_walk_kernel`` apply goes, on the card.

A version of ``csrc/graph_apply.cu`` is timed whole and in stripped
copies at the calls ``chip_smoke.py`` times for ``graph_apply`` and
``tpset_apply`` (the delta applies with the most live lanes among the
first rounds of its graph_consensus and tpset_consensus phases: 16 views,
10,000 keys, 5,120-op blocks), each copy cumulative. Of the source before
the walk's redesign (``git show c0936e7:janus_tpu_torch/csrc/
graph_apply.cu``, one 32-thread block a (view, row) group):

- ``count``: lane_buckets' count launch alone;
- ``scan``: count and scan;
- ``buckets``: count, scan and fill (``lane_buckets::build``);
- ``order``: the buckets and the walk kernel putting each group's lanes
  in lane order (``sorted_windows``), no row staged, no lane walked;
- ``stage``: that and each group's row staged in shared memory;
- ``walk``: that and the lanes walked, no row written back;
- ``full``: the source as it is (held bit-equal to the plain version).

Of the redesigned source (records bucketed by group, a warp a group):
``buckets`` (the grouping launch alone) and ``full``.

Each phase's time is the difference of two neighbours. Beside them the
package's own wrapper is timed on the same call. Every copy is built by
``nvcc`` with the package's flags into ``janus_tpu_torch/build/ab/`` and
timed by CUDA events around 20 calls queued behind a sleeping kernel, in
turns (first to last, then last to first), on a clone of the call's state
that the calls update in place, as ``chip_smoke.py`` times them. The
script also prints, for those calls and for the applies of
``chip_smoke.py``'s ``tp_store`` phase at ticks 0, 1 and 17, the live
lanes of each non-empty group (mean, p99, max, groups over 32), the
source's ``-Xptxas -v`` lines for the walk kernels, and their resident
blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the
calls' shapes). Prints one JSON line per part and the card's name and
power limit:

    python scripts/walk_split.py OLD_SOURCE
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from janus_tpu_torch import kernels  # noqa: E402
from janus_tpu_torch.bench import workloads  # noqa: E402
from janus_tpu_torch.kernels import build  # noqa: E402
from kernel_ab import clone, device_ms, nvidia_smi, same, use  # noqa: E402

BUILD = """  cudaError_t err =
      lane_buckets::build(o.op, o.key, live, V, K, B, lists, s);
  if (err != cudaSuccess) return (int)err;
"""
STAGE_START = "    for (int c = tid; c < CV; c += THREADS) {\n      vk[c] = st.v"
STAGE_END = "    __syncthreads();\n    bool touched = false;"
WALK_START = "    auto walk = [&](const int* lanes, int m) {\n"
WALK_END = "        __syncwarp();\n      }\n    };\n"
WRITE = "    if (touched) {"
# the launches of lane_buckets::build, the first `n` of them
LAUNCHES = ("""  const long long total_ = (long long)V * B;
  const long long want_ = (total_ + 255) / 256;
  const unsigned grid_ =
      (unsigned)(want_ < 132LL * 16 ? want_ : 132LL * 16);
  lane_buckets::count_kernel<<<grid_, 256, 0, s>>>(o.op, o.key, live,
                                                   total_, B, K, lists.count);
""", """  lane_buckets::scan_kernel<<<V, 256, 0, s>>>(lists.count, lists.start, K);
""", """  lane_buckets::fill_kernel<<<grid_, 256, 0, s>>>(
      o.op, o.key, live, total_, B, K, lists.count, lists.start, lists.lanes);
""")
OCCUPANCY = """
extern "C" int walk_blocks_per_sm(int mode, int edges, int cv, int ce,
                                  int* out) {
  const size_t bytes = (size_t)cv * (sizeof(int) + 2) +
                       (size_t)ce * (2 * sizeof(int) + 2) +
                       sizeof(int) * WCAP;
  void (*k)(Rows, Ops, lane_buckets::Lists, int*, int*, int, int, int, int,
            int) =
      edges ? (mode == 0 ? graph_walk_kernel<0, true>
                         : graph_walk_kernel<2, true>)
            : (mode == 0 ? graph_walk_kernel<0, false>
                         : graph_walk_kernel<2, false>);
  cudaError_t err = allow_shared(k, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, THREADS,
                                                        bytes);
  return (int)err;
}
"""


def cut(text, start, end, new):
    """``text`` with [start, end) (end included) replaced by ``new``."""
    i = text.index(start)
    j = text.index(end, i) + len(end)
    return text[:i] + new + text[j:]


NEW_FILL = "  group_fill_kernel<EDGES, MODE == MODE_CAPTURED><<<"
NEW_WALK = "  return launch_shape<MODE, EDGES>("


def variants(text):
    """The cumulative stripped copies of the source, by name: of the
    source before the redesign (one block a group) count, scan, buckets,
    order, stage, walk and full; of the redesigned one (records bucketed,
    a warp a group) buckets and full."""
    if NEW_FILL in text:
        if NEW_WALK not in text:
            raise ValueError(f"the source has no {NEW_WALK!r}")
        return {"buckets": text.replace(NEW_WALK, "  return (int)err;\n" +
                                        "  " + NEW_WALK),
                "full": text}

    def launches(n):
        body = "".join(LAUNCHES[:n]) + "  cudaError_t err = cudaGetLastError();\n"
        return text.replace(BUILD, body + "  return (int)err;\n")
    for part in (BUILD, STAGE_START, STAGE_END, WALK_START, WALK_END, WRITE):
        if part not in text:
            raise ValueError(f"the source has no {part!r}")
    no_write = text.replace(WRITE, "    if (touched && V < 0) {")
    # a walk that only reads each window's last lane (so that the ordering
    # stays live) and never marks the row touched
    no_walk = cut(no_write, WALK_START, WALK_END, WALK_START +
                  "      if (m > 0 && tid == 0 && lanes[m - 1] < 0) "
                  "touched = true;\n    };\n")
    no_stage = cut(no_walk, STAGE_START, STAGE_END, STAGE_END)
    return {"count": launches(1), "scan": launches(2), "buckets": launches(3),
            "order": no_stage, "stage": no_walk, "walk": no_write,
            "full": text}


def build_logged(text, tag):
    """The source ``text`` built like ``kernel_ab.build_text``, returning
    ``(library, ptxas -v lines of the walk kernels)``."""
    ab = build.BUILD / "ab"
    ab.mkdir(parents=True, exist_ok=True)
    src, out = ab / f"graph_apply_{tag}.cu", ab / f"libgraph_apply_{tag}.so"
    src.write_text(text)
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
    lines, keep = [], False
    for ln in proc.stdout.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            keep = "walk" in ln
        if keep and ("registers" in ln or "stack frame" in ln
                     or "Compiling entry" in ln):
            lines.append(ln.strip())
    return ctypes.CDLL(str(out)), lines


def group_stats(state, ops, codes):
    """Live lanes a non-empty (view, gathered row) group of one apply."""
    K = state["v" if "v" in state else "valid"].shape[1]
    op = ops["op"].cpu().numpy()
    key = ops["key"].cpu().numpy().astype(np.int64)
    row = np.clip(np.where(key < 0, key + K, key), 0, K - 1)
    live = np.isin(op, codes)
    view = np.broadcast_to(np.arange(op.shape[0])[:, None], op.shape)
    n = np.bincount((view * K + row)[live])
    n = n[n > 0]
    if n.size == 0:
        return {"groups": 0}
    return {"live_lanes": int(n.sum()), "groups": int(n.size),
            "mean": float(n.mean()), "p99": float(np.percentile(n, 99)),
            "max": int(n.max()), "over_32": int((n > 32).sum()),
            "lanes": f"V{op.shape[0]} B{op.shape[1]}"}


def recorded_calls(dev):
    """The applies of the first ``TP_CHECKS["rounds"]`` rounds of the
    graph_consensus and tpset_consensus phases (the one with the most live
    lanes per wrapper, cloned) and of tp_store at ticks 0, 1 and
    ``TP_CHECKS["late_tick"]`` (their group statistics)."""
    import chip_smoke

    codes = {"graph_apply": (1, 2, 3, 4), "tpset_apply": (1, 2)}
    best, stats, tag = {}, {}, {"run": ""}
    real = {n: getattr(kernels, n) for n in codes}

    def spy(name):
        def call(state, ops):
            live = chip_smoke.live_lanes(ops, codes[name])
            if tag["run"].endswith("consensus"):
                if live > best.get(name, (-1,))[0]:
                    best[name] = (live, clone((state, ops)))
            elif tag["run"]:
                stats[f"{name} {tag['run']}"] = group_stats(state, ops,
                                                            codes[name])
            return real[name](state, ops)
        return call

    for name in codes:
        setattr(kernels, name, spy(name))
    try:
        for kind, g in (("tpset", chip_smoke.TPSET_CONS),
                        ("graph", chip_smoke.GRAPH_CONS)):
            tag["run"] = f"{kind}_consensus"
            kv = chip_smoke.tp_kv(dev, kind, g)
            for ops in chip_smoke.tp_stream(workloads, kind, g,
                                            chip_smoke.TP_CHECKS["rounds"]):
                kv.step(workloads.ops_to_device(ops, dev))
            del kv
        arms = chip_smoke.tp_store_arms(dev)
        late = chip_smoke.TP_CHECKS["late_tick"]
        for t, host in enumerate(chip_smoke.tp_store_stream(workloads,
                                                            late + 1)):
            batch = {tc: workloads.ops_to_device(o, dev)
                     for tc, o in host.items()}
            for arm, (st, use_delta) in arms.items():
                tag["run"] = (f"tp_store {arm} tick {t}"
                              if t in (0, 1, late) else "")
                st.fused_tick(batch, delta=use_delta)
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    for name, (_, (state, ops)) in best.items():
        stats[f"{name} timed call"] = group_stats(state, ops, codes[name])
    return {name: call for name, (_, call) in best.items()}, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("walk_split: no CUDA device is available", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi()
    text = pathlib.Path(sys.argv[1]).read_text()
    calls, stats = recorded_calls(dev)
    print(json.dumps({"part": "groups", "nvidia_smi": smi, **stats}),
          flush=True)

    libs, ptxas = {}, {}
    new = NEW_FILL in text
    for tag, src in variants(text).items():
        extra = OCCUPANCY if tag == "full" and not new else ""
        libs[tag], ptxas[tag] = build_logged(src + extra, tag)
    occ = {}
    for name, (state, _) in calls.items():
        edges = name == "graph_apply"
        cv = state["v" if edges else "valid"].shape[-1]
        ce = state["src"].shape[-1] if edges else 0
        out, threads = ctypes.c_int(0), ctypes.c_int(32)
        if new:
            rc = libs["full"].graph_walk_occupancy(
                int(edges), cv, ce, ctypes.byref(out), ctypes.byref(threads))
        else:
            rc = libs["full"].walk_blocks_per_sm(0, int(edges), cv, ce,
                                                 ctypes.byref(out))
        occ[name] = {"rc": rc, "blocks_per_sm": out.value,
                     "threads_per_block": threads.value, "cv": cv, "ce": ce}
    print(json.dumps({"part": "build", "nvidia_smi": smi,
                      "ptxas": ptxas["full"], "occupancy": occ}), flush=True)

    for name, (state, ops) in calls.items():
        plain = getattr(kernels, name + "_plain")
        use("graph_apply", libs["full"])
        a, b = clone(state), clone(state)
        if not same((getattr(kernels, name)(a, ops), a), (plain(b, ops), b)):
            raise AssertionError(f"{name}: the full copy differs from plain")
        times = {tag: [] for tag in [*libs, "package"]}
        order = list(times) + list(reversed(times))
        for tag in order:
            use("graph_apply", None if tag == "package" else libs[tag])
            mine = clone(state)
            times[tag].append(device_ms(
                lambda: getattr(kernels, name)(mine, ops)))
            del mine
        use("graph_apply", None)
        mean = {tag: sum(t) / len(t) for tag, t in times.items()}
        tags = list(libs)
        split = {tags[0]: mean[tags[0]], **{
            tags[i]: mean[tags[i]] - mean[tags[i - 1]]
            for i in range(1, len(tags))}}
        print(json.dumps({"part": "split", "kernel": name, "nvidia_smi": smi,
                          "device_ms": times, "mean_ms": mean,
                          "phase_ms": split}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

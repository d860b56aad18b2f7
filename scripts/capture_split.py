#!/usr/bin/env python
"""Where the time of the block-per-view ``orset_capture`` goes, on the card.

The capture kernel as it was before its redesign (one block per view: a
block sort of the view's adds, then one thread per op lane scanning its
row, walking its key's adds and merging the two prefixes by an insertion
sort; ``git show d488232:janus_tpu_torch/csrc/orset_capture.cu``) is timed
whole and in stripped copies at the call ``chip_smoke.py`` times (the last
capture of a six-round OR-Set SafeKV run at the orset4 geometry: 4 views,
100 keys of 64 slots, 8,192 lanes, capture width 4):

- ``full``: the kernel as it was (held bit-equal to the plain version);
- ``sort``: the gather of the adds and their block sort only;
- ``scan``: no adds; each remove/clear lane's row scan and its writes;
- ``nomerge``: all but the insertion sort (the two prefixes written as
  they are);
- ``merge``: no adds and no row scan; each remove/clear lane's insertion
  sort of 2 x r_cap entries it computes from its op fields, and its
  writes;

and beside them the package's own ``orset_capture`` on the same call; the
whole old kernel and the package's are also timed on that call with every
lane's key set to 0 (``hot_key``: one bucket of ~4,096 adds a view). Each
copy is built by ``nvcc`` with the package's flags into
``janus_tpu_torch/build/ab/`` and timed by CUDA events around 20 calls
queued behind a sleeping kernel, in turns (first to last, then last to
first). Prints one JSON line and the card's name and power limit:

    python scripts/capture_split.py OLD_SOURCE

``OLD_SOURCE`` is that version of ``csrc/orset_capture.cu`` (for example
unpacked from ``git archive d488232``).
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from janus_tpu_torch import kernels  # noqa: E402
from janus_tpu_torch.bench import workloads  # noqa: E402
from kernel_ab import build_text, device_ms, nvidia_smi  # noqa: E402

GATHER = ("  if (threadIdx.x == 0) n_adds = 0;",
          "  block_sort(adds, n, LessWXYZ());  // (key, a1, a2, lane)\n")
PREFIX = "  const int ns = R < C ? R : C;  // width of the state prefix\n"
STAGE1 = "    // (1) selected tags of the gathered row, in row order\n"
STAGE2 = "    // (2) matching adds of earlier lanes of the same raw key, tag order\n"
STAGE3 = "    // (3) stable insertion sort by tag, first R out\n"
SORT_LOOP = "    for (int a = 1; a < len; ++a) {"
WRITE_PREFIX = """    for (int r = 0; r < R; ++r) {
      out_rep[out + r] = mr[r < ns ? r : 0];
      out_ctr[out + r] = mc[r < ns ? r : 0];
      out_elem[out + r] = me[r < ns ? r : 0];
    }
    if (ns >= 0) continue;
"""
SYNTHETIC = """    for (int q = 0; q < ns + R; ++q) {
      mr[q] = (key * 31 + q * 7919) ^ a0;
      mc[q] = q ^ key;
      me[q] = a0 + q;
    }
"""


def cut(text, start, end, new):
    """``text`` with [start, end) (end included) replaced by ``new``."""
    i = text.index(start)
    j = text.index(end, i) + len(end)
    return text[:i] + new + text[j:]


def variants(text):
    """The stripped copies' sources, by name."""
    def sub(src, old, new):
        if src.count(old) != 1:
            raise ValueError(f"not one {old!r} in the old source")
        return src.replace(old, new)

    no_adds = cut(text, GATHER[0], GATHER[1], "  const int n = 0;\n")
    return {
        "full": text,
        "sort": sub(text, PREFIX, "  if (threadIdx.x == 0) out_rep[ob] = "
                    "n > 0 ? adds[n - 1].x : 0;\n  if (n >= 0) return;\n"
                    + PREFIX),
        "scan": sub(no_adds, STAGE2, WRITE_PREFIX + STAGE2),
        "nomerge": sub(text, SORT_LOOP, "    for (int a = len; a < len; ++a) {"),
        "merge": cut(no_adds, STAGE1, STAGE3, SYNTHETIC + STAGE3),
    }


def recorded_call(dev):
    """(state, ops, r_cap) of the last capture of a six-round OR-Set
    SafeKV run at the orset4 geometry, as ``chip_smoke.py`` records it."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.utils.ids import TagMinter

    n, k, b = 4, 100, 8192
    kv = SafeKV(DagConfig(n, 8), orset.SPEC, ops_per_block=b, apply_budget=8,
                collect_logs=False, device=dev, num_keys=k, capacity=64,
                rm_capacity=4)
    rng = np.random.default_rng(9)
    mint = [TagMinter(i) for i in range(n)]
    calls = []
    real = kernels.orset_capture

    def spy(state, ops, r_cap):
        calls.append(({f: x.clone() for f, x in state.items()},
                      {f: x.clone() for f, x in ops.items()}, r_cap))
        return real(state, ops, r_cap)

    kernels.orset_capture = spy
    try:
        for _ in range(6):
            kv.step(workloads.ops_to_device(
                workloads.orset_add_remove(rng, mint, k, b), dev))
    finally:
        kernels.orset_capture = real
    torch.cuda.synchronize()
    return calls[-1]


def launcher(lib, state, ops, r_cap):
    """A call of an old-source library's entry point on the recorded
    inputs, into fresh outputs."""
    fn = lib.orset_capture_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 13 + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    V, K, C = state["valid"].shape
    B = ops["op"].shape[1]
    dev = state["valid"].device
    out = [torch.empty((V, B, r_cap), dtype=torch.int32, device=dev)
           for _ in range(3)]
    scratch = torch.empty((0, 4), dtype=torch.int32, device=dev)
    args = [*(ops[f].data_ptr() for f in ("op", "key", "a0", "a1", "a2")),
            *(state[f].data_ptr() for f in ("tag_rep", "tag_ctr", "elem",
                                            "valid")),
            *(x.data_ptr() for x in out), scratch.data_ptr(),
            V, B, K, C, r_cap, 1]

    def call():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old orset_capture: CUDA error {rc}")
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("capture_split: needs a CUDA device and the old source's path",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    state, ops, r_cap = recorded_call(dev)
    libs = {name: build_text("orset_capture", text, f"split_{name}")
            for name, text in variants(pathlib.Path(sys.argv[1])
                                       .read_text()).items()}
    hot = dict(ops, key=torch.zeros_like(ops["key"]))
    calls = {name: launcher(lib, state, ops, r_cap)
             for name, lib in libs.items()}
    calls["package"] = lambda: kernels.orset_capture(state, ops, r_cap)
    calls["hot_key_full"] = launcher(libs["full"], state, hot, r_cap)
    calls["hot_key_package"] = lambda: kernels.orset_capture(state, hot, r_cap)
    for name, inputs in (("full", ops), ("package", ops),
                         ("hot_key_full", hot), ("hot_key_package", hot)):
        got = calls[name]()
        want = kernels.orset_capture_plain(state, inputs, r_cap)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"orset_capture {name} differs from plain")
    order = list(calls) + list(reversed(calls))
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(device_ms(calls[name]))
    smi = nvidia_smi()
    print(json.dumps({"kernel": "orset_capture", "nvidia_smi": smi,
                      "shape": "V4 K100 C64 B8192 r4, last recorded path A call",
                      **{name: {"device_ms": t, "mean_ms": sum(t) / len(t)}
                         for name, t in times.items()}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""A/B of the design constants of two hand kernels on the card.

``rga_compact`` (csrc/rga_compact.cu: the blocks an SM its launch bound
asks for, ``MIN_BLOCKS``) on the rga preset's compaction at tick 3
(R=1,024, K=128, C=1,024, in place, as ``chip_smoke.py`` times it), and
``mvr_apply`` (csrc/mvr_apply.cu: the lanes in flight ahead of the walk,
``RING``) on a captured delta apply at the mvr_consensus phase's geometry
(64 views, 500 keys under Zipf-0.99, V = 8, W = 64: 64 origins' blocks of
64 writes, each captured at its origin, in a batch of 16,384 lanes a
view). Each variant is a copy of the source with one ``constexpr int``
set to another value, built by ``nvcc`` into
``janus_tpu_torch/build/ab/`` with the package's flags, put in the
loader's place for the time of its turn, and held bit-equal to the plain
version on a slice of the inputs; the variants are then timed in turns
(first to last, then last to first), each turn by CUDA events around
``REPS`` calls after a warm-up. Prints one JSON line per kernel and the
card's name and power limit:

    python scripts/kernel_ab.py
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from janus_tpu_torch import kernels  # noqa: E402
from janus_tpu_torch.bench import workloads  # noqa: E402
from janus_tpu_torch.kernels import build  # noqa: E402

REPS = 20
COMPACT_VARIANTS = {f"min{b}": {"MIN_BLOCKS": b} for b in (6, 8, 4)}
WALK_VARIANTS = {f"ring{r}": {"RING": r} for r in (8, 16)}


def build_variant(name, constants, tag) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with each named ``constexpr int`` set to its
    value, built into ``build/ab/lib<name>_<tag>.so`` and loaded."""
    text = (build.CSRC / f"{name}.cu").read_text()
    for const, value in constants.items():
        text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{name}.cu: no single constant {const}")
    ab = build.BUILD / "ab"
    ab.mkdir(parents=True, exist_ok=True)
    src, out = ab / f"{name}_{tag}.cu", ab / f"lib{name}_{tag}.so"
    src.write_text(text)
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} {constants}:\n"
                           f"{proc.stdout}")
    return ctypes.CDLL(str(out))


def use(name, lib) -> None:
    """Make ``lib`` the library the wrapper of ``name`` launches (None:
    the package's own build again, at its next load)."""
    if lib is None:
        build._LIBS.pop(name, None)
    else:
        build._LIBS[name] = lib


def device_ms(fn, reps=REPS) -> float:
    """Device milliseconds a call, by CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b) -> bool:
    if isinstance(a, dict):
        return all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()


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


def run_ab(name, variants, call, check):
    """Build each variant, check it, then time all of them in turns."""
    libs = {}
    for tag, constants in variants.items():
        libs[tag] = build_variant(name, constants, tag)
        use(name, libs[tag])
        if not check():
            raise AssertionError(f"{name} {tag}: differs from plain")
    order = list(variants) + list(reversed(variants))
    times = {tag: [] for tag in variants}
    for tag in order:
        use(name, libs[tag])
        times[tag].append(device_ms(call))
    use(name, None)
    return {tag: {"constants": variants[tag], "device_ms": t,
                  "mean_ms": sum(t) / len(t)} for tag, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    rows = compaction_input(dev)
    part = {f: x[:8].clone() for f, x in rows.items()}
    mine = clone(rows)
    print(json.dumps({"kernel": "rga_compact", "nvidia_smi": smi, **run_ab(
        "rga_compact", COMPACT_VARIANTS,
        lambda: kernels.rga_compact(mine, None, out=mine),
        lambda: same(kernels.rga_compact(part),
                     kernels.rga_compact_plain(part)))}), flush=True)
    del rows, mine, part
    torch.cuda.empty_cache()

    views, ops = walk_input(dev)
    small = ({f: x[:4].clone() for f, x in views.items()},
             {f: x[:4].clone() for f, x in ops.items()})

    def check_walk():
        a, b = clone(small[0]), clone(small[0])
        return same((kernels.mvr_apply(a, small[1]), a),
                    (kernels.mvr_apply_plain(b, small[1]), b))

    mine = clone(views)
    print(json.dumps({"kernel": "mvr_apply", "nvidia_smi": smi, **run_ab(
        "mvr_apply", WALK_VARIANTS, lambda: kernels.mvr_apply(mine, ops),
        check_walk)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

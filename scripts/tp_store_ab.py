#!/usr/bin/env python
"""Wall time of ``chip_smoke.py``'s ``tp_store`` phase (or, with ``--phase
typed_store``, its ``typed_store`` phase) on the card, this checkout
against another, in alternating turns.

Each run is the phase alone in a new process started at one checkout's
root, with that checkout's package (its kernels built there at first
use): one warm-up tick, then 24 timed ticks of both arms (a full arm and
a delta arm at harness preset mixed_delta's geometry), as the smoke script
runs it. Beside the phase each run times a fixed host-only loop of small
CPU tensor ops (``HOST_PROBE``), which tells whether a slow run had a slow
host. Each turn runs both checkouts, the order flipped every turn (this,
parent; parent, this; ...). Prints one JSON line a run (each arm's mean,
min and max ms a tick, converged ops/s and device ms a tick, as the phase
reports them, and the probe's ms), then one line with, per checkout and
arm, the median, min and max over the turns of the mean ms a tick, and
the card's name and power limit:

    python scripts/tp_store_ab.py --parent DIR [--turns N] [--phase NAME]
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
TURNS = 6
HOST_PROBE = """
import time, torch
x = torch.zeros(16, dtype=torch.int32)
t0 = time.perf_counter()
for _ in range(400):
    x = torch.empty_like(x).copy_(x).add_(1)
probe_ms = 1e3 * (time.perf_counter() - t0)
"""
CHILD = HOST_PROBE + """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
getattr(chip_smoke, sys.argv[1])(torch.device("cuda"), kernels, workloads)
print(json.dumps({"host_probe_ms": probe_ms}), flush=True)
"""
PHASES = ("tp_store", "typed_store")


def run_phase(root: pathlib.Path, phase: str) -> dict:
    """The ``phase`` line of one run of the phase at ``root``, with the
    host probe's ms; raises if the run fails."""
    proc = subprocess.run([sys.executable, "-c", CHILD, phase], cwd=root,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{phase} at {root} failed:\n{proc.stderr}")
    out = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            rec = json.loads(ln)
            if rec.get("phase") == phase or "host_probe_ms" in rec:
                out.update(rec)
    return out


def main() -> int:
    if "--parent" not in sys.argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = pathlib.Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
    turns = (int(sys.argv[sys.argv.index("--turns") + 1])
             if "--turns" in sys.argv else TURNS)
    phase = (sys.argv[sys.argv.index("--phase") + 1]
             if "--phase" in sys.argv else "tp_store")
    if phase not in PHASES:
        print(f"tp_store_ab: --phase takes one of {PHASES}", file=sys.stderr)
        return 2
    roots = {"change": ROOT, "parent": parent}
    means = {tag: {} for tag in roots}
    for turn in range(turns):
        for tag in (roots if turn % 2 == 0 else reversed(list(roots))):
            rec = run_phase(roots[tag], phase)
            arms = {arm: {k: a[k] for k in (
                "ms_per_tick", "ms_per_tick_min", "ms_per_tick_max",
                "converged_ops_per_s", "device_ms_per_tick")}
                for arm, a in rec["arms"].items()}
            for arm, a in arms.items():
                means[tag].setdefault(arm, []).append(a["ms_per_tick"])
            print(json.dumps({"phase": phase, "turn": turn,
                              "checkout": tag, "arms": arms,
                              "host_probe_ms": rec["host_probe_ms"]}),
                  flush=True)
    print(json.dumps({"ms_per_tick_over_turns": {
        tag: {arm: {"median": statistics.median(v), "min": min(v),
                    "max": max(v), "turns": v}
              for arm, v in by.items()}
        for tag, by in means.items()}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

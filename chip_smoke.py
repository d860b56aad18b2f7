#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (janus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card through its own entry points and
checks every result; any failed check raises, so the script exits
non-zero. Phases, one JSON line each:

1. device     the card's name and power limit (nvidia-smi)
2. build      all twenty-seven kernel sources in csrc/ compiled with
              nvcc, in parallel
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
              [-K, 2K)), path A's ops all on one key, the recorded calls
              of an OR-Set SafeKV run and an OR-Set store run, the
              capture's edge cases (workloads.orset_capture_case: long
              walks of a hot key, buckets out of tag order, aliased keys,
              tags repeated between row and batch, non-canonical rows; at
              B = 16,384 and r_cap 1 and 32) and the union's
              (workloads.orset_union_case: fresh, broadcast, aliased,
              unequal widths, and the row-list tree with slot_union_rows),
              with the shares of the capture's buckets and of level-1
              union rows already in tag order; dirty_rows,
              delta_select, replica_join_rows and slot_union_rows (phase
              delta_kernels) on hazard ops, masks with no, all, exactly D
              and D+1 dirty rows at odd R and R=1, the row-list joins on
              those selections, and the recorded calls of a delta store
              run; rga_union, rga_union_rows, rga_apply, rga_compact and
              rga_order (phase rga_kernels) on random canonical and
              non-canonical rows, the union's edge cases at the preset's
              rows (workloads.rga_union_case: sorted rows sharing ids,
              sorted and unsorted tails, reversed and shuffled rows, holes,
              SENTINEL ids, all-invalid and full rows; fresh, broadcast,
              aliased and row-list forms), deep random trees (chains past
              max_depth, dangling and cyclic parents, dead interior nodes,
              invalid slots mid-row), full rows that drop, deletes before
              their insert, keys in [-K, 2K), and every call of the rga
              preset's first two ticks, its first compaction, tick 3's
              apply and compaction, a text and two delta ticks, with
              the share of level-1 union input rows already sorted by id
              (counted from those calls' inputs, not in the kernel);
              safekv_submit (accept and board), block_select,
              state_transfer and gc_frontier (with the ring clear) (phase
              safekv_kernels) on random inputs at (N, W) from (4, 8) to
              (64, 16) reaching rejected submits, selections past the
              budget, wrapped commit keys, transfers by lag, frontier and
              force (the donor among them), zero-size leaves, multi-slot GC
              advances with a lost straggler and packs with and without
              the logs, and on every call of SafeKV runs at the consensus
              phase's geometry (4 and 16 nodes, a node crashed), the
              orset_consensus phase's and harness preset mixed's 64 nodes;
              orset_compact (with its orset_watermark and fused
              orset_compact_fences entries), rga_capture and mark_members
              (phase fence_kernels) on random OR-Set rows behind
              watermarks of rings with and without a live add (at preset
              orset's state and ring), one state and two in one fused
              call, RGA captures with inserts
              into full rows, keys in [-K, 2K), one document hammered and
              floors at INT32_MAX, memberships with duplicates, masked and
              SENTINEL keys, M = 0, T = 0 and the RGA fence's sizes, and
              every call of the rga_consensus phase's first rounds
              (rga_compact's too) and of the orset_consensus phase's runs;
              rga_apply and rga_capture on the walk's edge cases
              (workloads.rga_walk_case: no-op floods, negative floors
              behind no-ops, rows only no-ops touch, key hazards, a row
              past its bucket) at a delta apply's layout, and two of
              those rounds' delta applies (16,384 lanes a view: no live
              lane, the most), the plain versions run on host copies;
              lww_union, lww_union_rows, lww_apply, lww_capture,
              mvr_merge, mvr_merge_rows, mvr_apply and mvr_capture (phase
              typed_kernels, run after phase 15 so that nothing it keeps
              is there while the paths are timed) on random canonical and non-canonical rows,
              full rows that drop, hazard ops (keys in [-2K, 2K), every op
              code, writers in [-2W, 2W), stamps with negative low words
              and equal stamps, wclocks at the int32 extremes), more
              concurrent writers than V, rows hammered past a walk's lane
              window, the row-list levels (gather, scratch, scatter), the
              main paths' shapes, and every call of the first rounds of
              lww_consensus and mvr_consensus and the first ticks of
              typed_store; tp_union, tp_union_rows, edge_union,
              edge_union_rows, tpset_apply, tpset_capture, graph_apply,
              graph_capture and edge_mask (phase tp_kernels, run after
              typed_kernels) on random canonical and non-canonical rows,
              full rows that drop, hazard ops (keys in [-2K, 2K), op codes
              from -1 to 5, self-loops, endpoints at INT32_MAX), masks with
              the sentinel quirk and CV = 0, rows hammered past a walk's
              lane window, the row-list levels, and every call of the first
              rounds of tpset_consensus and graph_consensus and the first
              ticks of tp_store; dag_ingest and dag_round's split mode
              (phase ingest_kernels) on random wire batches at five (N, W)
              (stale and ahead-of-window rounds, duplicate (r, src) copies
              and re-sends with other edges, node ids out of range, empty
              seen_by, payload rows of pnc's ring and of the OR-Set's
              capture lanes) and random states with and without active,
              withhold and invalid
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
              each consensus kernel must launch once per SafeKV round, and
              the round's other wrappers as often as a round calls them
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
              canonical with no tag twice; a GC advance's compaction one
              orset_compact_fences call of 2 CUDA kernels (a captured
              graph's)
8. rga_consensus  SafeKV for the RGA at 4 nodes, window 8, 1024-op
              blocks, 128 documents of 1,024 slots (BASELINE config 5's):
              512 inserts and 512 deletes per node per round
              (workloads.rga_churn); pass 1 records the counters the
              inserts mint, pass 2 runs 64 timed rounds of the full churn
              and idle rounds until drained; checked for acceptance, the
              same counters, compactions, no drop, stable views bit-equal,
              prospective holding the stable elements, three documents'
              texts against a numpy model, and each wrapper's launches per
              round and per GC advance
9. store_delta  the delta anti-entropy store (harness preset mixed_delta):
              R=64 replicas, K=500 keys of a PN-Counter and of a 256-slot
              OR-Set, B=64 ops per type per replica per tick in a Zipf hot
              window of 32 keys; three Stores through fused_tick, one full
              converge per tick, one delta at D=64 and one at D=16 (every
              tick overflows), 24 ticks; every arm bit-equal to the full
              one after every tick and after sync_all, with the launches
              per tick, the dirty fractions and the overflow counts checked
10. rga_replay harness preset rga (BASELINE config 5), uncut: R=1,024
              replicas, K=128 documents of 1,024 slots (2.95 GB), 16 insert
              and 16 delete lanes per replica per tick, 64 ticks of
              make_tick with a compaction every 4, the first off the clock,
              then 8 texts of document 0; a second arm through
              Store.fused_tick at dirty budget K; replicas and arms
              bit-equal, 256 live elements per document, nothing dropped,
              no depth overflow, the text of document 0 equal to an
              independent numpy model
11. harness_tensor  the port's tensor-mode harness (run_tensor) at presets
              pnc, orset (16 nodes) and mixed (64 nodes, consensus on),
              uncut: Results.to_dict() (throughput, safeUpdate latency in
              ms, tick ms, commit lag in rounds) and slots dropped per
              preset; the stable states of all views agree, prospective
              equals stable where no slot record was dropped, the
              PN-Counter equals a numpy sum of the accepted ops, and
              step_dispatch makes no host synchronisation
12. profiler_check  the kernels torch.profiler saw over 20 calls of a
              plain torch kernel, and of causal_closure right after a
              profile of tusk_commit's plain version (the kernels line
              gives each wrapper's count beside its own launch count)
13. lww_consensus  SafeKV for the LWW-Set at BASELINE config 2's geometry
              (harness preset orset: 16 nodes, window 8, 1,000 keys of 64
              slots, 5,120-op blocks), 50/50 add/remove over 64 elements,
              stamps minted per node from one epoch (equal stamps across
              nodes): 24 timed rounds, idle rounds until drained, then a
              record pass of the same rounds (bit-equal at its end);
              stable views bit-equal, prospective holding the stable
              elements by (key, elem), each remove's ok decided in numpy
              from the rows its capture read, every (key, elem)'s stamps
              equal to a numpy max-fold over the committed ops with
              those ok
14. mvr_consensus  SafeKV for the MVRegister at config 3's geometry
              (preset mixed: 64 nodes, window 8, 500 keys under Zipf-0.99,
              64-op blocks), a clock lane per node, V=8: 24 timed rounds,
              idle rounds until drained, a record pass; stable views
              bit-equal and equal to a numpy frontier fold of the writes
              the stable applies received, in their order; every
              surviving pair of a key's values concurrent, at most V values
15. typed_store  both types through Store.fused_tick at preset
              mixed_delta's geometry (R=64, K=500, B=64 per type, LWW rows
              of 256 slots, MVRegister V=8, W=64): a full arm and a delta
              arm at D=64, 24 ticks; replicas bit-equal and canonical after
              every converge, the delta arm bit-equal to the full arm
16. tpset_consensus  SafeKV for the 2P-Set at BASELINE config 2's cluster
              shape (16 nodes, window 8, 5,120-op blocks) and its 10,000
              keys of 64 slots, 50/50 add/remove over 64 elements: 24 timed
              rounds, idle rounds until drained, a record pass; stable views
              bit-equal, prospective holding the stable records by (key,
              elem), each remove's ok decided in numpy from the rows its
              capture read, every (key, elem)'s presence and tombstone equal
              to a numpy fold of the committed ops with those ok, the live
              elements after rounds 1, 12 and 24
17. graph_consensus  SafeKV for the Graph at the same shape (32 vertex and
              256 edge slots a key, av 30%, ae 40%, re 15%, rv 15%),
              edge_count of the prospective views after every timed round:
              the same checks, each gate decided again in numpy, the stable
              edge_count equal to a numpy dangling-edge filter of the model
18. tp_store  both types through Store.fused_tick at preset mixed_delta's
              geometry (R=64, K=500, B=64 per type, 2P-Set rows of 256
              slots, Graph rows of 32 + 256): a full arm and a delta arm at
              D=64, 24 ticks; replicas bit-equal and canonical after every
              converge, the delta arm bit-equal to the full arm
19. split_consensus  the split cluster, the reference's deployment: four
              SplitNode processes of one node each (N = 4, W = 8) in this
              process over in-memory pipes, signed (ECDSA, or the keyed
              hash without libcrypto) payload-carrying blocks; the
              PN-Counter at the paper's peak point (100 objects, blocks of
              1,000, half the updates safe) and the OR-Set at preset
              orset4's geometry (100 objects of 64 slots, 8,192-op blocks,
              50/50 add/remove). Per type a recorded pass, whose every
              dag_ingest and split dag_round call is replayed against its
              plain version (the PN-Counter's first 8 iterations also held
              bit-equal to the same cluster on the CPU after every process
              step), and a timed pass of 4 + 32 iterations and idle ones to
              drain; checked for no bad frame, committed orders that agree,
              every boarded batch committed, owned stable views bit-equal
              across the processes, the PN-Counter's equal to a numpy fold
              of the committed blocks' payloads; then a cluster whose
              fourth process's frames are corrupted in transit, dropped by
              the honest three, who keep committing
20. split_tcp  two processes (two nodes each) of the PN-Counter cluster
              over loopback TCP (TcpPeer): the same checks, ms per step
21. harness_adaptive  (run after harness_tensor) run_tensor_adaptive
              through harness.run at presets orset_adaptive (saturated),
              orset_adaptive_light and orset_fixed_light (the trickle of
              Fig 7, 16 nodes, B up to 5,120), uncut, and the light preset
              under a 1 ms latency target at its trickle and at 32 ops a
              node a tick (ADAPTIVE): B within floor and ceiling on the
              quantum, every target the controller's law on the recorded
              observations, resizes, refusals and ring_resize launches
              counted, views' stable states bit-equal; the saturated and
              fixed runs hold 5,120, the tight floor run reaches the floor;
              the block traces, safe-update p50/p99 and tick ms
22. harness_faults  (run after harness_adaptive) run_tensor through
              harness.run at presets byzantine (nodes 12-15 signing
              tampered digests at 0.25 through the integrity plane),
              byzantine0, pnc8 and crash (Fig 11), uncut: the control
              prunes nothing and reads OK, the Byzantine run prunes, keeps
              committing and reads DEGRADED naming an injecting node, live
              views' stable states bit-equal, the PN-Counter against a
              numpy sum of the accepted ops; throughput, lag p50/p99,
              safe-update latency and the Fig 11 deltas
23. ring_kernels  (run after the paths) ring_resize against its plain
              version, bit-equal with its live-tail flag: random rings of
              every type's extras, grows, clean shrinks and shrinks with a
              live tail lane, at RING_CHECKS' geometries (the adaptive
              presets' 47 MB OR-Set ring among them, and lane counts that
              are not multiples of 4), and every call the harness_adaptive
              runs recorded
24. timing, the kernels line, the nvidia-smi line, and the result line.

Needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.
"""
import json
import logging
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
# milliseconds of plain-version calls timed a row
PLAIN_BUDGET_MS = 300.0
# ~50 ms at the H100's boost clock: longer than the host takes to queue a
# timed burst of 20 wrapper calls
SLEEP_CYCLES = 100_000_000
# a plain version slower than this per call is not profiled (the
# profiler's processing of its ~10^4 small kernels took 10-20 s a row)
PLAIN_PROFILE_MAX_MS = 200.0

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
# each wrapper's launch count per SafeKV round (the wrappers' counters)
ROUND_LAUNCHES = {"tusk_commit": 1, "causal_closure": 1, "dag_round": 1,
                  "safekv_submit": 2, "block_select": 2, "state_transfer": 1,
                  "gc_frontier": 1}
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
# ticks of harness preset orset whose replays orset_kernel_checks holds
# against the plain version
HARNESS_CHECK_TICKS = 2
# the replay's edge cases (workloads.orset_replay_case) at (V, K, C, B, r):
# path A's shape, rows past a warp's 256 records (a block a group), and
# capture widths 1 and 32
REPLAY_CASE_GEOS = ((4, 100, 64, 8192, 4), (2, 8, 64, 4096, 4),
                    (3, 7, 8, 300, 1), (2, 5, 16, 400, 32))
# the capture's edge cases (workloads.orset_capture_case) run at path A's
# shape, at B = 16,384 in one view, and at r_cap 32 and 1 with B not a
# multiple of the kernel's 256-lane tile: (V, K, C, B, r_cap)
CAPTURE_CASE_GEOS = ((4, 100, 64, 8192, 4), (1, 7, 8, 16384, 2),
                     (3, 4, 24, 257, 32), (2, 6, 16, 300, 1))
# the union's edge cases (workloads.orset_union_case): rows of path B's
# width, and the row-list tree over states of these many replicas
ORSET_UNION_EDGE = dict(rows=64, capacity=256, replicas=(2, 3, 5))
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
# the rest of the SafeKV round: submit (accept, board), the delta applies'
# selection and gather, the state transfer, the GC frontier (with the ring
# clear)
SAFEKV_KERNELS = ("safekv_submit", "block_select", "state_transfer",
                  "gc_frontier")
# a source's second entry point, counted on its wrapper
SECOND_ENTRIES = {"safekv_board": "safekv_submit",
                  "orset_watermark": "orset_compact",
                  "orset_compact_fences": "orset_compact"}
# random checks per (N, W); recorded runs beside RECORDED's: the OR-Set at
# ORSET_CONS and both types at harness preset mixed's 64 nodes, node N-1
# crashed for rounds [crash[0], crash[1])
SAFEKV_CHECKS = dict(shapes=((4, 8), (7, 6), (16, 8), (64, 8), (64, 16)),
                     states=6)
SAFEKV_RECORDED = dict(orset_rounds=6,
                       mixed=dict(nodes=64, window=8, ops_per_block=64,
                                  keys=500, capacity=256, rm=8, rounds=10,
                                  crash=(2, 6)))
SAFEKV_LIBRARY_NOTES = {
    "safekv_submit": "no single PyTorch call computes it: a per-view accept "
                     "rule, a masked copy and a ring write at rows chosen "
                     "on the device",
    "block_select": "no single PyTorch call computes it: a per-view stable "
                    "smallest-A selection feeding a masked gather",
    "state_transfer": "no single PyTorch call computes it: an order "
                      "statistic and an argmax deciding a row copy over "
                      "every leaf",
    "gc_frontier": "no single PyTorch call computes it: quorum order "
                   "statistics, a W-step scan and a recycle",
}
# the GC fences and the single-op capture: the OR-Set's compaction (with
# its watermark entry), the RGA's capture mode of rga_apply.cu, and the
# membership test of the RGA's fence
FENCE_KERNELS = ("orset_compact", "rga_capture", "mark_members")
# random checks: OR-Set compactions (lead, C, ring lanes, live adds: at
# harness preset orset's state and ring, at the orset_consensus phase's);
# captures (R, K, C, B, full-row share: at the rga_consensus submit);
# memberships (M, T, key span: at the rga_consensus fence); recorded: the
# rga_consensus phase's first rounds
FENCE_CHECKS = dict(
    orset=(((2, 4, 6), 8, 160, True), ((16, 1000), 64, 655360, True),
           ((4, 100), 64, 262144, True), ((3, 5), 300, 40, False),
           ((2, 7), 5, 1, True)),
    captures=((3, 5, 8, 40, 0.25), (4, 3, 6, 300, 1.0), (5, 2, 4, 24, 0.5),
              (4, 128, 1024, 1024, 0.0)),
    members=((700, 90, 4), (0, 5, 4), (9, 0, 4), (5000, 9000, 30),
             (524288, 65536, 1 << 20)),
    # orset_apply's captured mode, JAX's one-lane captured scan: (R, K, C,
    # r_cap, lanes), path B's rows among them
    one_lane=((5, 4, 8, 3, 1), (3, 6, 16, 16, 1), (4, 3, 4, 6, 4),
              (64, 500, 256, 8, 1)),
    # the RGA walk's edge cases (workloads.rga_walk_case) at a delta
    # apply's layout (V, K, C, block; 16 blocks a view; the hot row past
    # its bucket of 128), each in the modes named: the uncaptured and
    # captured apply, the capture (every case in every mode is a card test)
    walk_shape=(4, 32, 256, 64),
    walks=(("consensus", ("apply", "captured", "capture")),
           ("negative_floors", ("apply", "capture")),
           ("noop_rows", ("captured",)),
           ("key_hazards", ("apply", "capture")),
           ("hot_row", ("captured",))),
    rga_rounds=6)
# fresh copies of a recorded GC advance the kernels line times in turn
# (enough for each of its timed calls)
FENCE_COPIES = 72
FENCE_LIBRARY_NOTES = {
    "orset_compact": "no single PyTorch call computes it: a masked min "
                     "and a stable per-row partition",
    "rga_capture": "no single PyTorch call computes it: a per-row "
                   "sequential apply minting Lamport counters",
    "mark_members": "torch.isin on the packed int64 keys (packing and the "
                    "query mask not timed)",
}
# the RGA through SafeKV: BASELINE config 5's documents (K of C slots,
# harness.py:2013-2015) in a 4-node cluster, 1,024-op blocks (the
# consensus phase's scale), the churn of workloads.rga_churn (half the
# lanes insert, half delete), `warmup` rounds off the clock, then the
# timed rounds, idle rounds until drained; texts of these documents
RGA_CONS = dict(nodes=4, window=8, ops_per_block=1024, keys=128,
                capacity=1024, max_depth=8, warmup=2, rounds=64,
                min_idle=8, max_idle=64, profile_rounds=3,
                texts=(0, 1, 127), compaction_reps=5)
# the LWW-Set and the MVRegister: the applies and captures, the LWW
# instantiation of slot_union.cu and the MVRegister's frontier merge
TYPED_KERNELS = ("lww_union", "lww_union_rows", "lww_apply", "lww_capture",
                 "mvr_merge", "mvr_merge_rows", "mvr_apply", "mvr_capture")
# the LWW-Set through SafeKV at BASELINE config 2's geometry as harness
# preset orset gives it (harness.py:1914-1917: 16 nodes, window 8, 1,000
# keys of 64 slots, 5,120-op blocks), the 50/50 add/remove stream of
# workloads.lww_add_remove over 64 elements; `warmup` rounds off the
# clock, the timed rounds, idle rounds until drained, `profile_rounds`
# under the profiler
LWW_CONS = dict(nodes=16, window=8, keys=1000, capacity=64,
                ops_per_block=5120, elems=64, warmup=2, rounds=24,
                min_idle=8, max_idle=64, profile_rounds=2, seed=21)
# the MVRegister through SafeKV at BASELINE config 3's geometry as preset
# mixed gives it (harness.py:1973-1977: 64 nodes, window 8, 500 keys under
# Zipf-0.99, 64-op blocks), a clock lane per node, V = 8 values a key
MVR_CONS = dict(nodes=64, window=8, keys=500, capacity=8, ops_per_block=64,
                warmup=2, rounds=24, min_idle=8, max_idle=64,
                profile_rounds=2, seed=22)
# both types through Store.fused_tick at preset mixed_delta's geometry
# (harness.py:1983-1988): R replicas, K keys, B ops per type per replica
# per tick, keys Zipf-skewed in a hot window of budget/2 keys; LWW rows of
# 256 slots, MVRegister rows of V = 8 values with R clock lanes; a full arm
# and a delta arm at the budget
TYPED_STORE = dict(R=64, K=500, lww_capacity=256, mvr_capacity=8, B=64,
                   budget=64, ticks=24, seed=23)
# the typed wrappers' random checks: unions (lead, Ca, Cb, canonical);
# merges (lead, Va, Vb, W, clock span, canonical); row-list levels (kind,
# pairs, K, C or V, W); applies (V, K, C, B, mode, hot row) and (V, K, Vc,
# W, B, mode, hot row); the walk's edge cases (workloads.mvr_walk_case)
# at (V, K): (case, Vc, W, B, modes), their plain versions on the host
# (a few small steps a write), the long walk once (over 2,048 writes, past
# one window), the others in every mode at Vc = 8, W = 64 and in one mode
# at Vc = 1 and 32; recorded: the consensus phases' first rounds and typed_store's
# first ticks and its late_tick (its hot window revisits keys from tick 16
# on, so a tick's adds find rows that hold records)
TYPED_CHECKS = dict(
    lww_unions=(((3, 5), 6, 6, False), ((7,), 8, 8, True),
                ((2, 4), 5, 3, False), ((16, 1000), 64, 64, False),
                ((32, 500), 256, 256, True)),
    mvr_merges=(((3, 5), 3, 3, 5, 3, True), ((2, 4), 4, 2, 7, 3, False),
                ((4, 9), 1, 1, 33, 3, False), ((7,), 8, 8, 64, 6, True),
                ((32, 500), 8, 8, 64, 3, True)),
    row_levels=(("lww", 2, 40, 16, 0), ("lww", 5, 40, 64, 0),
                ("mvr", 2, 40, 3, 6), ("mvr", 5, 40, 8, 64)),
    lww_applies=((3, 5, 8, 40, "apply", False),
                 (4, 3, 6, 300, "captured", False),
                 (5, 2, 4, 24, "capture", False),
                 (2, 4, 64, 2300, "apply", True),
                 (2, 4, 64, 2300, "capture", True),
                 (16, 1000, 64, 5120, "capture", False),
                 (16, 1000, 64, 20480, "captured", False)),
    mvr_applies=((3, 5, 3, 5, 40, "apply", False),
                 (4, 3, 2, 6, 300, "captured", False),
                 (5, 2, 3, 4, 24, "capture", False),
                 (2, 4, 8, 64, 2300, "captured", True),
                 (64, 500, 8, 64, 64, "capture", False)),
    mvr_walk_geometry=(2, 5),
    mvr_walks=(("long", 8, 64, 2200, ("captured",)),) + tuple(
        (case, 8, 64, 256, ("apply", "captured", "capture"))
        for case in ("cut", "twins", "hazards")) + (
        ("cut", 1, 64, 256, ("capture",)), ("twins", 1, 64, 256, ("apply",)),
        ("hazards", 1, 64, 256, ("captured",)),
        ("cut", 32, 4, 256, ("captured",)), ("twins", 32, 4, 256,
                                             ("captured",)),
        ("hazards", 32, 4, 256, ("apply",))),
    # (64, 500, 256, 64) too is a card test (test_lww_walk_cases_match_plain)
    lww_walks=((64, 500, 64, 64), (2, 6, 300, 700)),
    rounds=3, ticks=2, late_tick=17)
# the LWW union's edge cases (workloads.lww_union_case): `rows` key rows of
# each capacity; row-list trees over these replicas
LWW_UNION_EDGE = dict(rows=64, capacities=(32, 256), replicas=(2, 3, 5))
TYPED_LIBRARY_NOTES = {
    "lww_union": "no single PyTorch call computes it: an elem-keyed union "
                 "with a timestamp-max fold and a capacity cut",
    "lww_union_rows": "no single PyTorch call computes it: an elem-keyed "
                      "union with a timestamp-max fold over listed rows",
    "lww_apply": "no single PyTorch call computes it: a per-row sequential "
                 "upsert gated on containment",
    "lww_capture": "no single PyTorch call computes it: a per-row "
                   "sequential upsert recording each remove's containment",
    "mvr_merge": "no single PyTorch call computes it: a pairwise "
                 "vector-clock dominance filter, a dedupe and a lexicographic "
                 "cut",
    "mvr_merge_rows": "no single PyTorch call computes it: the clock "
                      "frontier over listed rows",
    "mvr_apply": "no single PyTorch call computes it: a per-row sequential "
                 "frontier join",
    "mvr_capture": "no single PyTorch call computes it: a per-row "
                   "sequential observed-clock capture and frontier join",
}
# the 2P-Set and the 2P2P Graph: the two tombstone layouts of
# slot_union.cu, the applies and captures, and the dangling-edge filter
TP_KERNELS = ("tp_union", "tp_union_rows", "edge_union", "edge_union_rows",
              "tpset_apply", "tpset_capture", "graph_apply", "graph_capture",
              "edge_mask")
# the 2P-Set through SafeKV at BASELINE config 2's cluster shape (16
# nodes, window 8, 5,120-op blocks, a 50/50 add/remove mix) at the
# config's own 10,000 keys of 64 slots over 64 elements
# (workloads.tpset_add_remove); `warmup` rounds off the clock, the timed
# rounds, idle rounds until drained, `profile_rounds` under the profiler;
# the live elements after the rounds of `live_after`
TPSET_CONS = dict(nodes=16, window=8, keys=10000, capacity=64,
                  ops_per_block=5120, elems=64, warmup=2, rounds=24,
                  min_idle=8, max_idle=64, profile_rounds=2, seed=24,
                  live_after=(1, 12, 24))
# the Graph at the same cluster shape: 32 vertex slots over 32 ids, 256
# edge slots over the 256 edges workloads.graph_ops draws (src -> src + 1 +
# j mod 32, j < 8); edge_count of the prospective views after every timed
# round
GRAPH_CONS = dict(nodes=16, window=8, keys=10000, v_capacity=32,
                  e_capacity=256, ops_per_block=5120, vertices=32,
                  out_degree=8, warmup=2, rounds=24, min_idle=8, max_idle=64,
                  profile_rounds=2, seed=25, live_after=(1, 12, 24))
# both types through Store.fused_tick at preset mixed_delta's geometry
# (harness.py:1983-1988): R replicas, K keys, B ops per type per replica
# per tick, Zipf keys in a hot window of budget/2 keys; 2P-Set rows of 256
# slots, Graph rows of 32 vertex and 256 edge slots; a full arm and a delta
# arm at the budget
TP_STORE = dict(R=64, K=500, tp_capacity=256, v_capacity=32, e_capacity=256,
                B=64, budget=64, ticks=24, seed=26, elems=64, vertices=32,
                out_degree=8)
# the 2P wrappers' random checks: unions (edges, lead, Ca, Cb, canonical);
# row-list levels (layout, pairs, K, C); 2P-Set applies (V, K, C, B, mode,
# keys) and Graph applies (V, K, CV, CE, ids, B, mode, keys), keys
# "hazard" in [-2K, 2K), "hot" so and then 90% of the lanes on row 1 (past
# a row's bucket of 32 records; the plain walk takes one wave a lane
# there), or "flat"
# in range (the full-width cases, which the hazards' clamped rows would
# turn into thousands of plain waves); masks
# (lead, CV, CE, ids, share of endpoints at INT32_MAX); recorded: the
# consensus phases' first rounds, tp_store's first ticks and its late_tick
# (its hot window revisits keys from tick 15 on, so edge adds find their
# vertices; at 17 its edge rows carry the most tails); the walk's edge
# cases (workloads.graph_walk_case) at (V, K, ids, B) for each shape
# (kind, CV or C, CE), one a source instantiation, every case in every
# mode but the long walk (over 2,048 lanes on one row, one plain wave a
# lane), which runs captured
TP_CHECKS = dict(
    unions=((False, (3, 5), 6, 6, False), (False, (7,), 8, 8, True),
            (False, (2, 4), 5, 3, False), (False, (16, 1000), 64, 64, False),
            (False, (32, 500), 256, 256, True), (True, (3, 5), 6, 6, False),
            (True, (4,), 3, 2, True), (True, (16, 200), 32, 32, False),
            (True, (32, 500), 256, 256, True)),
    row_levels=(("tp", 2, 40, 16), ("tp", 5, 40, 64), ("edge", 2, 40, 16),
                ("edge", 5, 40, 256)),
    tp_applies=((3, 5, 8, 40, "apply", "hazard"),
                (4, 3, 6, 300, "captured", "hazard"),
                (5, 2, 4, 24, "capture", "hazard"),
                (2, 4, 64, 2300, "capture", "hot"),
                (16, 1000, 64, 5120, "capture", "flat"),
                (16, 1000, 64, 20480, "captured", "flat")),
    graph_applies=((3, 5, 6, 10, 5, 48, "apply", "hazard"),
                   (4, 3, 6, 10, 8, 300, "captured", "hazard"),
                   (5, 2, 4, 6, 5, 24, "capture", "hazard"),
                   (2, 4, 32, 256, 32, 2300, "capture", "hot"),
                   (16, 500, 32, 256, 32, 5120, "capture", "flat"),
                   (16, 500, 32, 256, 32, 20480, "captured", "flat")),
    masks=(((3, 5), 6, 10, 5, 0.0), ((8, 16), 6, 10, 5, 0.2),
           ((7,), 1, 3, 2, 0.3), ((4, 3), 0, 5, 2, 0.0),
           ((16, 500), 32, 256, 32, 0.01)),
    walk_geometry=(2, 500, 32, 2200),
    walks=(("graph", 32, 256), ("graph", 64, 256), ("tpset", 64, 0),
           ("tpset", 256, 0)),
    rounds=3, ticks=2, late_tick=17)
# the 2P unions' edge cases (workloads.tp_union_case), both layouts:
# `rows` key rows of each capacity; row-list trees over these replicas
TP_UNION_EDGE = dict(rows=64, capacities=(32, 256), replicas=(2, 3, 5))
TP_LIBRARY_NOTES = {
    "tp_union": "no single PyTorch call computes it: an elem-keyed union "
                "with a tombstone OR and a capacity cut",
    "tp_union_rows": "no single PyTorch call computes it: an elem-keyed "
                     "union with a tombstone OR over listed rows",
    "edge_union": "no single PyTorch call computes it: a (src, dst)-keyed "
                  "union with a tombstone OR and a capacity cut",
    "edge_union_rows": "no single PyTorch call computes it: a (src, "
                       "dst)-keyed union over listed rows",
    "tpset_apply": "no single PyTorch call computes it: a per-row "
                   "sequential upsert gated on presence",
    "tpset_capture": "no single PyTorch call computes it: a per-row "
                     "sequential upsert recording each remove's presence",
    "graph_apply": "no single PyTorch call computes it: a per-row "
                   "sequential two-block upsert behind three gates",
    "graph_capture": "no single PyTorch call computes it: a per-row "
                     "sequential gated upsert recording each gate",
    "edge_mask": "torch.isin of both endpoints' packed int64 (row, vertex) "
                 "keys in the live vertices' (packing and the AND with the "
                 "live-edge mask not timed)",
}
# the split cluster: one SplitNode a replica process (N = 4 nodes, one
# each), all in this process on the one card over deterministic in-memory
# pipes. PN-Counter at the paper's peak point (BASELINE.md:11-12, 18: 100
# objects, blocks of 1,000, W = 8, half the updates safe); the OR-Set at
# preset orset4's geometry (harness.py:1918-1924). An iteration steps every
# process once; the first cpu_steps iterations of the PN-Counter's
# recorded pass are held against the same cluster on the CPU
SPLIT_PNC = dict(nodes=4, window=8, ops_per_block=1000, keys=100, safe=0.5,
                 warmup=4, steps=32, min_idle=4, max_idle=48, cpu_steps=8,
                 profile_steps=2)
SPLIT_ORSET = dict(nodes=4, window=8, ops_per_block=8192, keys=100,
                   capacity=64, rm=4, budget=8, warmup=4, steps=32,
                   min_idle=4, max_idle=48, profile_steps=2)
# a process whose frames are corrupted in transit (its peers drop it)
SPLIT_TAMPER = dict(nodes=4, window=8, ops_per_block=1000, keys=100,
                    steps=60)
# two processes (two nodes each) over loopback TCP
SPLIT_TCP = dict(nodes=4, window=8, ops_per_block=1000, keys=100, steps=24,
                 min_idle=4, max_idle=48)
SPLIT_KERNELS = ("dag_ingest", "dag_round")
# dag_ingest on random wire batches per (N, W), with payload rows of pnc's
# ring (B = 1,000) and the OR-Set's (B = 8,192, three capture lanes of 4);
# dag_round's split mode on random states
INGEST_CHECKS = dict(shapes=((4, 8), (7, 6), (16, 8), (33, 5), (64, 8)),
                     batches=6, pnc_block=1000, orset_block=8192, rm=4,
                     split_states=4)
# the port's run_tensor at these harness presets, uncut unless a preset's
# ticks are cut here (none is)
HARNESS = dict(presets=("pnc", "orset", "mixed"), cut_ticks={},
               sync_rounds=4, profile_rounds=3)
# run_tensor_adaptive (through harness.run) at these presets, uncut, and
# the light preset again under a latency target below the card's seal
# (a synchronous OR-Set round at 16 nodes takes ~8 ms there, under the
# presets' 50 ms, so the presets' controller never asks for a shrink):
# "light_tight" keeps the trickle of 256 ops a node a tick, "floor_tight"
# offers 32, under the floor's half, so B can settle at the floor
ADAPTIVE = dict(presets=("orset_adaptive", "orset_adaptive_light",
                         "orset_fixed_light"),
                variants={"light_tight": ("orset_adaptive_light",
                                          dict(latency_target_ms=1.0)),
                          "floor_tight": ("orset_adaptive_light",
                                          dict(latency_target_ms=1.0,
                                               offered_per_tick=32))})
# run_tensor at the Fig 11 presets, uncut: the Byzantine pair through the
# integrity plane (nodes 12-15 inject at 0.25 and at 0) and the crash pair
FAULTS = dict(presets=("byzantine", "byzantine0", "pnc8", "crash"),
              injecting=(12, 13, 14, 15))
# ring_resize on random rings (W, N, B, B') of every type's extras, clean
# and with a live tail lane on a shrink, then on the adaptive runs' calls
RING_CHECKS = dict(geometries=((8, 4, 8, 16), (8, 4, 16, 4), (5, 3, 33, 32),
                               (8, 16, 5120, 2560), (8, 16, 64, 704),
                               (4, 3, 13, 6), (4, 3, 6, 13),
                               (8, 16, 5120, 2557)))
# a row-list mode or another slot layout is its kernel's source with
# another entry point
SOURCES = {"replica_join_rows": "replica_join", "slot_union_rows": "slot_union",
           "rga_union": "slot_union", "rga_union_rows": "slot_union",
           "rga_capture": "rga_apply", "lww_union": "slot_union",
           "lww_union_rows": "slot_union", "lww_capture": "lww_apply",
           "mvr_merge_rows": "mvr_merge", "mvr_capture": "mvr_apply",
           "tp_union": "slot_union", "tp_union_rows": "slot_union",
           "edge_union": "slot_union", "edge_union_rows": "slot_union",
           "tpset_apply": "graph_apply", "tpset_capture": "graph_apply",
           "graph_capture": "graph_apply"}
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
    "safekv_submit": "janus_tpu/runtime/safecrdt.py:297",
    "block_select": "janus_tpu/runtime/safecrdt.py:374",
    "state_transfer": "janus_tpu/runtime/safecrdt.py:421",
    "gc_frontier": "janus_tpu/runtime/safecrdt.py:518",
    "orset_compact": "janus_tpu/models/orset.py:538",
    "rga_capture": "janus_tpu/models/base.py:160",
    "mark_members": "janus_tpu/ops/setops.py:237",
    "lww_union": "janus_tpu/models/lwwset.py:140",
    "lww_union_rows": "janus_tpu/runtime/store.py:114",
    "lww_apply": "janus_tpu/models/lwwset.py:93",
    "lww_capture": "janus_tpu/models/lwwset.py:57",
    "mvr_merge": "janus_tpu/models/mvregister.py:143",
    "mvr_merge_rows": "janus_tpu/runtime/store.py:114",
    "mvr_apply": "janus_tpu/models/mvregister.py:100",
    "mvr_capture": "janus_tpu/models/mvregister.py:49",
    "tp_union": "janus_tpu/models/tpset.py:112",
    "tp_union_rows": "janus_tpu/runtime/store.py:114",
    "edge_union": "janus_tpu/models/graph.py:184",
    "edge_union_rows": "janus_tpu/runtime/store.py:114",
    "tpset_apply": "janus_tpu/models/tpset.py:75",
    "tpset_capture": "janus_tpu/models/tpset.py:43",
    "graph_apply": "janus_tpu/models/graph.py:109",
    "graph_capture": "janus_tpu/models/graph.py:76",
    "edge_mask": "janus_tpu/models/graph.py:209",
    "dag_ingest": "janus_tpu/consensus/dag.py:228",
    "ring_resize": "janus_tpu/runtime/safecrdt.py:744",
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


def plain_reps(fn, budget_ms=None):
    """``(calls, ms)``: the calls of ``fn`` that fit ``budget_ms``, between
    1 and 20, from one timed call (which also warms ``fn`` up), and that
    call's milliseconds (a slow plain version is timed over fewer
    calls)."""
    budget_ms = PLAIN_BUDGET_MS if budget_ms is None else budget_ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = 1e3 * (time.perf_counter() - t0)
    return int(max(1, min(20, budget_ms // max(one, 1e-3)))), one


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


def graph_kernels(fn) -> int:
    """CUDA kernels one call of ``fn`` launches: the kernel nodes of a CUDA
    graph captured from the call on a side stream (the driver's stream
    capture, relaxed mode), a count that does not depend on the profiler's
    records. The call runs once on that stream first, outside the capture,
    so that what a wrapper caches per stream exists; the groups' scratch
    of that stream is dropped after the capture (the captured call, which
    did not run, flipped its parity)."""
    import ctypes

    from janus_tpu_torch.kernels import lane_buckets

    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.c_size_t
    cu.cuStreamBeginCapture_v2.argtypes = [ptr, ctypes.c_int]
    cu.cuStreamEndCapture.argtypes = [ptr, ctypes.POINTER(ptr)]
    cu.cuGraphGetNodes.argtypes = [ptr, ctypes.POINTER(ptr),
                                   ctypes.POINTER(size)]
    cu.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphDestroy.argtypes = [ptr]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    raw, graph = ptr(side.cuda_stream), ptr()
    with torch.cuda.stream(side):
        fn()
        side.synchronize()
        # mode 2: CU_STREAM_CAPTURE_MODE_RELAXED
        rc = cu.cuStreamBeginCapture_v2(raw, 2)
        if rc:
            raise RuntimeError(f"graph_kernels: capture refused ({rc})")
        try:
            fn()
        finally:
            rc = cu.cuStreamEndCapture(raw, ctypes.byref(graph))
    for key in [k for k in lane_buckets._SCRATCH if k[2] == side.cuda_stream]:
        lane_buckets.forget_scratch(key)
    if rc:
        raise RuntimeError(f"graph_kernels: capture failed ({rc})")
    try:
        n = size(0)
        cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
        nodes = (ptr * n.value)()
        cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
        kinds = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            cu.cuGraphNodeGetType(node, ctypes.byref(kind))
            kinds.append(kind.value)
    finally:
        cu.cuGraphDestroy(graph)
    return sum(k == 0 for k in kinds)  # CU_GRAPH_NODE_TYPE_KERNEL


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
    from the operand list it passes to ``operands.placement`` or
    ``operands.lean_placement`` (absent optional inputs dropped), and the
    tensors it returns that are none of them. Calls ``fn`` once."""
    lists, depth = [], [0]
    real = {f: getattr(operands, f) for f in ("placement", "lean_placement")}

    def spy(f):
        def call(name, ops):
            if depth[0] == 0:  # not lean_placement's own placement call
                lists.append(list(ops))
                ops = lists[-1]
            depth[0] += 1
            try:
                return real[f](name, ops)
            finally:
                depth[0] -= 1
        return call

    for f in real:
        setattr(operands, f, spy(f))
    try:
        out = fn(*args)
    finally:
        for f, x in real.items():
            setattr(operands, f, x)
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


# a wrapper whose plain version has another name: gc_frontier's call
# with the ring clears it too
PLAIN_NAMES = {"gc_frontier": "gc_round_plain"}


def plain_of(kernels, name):
    return getattr(kernels, PLAIN_NAMES.get(name, f"{name}_plain"))


def clone_aliased(tree):
    """Clones of a nest's tensors, one per distinct tensor, so a tensor
    passed twice (an ``out=`` that is the input: in place) stays one."""
    memo = {}

    def one(x):
        if id(x) not in memo:
            memo[id(x)] = x.clone()
        return memo[id(x)]
    return tree_map(one, tree)


def record_calls(kernels, names, fn, aliased=False, take=None):
    """Run ``fn`` with the inputs of every call of the named wrappers
    (module attributes of ``kernels``, which the consensus and model
    modules call) cloned just before the call (``aliased``: a tensor
    passed twice stays one clone), or with what ``take(name, args,
    kwargs)`` returns just before it; returns ``{name: [(args, kwargs) or
    what take returned, ...]}``."""
    calls = {name: [] for name in names}
    real = {name: getattr(kernels, name) for name in names}
    clone = clone_aliased if aliased else (
        lambda x: tree_map(torch.Tensor.clone, x))

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append(clone((args, kwargs)) if take is None
                               else take(name, args, kwargs))
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


def checking_take(kernels, log, checked, what):
    """``take`` for ``record_calls``: a call of a wrapper named in
    ``checked`` (a dict of counts) is held against its plain version at
    once (``log.add``, on clones) and not kept; any other call is cloned
    and kept."""
    def take(name, args, kwargs):
        if name in checked:
            log.add(kernels, name, args, f"{what} recorded call "
                    f"{checked[name]}", kwargs)
            checked[name] += 1
            return None
        return tree_map(torch.Tensor.clone, (args, kwargs))
    return take


class CaseLog:
    """Per-kernel counts of the checks of the named kernels; ``entries``
    maps a source's second entry point (``SECOND_ENTRIES``) to its
    function, its checks counted on its wrapper."""

    def __init__(self, names, entries=None):
        self.by = {name: {"cases": 0, "max_abs_err": 0} for name in names}
        self.entries = entries or {}
        if "tusk_commit" in self.by:
            self.by["tusk_commit"]["committed_cases"] = 0

    def add(self, kernels, name, args, what, kwargs=None, aliased=False,
            host_plain=False):
        """The kernel against its plain version on clones of one input,
        bit-equal, outputs and drop/overflow counts included (and the
        state a kernel updates in place; ``aliased`` keeps a tensor passed
        twice one clone, so an ``out=`` that is the input stays in place);
        ``host_plain`` runs the plain version on host copies (a walk of
        thousands of small steps is quicker there); returns the kernel's
        output."""
        kwargs = kwargs or {}
        clone = clone_aliased if aliased else (
            lambda x: tree_map(torch.Tensor.clone, x))
        mine = clone((args, kwargs))
        ref = clone((args, kwargs))
        if host_plain:
            dev = tensors_of(args)[0].device
            ref = tree_map(lambda x: x.cpu(), ref)
        fn = self.entries.get(name) or kernels.WRAPPERS[name]
        out = fn(*mine[0], **mine[1])
        want = plain_of(kernels, name)(*ref[0], **ref[1])
        if host_plain:
            ref, want = tree_map(lambda x: x.to(dev), (ref, want))
        torch.cuda.synchronize()
        err = tree_err((mine, out), (ref, want))
        check(err == 0, f"{name} {what}: max_abs_err {err}")
        rec = self.by[SECOND_ENTRIES.get(name, name)]
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


def device_us_by_kernel(events, rounds) -> dict:
    """Device microseconds per round of each kernel name (its first 80
    characters) among profiler ``events``, largest first."""
    by = {}
    for e in events:
        by[e.name[:80]] = by.get(e.name[:80], 0) + e.time_range.elapsed_us()
    return {k: v / rounds for k, v in sorted(by.items(), key=lambda x: -x[1])}


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
    for name, per in ROUND_LAUNCHES.items():  # launches per SafeKV round
        check(launches[name] == per * stepped, f"consensus: {name} launched "
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

    # the functional phases of a round, each alone on a copy of the state
    cfg = kv.cfg
    carry = tree_map(torch.Tensor.clone, kv._carry())
    by_phase = {
        "state_transfer": cuda_kernels_of(lambda: kv._state_transfer(
            *carry[:4], *carry[6:9])),
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
    A run and a path B run; (e) the capture's edge cases
    (``workloads.orset_capture_case``) at ``CAPTURE_CASE_GEOS``; (f) the
    union's edge cases (``orset_edge_cases``), slot_union_rows among them.
    Counts the share of the capture's buckets already in tag order
    (``buckets_sorted``: path A's recorded calls, the hot key, the edge
    cases at path A's shape) and of level-1 union input rows already in
    tag order (``rows_sorted``: path B's recorded ticks). Returns, per
    kernel, the (args, kwargs) of the recorded call the kernels line
    times."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.kernels.orset_capture import MAX_BUCKETS
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.engine import make_tick
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.runtime.store import replicated_init
    from janus_tpu_torch.utils.ids import TagMinter

    log = CaseLog(ORSET_KERNELS + ("slot_union_rows",))
    rng = np.random.default_rng(9)
    buckets = {}  # what -> [in order, buckets]

    def count_buckets(what, st, ops):
        got, n = buckets_sorted(ops, st["valid"].shape[1], MAX_BUCKETS)
        acc = buckets.setdefault(what, [0, 0])
        acc[0] += got
        acc[1] += n

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
    count_buckets("hot_key", st, ops)
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
    level1 = [0, 0, 0]  # path B's level-1 input rows in order, rows, calls
    for path, fn, names in (("A", path_a, ("orset_capture", "orset_replay")),
                            ("B", path_b, ("orset_apply", "slot_union"))):
        calls = record_calls(kernels, names, fn)
        torch.cuda.synchronize()
        for name in names:
            check(calls[name], f"recorded path {path}: no {name} call")
            for j, (args, kw) in enumerate(calls[name]):
                log.add(kernels, name, args, f"recorded path {path}", kw)
                if name == "orset_capture":
                    count_buckets("recorded_path_a", args[0], args[1])
                if name == "slot_union" and args[0]["valid"].shape[0] == R // 2:
                    for x in args[:2]:
                        got, rows_ = rows_sorted(x, keys=ORSET_KEYS)
                        level1[0] += got
                        level1[1] += rows_
                    level1[2] += 1
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
    check(level1[2] > 0, "recorded path B: no level-1 slot_union call")
    # (d') every replay and GC advance of harness preset orset, cut to
    # HARNESS_CHECK_TICKS ticks (the harness_tensor phase's SafeKV calls),
    # each checked at once; the last advance is kept for the kernels line
    import dataclasses

    from janus_tpu_torch.bench import harness
    checked = {"orset_replay": 0, "orset_compact_fences": 0}
    fence_log = CaseLog(("orset_compact",), {
        "orset_compact_fences": kernels.orset_compact_fences})
    replays = checking_take(kernels, log, checked, "harness orset")

    def take(name, args, kwargs):
        if name == "orset_replay":
            return replays(name, args, kwargs)
        fence_log.add(kernels, name, args, f"harness orset recorded advance "
                      f"{checked[name]}", kwargs, aliased=True)
        checked[name] += 1
        timing[name] = clone_aliased((args, kwargs))
        return None

    record_calls(kernels, tuple(checked), lambda: harness.run_tensor(
        dataclasses.replace(harness.PRESETS["orset"],
                            ticks=HARNESS_CHECK_TICKS), device=dev),
        take=take)
    torch.cuda.synchronize()
    check(min(checked.values()) > 0,
          f"harness orset: calls checked {checked}, none of one wrapper")
    cases.append({"kernel": "orset_compact", "case": "orset_kernels",
                  **fence_log.by["orset_compact"]})

    # (e) the capture's edge cases
    for case in workloads.ORSET_CAPTURE_CASES:
        for v, k_, c_, b_, r_ in CAPTURE_CASE_GEOS:
            st, ops = (on_dev(x) for x in workloads.orset_capture_case(
                rng, case, (v, b_), k_, c_))
            log.add(kernels, "orset_capture", (st, ops, r_),
                    f"edge {case} V{v} K{k_} C{c_} B{b_} r{r_}")
            if (v, k_, c_, b_, r_) == CAPTURE_CASE_GEOS[0]:
                count_buckets(f"edge_{case}", st, ops)
    # (f) the union's edge cases
    orset_edge_cases(dev, kernels, workloads, log, rng)
    # (g) the replay's edge cases (workloads.orset_replay_case)
    for case in workloads.ORSET_REPLAY_CASES:
        for v, k_, c_, b_, r_ in REPLAY_CASE_GEOS:
            st, ops = (on_dev(x) for x in workloads.orset_replay_case(
                rng, case, (v, b_), k_, c_, r_))
            log.add(kernels, "orset_replay", (st, ops),
                    f"edge {case} V{v} K{k_} C{c_} B{b_} r{r_}")

    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "orset_kernels",
                      "cases": rec["cases"], "max_abs_err": rec["max_abs_err"]})
    emit("orset_kernels", by_kernel=log.by,
         capture_buckets_sorted={
             what: {"sorted": v[0], "buckets": v[1], "share": v[0] / v[1]}
             for what, v in buckets.items()},
         level1_rows_sorted={"sorted": level1[0], "rows": level1[1],
                             "calls": level1[2],
                             "share": level1[0] / level1[1]})
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
    # level 1 of the OR-Set's tree gathers the listed rows from the state:
    # those rows already in tag order
    level1 = [0, 0, 0]
    for args, kw in calls["slot_union_rows"]:
        if kw.get("gather", True):
            listed = args[3][:int(args[4])].long()
            for x in args[:2]:
                got, n_ = rows_sorted(x, listed, keys=ORSET_KEYS)
                level1[0] += got
                level1[1] += n_
            level1[2] += 1
    check(level1[1] > 0, "recorded store_delta: no listed level-1 row")
    timing = {name: recorded[-1] for name, recorded in calls.items()}
    # the first level of the OR-Set's tree: it gathers from the state
    timing["slot_union_rows"] = calls["slot_union_rows"][0]
    del calls
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "delta_kernels",
                      "cases": rec["cases"], "max_abs_err": rec["max_abs_err"]})
    emit("delta_kernels", by_kernel=log.by, selections=counts,
         slot_union_rows_tree_cases=tree_cases,
         level1_rows_sorted={"sorted": level1[0], "rows": level1[1],
                             "calls": level1[2],
                             "share": level1[0] / level1[1]})
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


def check_calls(kernels, log, names, fn, what, keep=None, score=None,
                aliased=False, skip=None):
    """Run ``fn`` with every call of the named wrappers (module attributes
    of ``kernels``, which the model calls) first held against its plain
    version on clones of its inputs (``log.add``; ``aliased`` as there;
    ``what`` a string, or a function of the name and the call's index
    returning one); ``keep`` (a dict) gets the (args, kwargs) of each
    name's first call, cloned, for timing, or with ``score`` (a function
    of the name and the args) of its first call of the highest score.
    While ``skip()`` (a function of nothing) is true, calls go straight to
    the wrappers, unchecked and uncounted. Returns the count of calls per
    name."""
    real = {name: getattr(kernels, name) for name in names}
    counts = dict.fromkeys(names, 0)
    best = {}
    clone = clone_aliased if aliased else (
        lambda x: tree_map(torch.Tensor.clone, x))

    def checked(name):
        def call(*args, **kw):
            if skip is not None and skip():
                return real[name](*args, **kw)
            log.add(kernels, name, args,
                    what(name, counts[name]) if callable(what) else what, kw,
                    aliased=aliased)
            counts[name] += 1
            if keep is not None:
                value = 0 if score is None else score(name, args)
                if name not in keep or value > best[name]:
                    best[name], keep[name] = value, clone((args, kw))
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(kernels, name, checked(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(kernels, name, real[name])
    return counts


def row_order(slots, rows=None, keys=("id_ctr", "id_rep")):
    """(rows already sorted, rows, tail lengths of the others) of a slot
    set ``[..., C]`` (or of its key rows ``rows`` of ``[P, K, C]``): a row
    is sorted when its key fields ``keys`` (one or two: the RGA's ids; the
    OR-Set's tags, ``ORSET_KEYS``; a 2P row's elem; an edge's src, dst),
    SENTINEL for an invalid slot, never descend as signed int32, the test
    csrc/slot_union.cu's merge makes before it puts a row in order; an
    unsorted row's tail is its valid records from its first descent to
    its last valid slot (an int64 tensor, one entry an unsorted row).
    Counted by torch on the card, apart from the kernel."""
    sent = torch.iinfo(torch.int32).max
    valid = slots["valid"]
    ks = [torch.where(valid, slots[k], sent) for k in keys]
    if rows is not None:
        ks, valid = [x[:, rows] for x in ks], valid[:, rows]
    down = torch.zeros_like(valid[..., 1:])
    tie = torch.ones_like(down)
    for x in ks:
        down |= tie & (x[..., 1:] < x[..., :-1])
        tie &= x[..., 1:] == x[..., :-1]
    unsorted = down.any(-1)
    # the first descent (a True after the last pair keeps C = 1 rows)
    first = torch.cat([down, torch.ones_like(valid[..., :1])], -1).int()
    first = first.argmax(-1) + 1
    at = torch.arange(valid.shape[-1], device=valid.device)
    tail = (valid & (at >= first.unsqueeze(-1))).sum(-1)
    return int((~unsorted).sum()), ks[0][..., 0].numel(), tail[unsorted]


def rows_sorted(slots, rows=None, keys=("id_ctr", "id_rep")):
    """(rows already sorted, rows) of ``row_order``."""
    got, n, _ = row_order(slots, rows, keys)
    return got, n


# the bounds of the tail-length histogram of ``tail_counts``
TAIL_BINS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def tail_counts(tails) -> dict:
    """Counts of unsorted rows by tail length (``row_order``'s tails, a
    list of tensors): rows with a tail of at most each bound of
    ``TAIL_BINS`` and above the one before, more than the last, and the
    longest."""
    t = torch.cat(tails) if tails else torch.zeros(0, dtype=torch.long)
    out, lo = {}, 0
    for hi in TAIL_BINS:
        out[f"{lo + 1}-{hi}" if hi > lo + 1 else str(hi)] = int(
            ((t > lo) & (t <= hi)).sum())
        lo = hi
    out[f">{lo}"] = int((t > lo).sum())
    out["longest"] = int(t.max()) if t.numel() else 0
    return out


def record_level1(level1, key, name, args, keys):
    """Add the two input rows of a call of union wrapper ``name`` (its
    ``args``; a row-list call's listed rows only) to ``level1[key]``,
    ``[rows in key order, rows, rows holding a valid record, tails]`` of
    ``row_order`` on the key fields ``keys``."""
    listed = (args[3][:int(args[4])].long() if name.endswith("_rows")
              else None)
    rec = level1.setdefault(key, [0, 0, 0, []])
    for x in args[:2]:
        got, n, tails = row_order(x, listed, keys)
        held = x["valid"] if listed is None else x["valid"][:, listed]
        rec[0] += got
        rec[1] += n
        rec[2] += int(held.any(-1).sum())
        rec[3].append(tails.cpu())


def level1_report(level1) -> dict:
    """``record_level1``'s records as a phase line reports them."""
    return {key: {"sorted": got, "rows": n, "share": got / n,
                  "rows_holding_a_record": held, "tails": tail_counts(tails)}
            for key, (got, n, held, tails) in sorted(level1.items())}


ORSET_KEYS = ("tag_rep", "tag_ctr")


def buckets_sorted(ops, num_keys, max_buckets):
    """(buckets in tag order, buckets with an add) of one orset_capture
    call's op lanes ``[V, B]``: each view's valid adds (op 1, a1 not
    SENTINEL) bucketed by the row their key gathers modulo ``min(K,
    max_buckets)``, in lane order, as csrc/orset_capture.cu buckets them; a
    bucket is in order when its (a1, a2) never descend, the test the
    kernel makes before it sorts a bucket. Counted by torch on the card,
    apart from the kernel."""
    from janus_tpu_torch.models.base import gather_index

    V, B = ops["op"].shape
    nb = min(num_keys, max_buckets)
    add = (ops["op"] == 1) & (ops["a1"] != torch.iinfo(torch.int32).max)
    lane = torch.arange(B, device=add.device).expand(V, B)
    view = torch.arange(V, device=add.device).view(V, 1).expand(V, B)
    bucket = view * nb + gather_index(ops["key"], num_keys) % nb
    order = torch.argsort((bucket * B + lane)[add])
    bk = bucket[add][order]
    a1, a2 = ops["a1"][add][order], ops["a2"][add][order]
    down = (bk[1:] == bk[:-1]) & ((a1[1:] < a1[:-1])
                                  | ((a1[1:] == a1[:-1]) & (a2[1:] < a2[:-1])))
    total = int(torch.unique(bk).numel())
    return total - int(torch.unique(bk[1:][down]).numel()), total


def orset_edge_cases(dev, kernels, workloads, log, rng):
    """The OR-Set union's edge cases (``workloads.orset_union_case``) at
    ``ORSET_UNION_EDGE``'s rows, kernel against plain: fresh at a capacity
    below, at and above one row's, into two planes (the broadcast),
    aliased (``out`` the first input, as the converge's last level writes
    into the replicas it read), with rows of unequal widths, and the
    row-list tree over states of 2, 3 and 5 replicas with 0, 1 and all
    rows listed (at 2 its one level writes the rows it read)."""
    from janus_tpu_torch.models import orset

    k, c = ORSET_UNION_EDGE["rows"], ORSET_UNION_EDGE["capacity"]
    for case in workloads.ORSET_UNION_CASES:
        a, b = ({f: torch.as_tensor(x, device=dev) for f, x in t.items()}
                for t in workloads.orset_union_case(rng, case, (2, k), c))
        what = f"edge {case} 2x{k} C{c}"
        for cap in (c // 2, c, 3 * c):
            log.add(kernels, "slot_union", (a, b, cap), f"{what} cap {cap}")
        out = {f: torch.zeros((2, 2, k, c), dtype=x.dtype, device=dev)
               for f, x in a.items()}
        log.add(kernels, "slot_union", (a, b, c), what + " out", {"out": out})
        narrow = {f: x[..., : c // 3].contiguous() for f, x in b.items()}
        log.add(kernels, "slot_union", (a, narrow, c), what + " narrow b")
        mine = tree_map(torch.Tensor.clone, a)
        kernels.slot_union(mine, b, c, out={f: x.unsqueeze(0)
                                            for f, x in mine.items()})
        ref, _ = kernels.slot_union_plain(a, b, c)
        torch.cuda.synchronize()
        err = tree_err(mine, ref)
        check(err == 0, f"slot_union {what} aliased: max_abs_err {err}")
        log.by["slot_union"]["cases"] += 1
        for r in ORSET_UNION_EDGE["replicas"]:
            more = workloads.orset_union_case(rng, case, (2, k), c)
            reps = [{f: x[i] for f, x in t.items()}
                    for t in ((a, b) + tuple(
                        {f: torch.as_tensor(x, device=dev)
                         for f, x in m.items()} for m in more))
                    for i in range(2)]
            st = {f: torch.stack([x[f] for x in reps[:r]])
                  for f in orset.ORSET.fields}
            st["_rm_cap"] = torch.zeros((r, 4, 0), dtype=torch.int32,
                                        device=dev)
            rows = torch.as_tensor(rng.permutation(k).astype(np.int32),
                                   device=dev)
            for n_rows in (0, 1, k):
                n = torch.tensor(n_rows, dtype=torch.int32, device=dev)
                check_calls(kernels, log, ("slot_union_rows",),
                            lambda: orset.join_replica_rows(st, rows, n),
                            f"{what} rows R{r} n{n_rows}")


def rga_edge_cases(dev, kernels, workloads, log, rng, k, c):
    """The union's edge cases (``workloads.rga_union_case``) at ``k``
    document rows of ``c`` slots, kernel against plain: fresh, into two
    planes, aliased (``out`` the first input, as the converge's last level
    writes into the replicas it read), and the row-list tree over states
    of 2 and 3 replicas with 0, 1 and k rows listed."""
    from janus_tpu_torch.models import rga

    for case in workloads.RGA_UNION_CASES:
        a, b = ({f: torch.as_tensor(x, device=dev) for f, x in t.items()}
                for t in workloads.rga_union_case(rng, case, (2, k), c))
        what = f"edge {case} 2x{k} C{c}"
        log.add(kernels, "rga_union", (a, b, c), what)
        out = {f: torch.zeros((2, 2, k, c), dtype=x.dtype, device=dev)
               for f, x in a.items()}
        log.add(kernels, "rga_union", (a, b, c), what + " out", {"out": out})
        mine = tree_map(torch.Tensor.clone, a)
        kernels.rga_union(mine, b, c, out={f: x.unsqueeze(0)
                                           for f, x in mine.items()})
        ref, _ = kernels.rga_union_plain(a, b, c)
        torch.cuda.synchronize()
        err = tree_err(mine, ref)
        check(err == 0, f"rga_union {what} aliased: max_abs_err {err}")
        log.by["rga_union"]["cases"] += 1
        for r in (2, 3):
            reps = [{f: x[0] for f, x in a.items()},
                    {f: x[0] for f, x in b.items()},
                    {f: x[1] for f, x in a.items()}][:r]
            st = {f: torch.stack([x[f] for x in reps]) for f in rga.FIELDS}
            st["ctr_floor"] = torch.zeros((r, k), dtype=torch.int32,
                                          device=dev)
            st["_depth"] = torch.zeros((r, 8, 0), dtype=torch.int32,
                                       device=dev)
            rows = torch.as_tensor(rng.permutation(k).astype(np.int32),
                                   device=dev)
            for n_rows in (0, 1, k):
                n = torch.tensor(n_rows, dtype=torch.int32, device=dev)
                check_calls(kernels, log, ("rga_union_rows",),
                            lambda: rga.join_replica_rows(st, rows, n),
                            f"{what} rows R{r} n{n_rows}")


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
    against their plain versions too, and the share of level-1 union input
    rows already sorted is counted (``rows_sorted``), and so is the share
    of the compactions' input rows; (e) the union's edge cases at the
    preset's rows (``rga_edge_cases``); (f) the compaction's edge cases
    (``workloads.rga_compact_case``) at 2 x 128 rows of the preset's
    1,024 slots and at 16 rows of 300, with and without protect, fresh
    and in place. Returns, per kernel, the (args, kwargs)
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
    # level 1 of each converge below (a full one reads R / 2 replica
    # pairs; a row-list one gathers from the state): rows already sorted
    level1 = {"full": [0, 0, 0], "delta": [0, 0, 0]}  # sorted, rows, calls
    real = (kernels.rga_union, kernels.rga_union_rows)

    def count(kind, *slots, rows=None):
        for x in slots:
            got, n = rows_sorted(x, rows)
            level1[kind][0] += got
            level1[kind][1] += n
        level1[kind][2] += 1

    def union_spy(a, b, *args, **kw):
        if a["valid"].dim() == 3 and a["valid"].shape[0] == R // 2:
            count("full", a, b)
        return real[0](a, b, *args, **kw)

    def rows_spy(a, b, out, rows, n_rows, gather=True, scatter=False):
        if gather:
            count("delta", a, b, rows=rows[:int(n_rows)].long())
        return real[1](a, b, out, rows, n_rows, gather, scatter)

    compact_sorted = [0, 0]  # compaction input rows already sorted, rows

    def compact_spy(rows, *args, **kw):
        got, n = rows_sorted(rows)
        compact_sorted[0] += got
        compact_sorted[1] += n
        return real[2](rows, *args, **kw)

    real = real + (kernels.rga_compact,)
    kernels.rga_union, kernels.rga_union_rows = union_spy, rows_spy
    kernels.rga_compact = compact_spy
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
    kernels.rga_union, kernels.rga_union_rows, kernels.rga_compact = real
    del st
    check(all(v[2] > 0 for v in level1.values()) and compact_sorted[1] > 0,
          f"rga_kernels: level-1 calls {level1}, compaction rows "
          f"{compact_sorted}")
    # (e) the union's edge cases at the preset's rows
    rga_edge_cases(dev, kernels, workloads, log, rng, K, cap)
    # (f) the compaction's edge cases at the preset's rows and at C = 300
    for case in workloads.RGA_COMPACT_CASES:
        for lead, c in (((2, K), cap), ((16,), 300)):
            rows, prot = workloads.rga_compact_case(rng, case, lead, c)
            rows = {f: torch.as_tensor(x, device=dev) for f, x in rows.items()}
            prot = torch.as_tensor(prot, device=dev)
            for p_ in (None, prot):
                what = (f"edge {case} {'x'.join(map(str, lead))} C{c} "
                        f"protect {p_ is not None}")
                log.add(kernels, "rga_compact", (rows, p_), what)
                log.add(kernels, "rga_compact", (rows, p_), what + " in place",
                        {"out": rows}, aliased=True)
    for name, rec in log.by.items():
        check(rec["cases"] > 0, f"rga_kernels: no case of {name}")
        cases.append({"kernel": name, "case": "rga_kernels",
                      "cases": rec["cases"], "max_abs_err": rec["max_abs_err"]})
    emit("rga_kernels", by_kernel=log.by, level1_rows_sorted={
        kind: {"sorted": v[0], "rows": v[1], "calls": v[2],
               "share": v[0] / v[1]} for kind, v in level1.items()},
        compact_rows_sorted={"sorted": compact_sorted[0],
                             "rows": compact_sorted[1],
                             "share": compact_sorted[0] / compact_sorted[1]})
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


def rga_walk_stats(state, ops) -> dict:
    """How one ``rga_apply`` call's lanes fall on its ``(view, row)``
    groups (the row each lane's key gathers): the lanes, the live ones
    (insert or delete), the in-range others (whose only effect is the
    floor's clamp at 0), the groups any lane gathers and those a live one
    does, the live lanes a live group holds (mean, and how many groups
    hold up to 8, 16, ... lanes), and the longest walk: the most lanes one
    group gathers (every code) and the most live ones."""
    from janus_tpu_torch.models.base import gather_index, scatter_index

    K = state["valid"].shape[1]
    op, key = ops["op"], ops["key"]
    V, B = op.shape
    live = (op == 1) | (op == 2)
    _, in_range = scatter_index(key, K)
    vg = (torch.arange(V, device=key.device).view(V, 1) * K
          + gather_index(key, K)).long()
    every = torch.bincount(vg.flatten(), minlength=V * K)
    walked = torch.bincount(vg[live], minlength=V * K)
    held = walked[walked > 0]
    bins, lo = {}, 0
    for top in (8, 16, 32, 64, 128, 256, 1024, max(B, 1025)):
        n = int(((held > lo) & (held <= top)).sum())
        if n:
            bins[f"{lo + 1}-{top}"] = n
        lo = top
    return dict(lanes=V * B, live=int(live.sum()),
                nonlive_in_range=int((~live & in_range).sum()),
                groups=V * K, groups_gathered=int((every > 0).sum()),
                groups_live=int(held.numel()),
                live_per_group_mean=(float(held.float().mean())
                                     if held.numel() else 0.0),
                live_per_group_bins=bins,
                longest_walk_every_lane=int(every.max()),
                longest_walk_live=int(walked.max()))


def group_bins(held) -> dict:
    """How many groups hold up to 8, 16, ... records (``held``: the
    counts of the groups that hold any)."""
    bins, lo = {}, 0
    top_all = int(held.max()) if held.numel() else 0
    for top in (8, 16, 32, 64, 128, 256, 1024, max(top_all, 1025)):
        n = int(((held > lo) & (held <= top)).sum())
        if n:
            bins[f"{lo + 1}-{top}"] = n
        lo = top
    return bins


def replay_walk_stats(state, ops, cap=None) -> dict:
    """How one ``orset_replay`` call's op records fall on its ``(view,
    row)`` groups: the lanes, the op records (an add's one at capture
    lane 0, a remove's or clear's captured tags that are not SENTINEL) on
    rows in range, on negative keys (lost, their drops counted) and past
    the rows (ignored), the groups that hold records, the records a
    group holds (mean, bins, the longest), the groups past a bucket of
    ``cap`` records (the kernel's own, ``orset_replay.bucket_records``,
    by default), and the state rows whose valid slots are not a prefix
    in strictly ascending tag order (non-canonical: among all rows and
    among the rows that records reach)."""
    from janus_tpu_torch.kernels.orset_replay import bucket_records

    V, K, C = state["valid"].shape
    op, key = ops["op"], ops["key"].long()
    B = op.shape[1]
    cap = bucket_records(K, B) if cap is None else cap
    R = ops["rm_rep"].shape[-1]
    SENT = torch.iinfo(torch.int32).max
    per_lane = torch.where(
        op == 1, torch.full_like(op, int(R > 0)),
        torch.where((op == 2) | (op == 3),
                    (ops["rm_rep"] != SENT).sum(-1).to(op.dtype),
                    torch.zeros_like(op)))
    in_rows = (key >= 0) & (key < K)
    vg = (torch.arange(V, device=key.device).view(V, 1) * K
          + key.clamp(0, K - 1))
    held_all = torch.zeros(V * K, dtype=torch.long, device=key.device)
    held_all.index_add_(0, vg[in_rows], per_lane[in_rows].long())
    held = held_all[held_all > 0]
    v = state["valid"]
    tag = state["tag_rep"].long() * 2**32 + state["tag_ctr"].long()
    bad = ((v[..., 1:] & ~v[..., :-1]).any(-1)
           | (v[..., 1:] & v[..., :-1] & (tag[..., 1:] <= tag[..., :-1]))
           .any(-1)).flatten()
    touched = held_all > 0
    out = dict(V=V, K=K, C=C, B=B, R=R, lanes=V * B,
               records=int(per_lane.sum()),
               records_in_rows=int(held_all.sum()),
               records_negative=int(per_lane[key < 0].sum()),
               records_past_rows=int(per_lane[key >= K].sum()),
               groups=V * K, groups_with_records=int(held.numel()),
               records_per_group_mean=(float(held.float().mean())
                                       if held.numel() else 0.0),
               records_per_group_bins=group_bins(held),
               longest_group=int(held.max()) if held.numel() else 0,
               rows_noncanonical=int(bad.sum()),
               touched_rows_noncanonical=int((bad & touched).sum()))
    out["bucket_records"] = cap
    out["groups_overflowed"] = int((held > cap).sum())
    return out


def lww_walk_stats(state, ops, cap=None) -> dict:
    """How one ``lww_apply`` / ``lww_capture`` call's live lanes (add or
    remove) fall on the ``(view, row)`` groups their keys gather: the
    lanes, the live ones, the groups that hold any, the lanes a group
    holds (mean, bins, the longest walk), and the groups past a bucket
    of ``cap`` records (the kernel's own, ``lww_apply.bucket_records``,
    by default)."""
    from janus_tpu_torch.kernels.lww_apply import bucket_records
    from janus_tpu_torch.models.base import gather_index

    V, K, C = state["valid"].shape
    op = ops["op"]
    B = op.shape[1]
    cap = bucket_records(K, B) if cap is None else cap
    live = (op == 1) | (op == 2)
    vg = (torch.arange(V, device=op.device).view(V, 1) * K
          + gather_index(ops["key"], K)).long()
    walked = torch.bincount(vg[live], minlength=V * K)
    held = walked[walked > 0]
    out = dict(V=V, K=K, C=C, B=B, lanes=V * B, live=int(live.sum()),
               captured="ok" in ops, groups=V * K,
               groups_live=int(held.numel()),
               live_per_group_mean=(float(held.float().mean())
                                    if held.numel() else 0.0),
               live_per_group_bins=group_bins(held),
               longest_walk=int(walked.max()) if walked.numel() else 0)
    out["bucket_records"] = cap
    out["groups_overflowed"] = int((held > cap).sum())
    return out


def apply_walk_stats(state, ops, cap=None) -> dict:
    """How one ``orset_apply`` call's lanes fall on the ``(replica,
    row)`` groups their keys gather: the lanes, the NOOP ones, those whose
    key is out of range, the lanes the walk takes (an in-range key, or an
    add, remove or clear, which may count a drop on its clamped row), the
    groups that hold any, the lanes a group holds (mean, bins, the
    longest), the groups past a bucket of ``cap`` records
    (``lane_buckets.bucket_records`` by default), and the gathered rows
    whose slots descend in (tag, position) order (non-canonical, invalid
    slots keyed SENTINEL)."""
    from janus_tpu_torch.kernels.lane_buckets import bucket_records
    from janus_tpu_torch.models.base import gather_index

    R, K, C = state["valid"].shape
    op, key = ops["op"], ops["key"].long()
    B = op.shape[1]
    cap = bucket_records(K, B) if cap is None else cap
    nk = torch.where(key < 0, key + K, key)
    in_range = (nk >= 0) & (nk < K)
    walked = in_range | (op == 1) | (op == 2) | (op == 3)
    vg = (torch.arange(R, device=op.device).view(R, 1) * K
          + gather_index(ops["key"], K)).long()
    per = torch.bincount(vg[walked], minlength=R * K)
    held = per[per > 0]
    SENT = torch.iinfo(torch.int32).max
    v = state["valid"]
    rep = torch.where(v, state["tag_rep"], SENT).long()
    ctr = torch.where(v, state["tag_ctr"], SENT).long()
    tag = rep * 2**32 + ctr
    bad = (tag[..., 1:] < tag[..., :-1]).any(-1).flatten()
    out = dict(R=R, K=K, C=C, B=B, lanes=R * B, noop=int((op == 0).sum()),
               out_of_range=int((~in_range).sum()), live=int(walked.sum()),
               groups=R * K, groups_live=int(held.numel()),
               live_per_group_mean=(float(held.float().mean())
                                    if held.numel() else 0.0),
               live_per_group_bins=group_bins(held),
               longest_group=int(held.max()) if held.numel() else 0,
               gathered_rows_noncanonical=int((bad & (per > 0)).sum()),
               rows_noncanonical=int(bad.sum()))
    out["bucket_records"] = cap
    out["groups_overflowed"] = int((held > cap).sum())
    return out


def rga_apply_bytes(state, ops):
    """What an ``rga_apply`` call must move: its six op fields, its drop
    counts, and the rows its lanes gather and write back (22 bytes a slot,
    4 of floor). Returns ``(bytes, operations, rows read, rows
    written)``."""
    r, k, c = state["valid"].shape
    b = ops["op"].shape[1]
    read, written = rga_rows_touched(state, ops)
    return (4 * 6 * r * b + 4 * r + (22 * c + 4) * (read + written),
            7 * c * read, read, written)


def rga_consensus_entry(kernels, call, walk):
    """``rga_apply`` on a recorded rga_consensus delta apply (the first
    with the median live count among the fence check's rounds), in place, timed
    as the kernels line times a row, with its bytes by the same rule as
    the replay's (``rga_apply_bytes``) and its lanes a group (and
    ``plain_host_ms``, the plain version on host copies of that call in
    ``fence_kernel_checks``, its check's time: on the card the plain
    version syncs once a lane, ~56 s a call)."""
    (state, ops), kw = call
    r, k, c = state["valid"].shape
    b = ops["op"].shape[1]
    nbytes, nops, read, written = rga_apply_bytes(state, ops)
    return {
        "shape": f"a recorded rga_consensus delta apply: V{r} K{k} C{c} "
                 f"B{b}, captured", **walk,
        "rows_read": read, "rows_written": written,
        "ms": time_cuda(lambda: kernels.rga_apply(state, ops, **kw)),
        "device_ms": device_burst_ms(
            lambda: kernels.rga_apply(state, ops, **kw)),
        "bytes": nbytes, "operations": nops,
        "bound_ms": max(1e3 * nbytes / HBM_BYTES_PER_S,
                        1e3 * nops / INT32_OPS_PER_S)}


def rga_kernel_rows(kernels, calls, consensus=None):
    """The kernels line's entries of the five RGA wrappers, on the calls
    ``rga_kernel_checks`` kept from the preset (``rga_apply`` also on
    ``consensus``, a recorded rga_consensus delta apply and its walk
    statistics, as its ``consensus`` entry), with what each must move
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
    nbytes, nops, read, written = rga_apply_bytes(state, ops)
    rows.append(dict(
        name="rga_apply", args=(state, ops), kw=kw,
        shape=f"the preset's apply at tick 3: R{r} K{k} C{c} B{b}",
        rows_read=read, rows_written=written, bytes=nbytes,
        operations=nops))
    if consensus is not None:
        rows[-1]["consensus"] = rga_consensus_entry(kernels, *consensus)
    (slots, prot), kw = calls["rga_compact"]
    shape = tuple(slots["valid"].shape)
    n = int(np.prod(shape[:-1]))
    c = shape[-1]
    got, _ = rows_sorted(slots)
    rows.append(dict(
        name="rga_compact", args=(slots, prot), kw=kw,
        shape=f"the preset's compaction at tick 3: {' x '.join(map(str, shape))}"
              f", in place",
        rows_sorted={"sorted": got, "rows": n},
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
    advances = kv.stats["compactions"] - stats0["compactions"]
    expect = {"orset_capture": stepped, "orset_replay": 3 * stepped,
              "orset_compact": advances,
              **{name: per * stepped for name, per in ROUND_LAUNCHES.items()}}
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
    # each phase alone on its own copy of the state (the phases update it
    # in place)
    carry = [tree_map(torch.Tensor.clone, kv._carry()) for _ in range(3)]
    applied_none = torch.zeros((n, w, n), dtype=torch.bool, device=dev)
    by_phase = {
        "submit": cuda_kernels_of(lambda: kv._submit_device(
            carry[0][0], carry[0][2], *carry[0][4:7], extra[0])),
        "state_transfer": cuda_kernels_of(lambda: kv._state_transfer(
            *carry[1][:4], *carry[1][6:9])),
        "round_step": cuda_kernels_of(lambda: dagmod.round_step(cfg, kv.dag)),
        "causal_closure": cuda_kernels_of(
            lambda: kv._causal_closure(kv.dag, kv.prosp_applied)),
        "commit_view": cuda_kernels_of(lambda: tusk.commit_view(
            cfg, kv.dag, kv.commit, seed=kv.seed, steps=COMMIT_STEPS)),
        "delta_apply_x2": 2 * cuda_kernels_of(lambda: kv._delta_apply(
            carry[2][1], carry[2][4], everything, applied_none,
            kv.commit["slot_round"], kv.dag["base_round"], order)),
        "compaction_at_gc": cuda_kernels_of(lambda: kv._compact_device(
            kv.prospective, kv.stable, kv.ops_buffer)),
    }
    fence_graph = graph_kernels(lambda: kv._compact_device(
        kv.prospective, kv.stable, kv.ops_buffer))
    check(fence_graph == 2, f"orset_consensus: a GC advance's compaction "
          f"is {fence_graph} CUDA kernels (a captured graph), expected 2")
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
         profiled_device_us_per_round=dev_us,
         device_us_per_round_by_kernel=device_us_by_kernel(dev_events,
                                                           len(extra)),
         cuda_kernels_by_phase=by_phase,
         compaction_launches_per_gc_advance=by_phase["compaction_at_gc"],
         compaction_graph_kernels_per_gc_advance=fence_graph,
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
    listed = args[3][:m].long()
    got = [rows_sorted(x, listed, keys=ORSET_KEYS) for x in args[:2]]
    rows.append(dict(
        name="slot_union_rows", args=args, kw=kw, library=None,
        library_note="no single PyTorch call computes it: a tag-keyed union "
                     "with a tombstone fold and a capacity cut",
        shape=f"first level of the OR-Set's tree: {pairs} x {m} rows, "
              f"{c} + {c} slots",
        bytes=3 * pairs * m * row_bytes + 4 * m + 4,
        operations=2 * pairs * m * c * len(a), rows_joined=m,
        rows_sorted={"sorted": sum(x[0] for x in got),
                     "rows": sum(x[1] for x in got)}))
    for row in rows:
        fn = kernels.WRAPPERS[row["name"]]
        a_, k_ = row.pop("args"), row.pop("kw")
        row["call"] = lambda fn=fn, a_=a_, k_=k_: fn(*a_, **k_)
        row["plain"] = (lambda name=row["name"], a_=a_, k_=k_:
                        plain_of(kernels, name)(*a_, **k_))
    return rows


def safekv_recorded_runs(dev, workloads, rng):
    """The SafeKV runs whose calls ``safekv_kernel_checks`` records, as
    ``[(tag, fn)]``: the PN-Counter at each of ``RECORDED``'s geometries
    (the consensus phase's 4 nodes, and 16), the OR-Set at the
    orset_consensus phase's geometry, and both types at harness preset
    mixed's 64 nodes (``SAFEKV_RECORDED``); ``rng`` draws their ops."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset, pncounter
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.utils.ids import TagMinter

    def pnc_run(geo):
        return lambda: run_recorded(dev, workloads, geo)

    def orset_run():
        g = ORSET_CONS
        n = g["nodes"]
        kv = SafeKV(DagConfig(n, g["window"]), orset.SPEC,
                    ops_per_block=g["ops_per_block"], apply_budget=g["budget"],
                    collect_logs=False, device=dev, num_keys=g["keys"],
                    capacity=g["capacity"], rm_capacity=g["rm"])
        minters = [TagMinter(i) for i in range(n)]
        for _ in range(SAFEKV_RECORDED["orset_rounds"]):
            kv.step(workloads.ops_to_device(workloads.orset_add_remove(
                rng, minters, g["keys"], g["ops_per_block"]), dev))

    def mixed_run():
        g = SAFEKV_RECORDED["mixed"]
        n, b, k = g["nodes"], g["ops_per_block"], g["keys"]
        cfg = DagConfig(n, g["window"])
        kvs = [SafeKV(cfg, pncounter.SPEC, ops_per_block=b, collect_logs=False,
                      device=dev, num_keys=k, num_writers=n),
               SafeKV(cfg, orset.SPEC, ops_per_block=b, collect_logs=False,
                      device=dev, num_keys=k, apply_budget=n + max(4, n // 4),
                      capacity=g["capacity"], rm_capacity=g["rm"])]
        minters = [TagMinter(i) for i in range(n)]
        lo, hi = g["crash"]
        for rnd in range(g["rounds"]):
            active = np.ones(n, bool)
            active[n - 1] = not lo <= rnd < hi
            kvs[0].step(workloads.ops_to_device(
                workloads.pnc_uniform(rng, n, k, b), dev), active=active)
            kvs[1].step(workloads.ops_to_device(
                workloads.orset_add_remove(rng, minters, k, b), dev),
                active=active)

    runs = [(f"pnc N{geo['nodes']}", pnc_run(geo)) for geo in RECORDED]
    return runs + [("orset N4", orset_run), ("mixed N64", mixed_run)]


def safekv_kernel_checks(dev, kernels, workloads, cases):
    """safekv_submit (accept and board), block_select, state_transfer and
    gc_frontier (the frontier and the ring clear) against their plain
    versions on the card, bit-equal, in-place updates included: (a) random
    inputs at (N, W) from (4, 8) to (64, 16): rejected views (block made,
    slot buffered, below the frontier, window full, crashed), rounds near
    the int32 limits, ring rows with capture extras, selections that spill
    past the budget and commit keys that wrap, transfers needed by lag,
    by the frontier and by force (the donor among them), zero-size leaves,
    frontiers that advance by several slots past a lost straggler, and
    packs with and without the logs; (b) every call of SafeKV runs at the
    consensus phase's geometry and at 16 nodes (a node crashed for some
    rounds), at the orset_consensus phase's geometry, and at harness
    preset mixed's 64 nodes (both types), dag_round's among them. Returns,
    per kernel, the recorded calls the kernels line times."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models.base import OP_FIELDS

    entries = {"safekv_board": kernels.safekv_board}
    log = CaseLog(SAFEKV_KERNELS + ("dag_round",), entries)
    rng = np.random.default_rng(21)
    cover = {"accepted": 0, "rejected": 0, "spilled": 0, "wrapped_keys": 0,
             "need_lag": 0, "need_frontier": 0, "need_force": 0,
             "donor_needy": 0, "advanced_2_plus": 0, "lost": 0,
             "collect_logs": [0, 0]}

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def i32(shape, lo=-(2**31), hi=2**31 - 1):
        return t(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32))

    def bools(shape, p):
        return t(rng.random(shape) < p)

    def ring(n, w, b, r):
        fields = {f: i32((w, n, b), -5, 50) for f in OP_FIELDS}
        if r:
            fields.update({f: i32((w, n, b, r)) for f in ("rm_rep", "rm_ctr",
                                                           "rm_elem")})
        return fields

    for shape_i, (n, w) in enumerate(SAFEKV_CHECKS["shapes"]):
        cfg = DagConfig(n, w)
        for i in range(SAFEKV_CHECKS["states"]):
            wrap = i % 3 == 2
            dag, _, _ = workloads.consensus_state(rng, n, w, wrap=wrap)
            dag = {f: t(x) for f, x in dag.items()}
            b = (1, 37, 64)[i % 3]
            r = (0, 4, 8)[(i + shape_i) % 3]
            filled = bools((w, n), 0.3)
            active = None if i % 2 else bools((n,), 0.8)
            ops = {f: i32((n, b)) for f in OP_FIELDS}
            acc_ops, accepted, pre = log.add(
                kernels, "safekv_submit", (cfg, dag, filled, ops, active),
                f"N{n} W{w} state {i}")
            cover["accepted"] += int(accepted.sum())
            cover["rejected"] += int((~accepted).sum())
            buf = ring(n, w, b, r)
            captured = {f: acc_ops[f] if f in acc_ops else i32(x.shape[1:])
                        for f, x in buf.items()}  # the capture's extras
            pre_rand = i32((n,), -3 * w, 3 * w)
            for what, rounds in (("", pre), (" negative rounds", pre_rand)):
                log.add(kernels, "safekv_board",
                        (cfg, buf, filled, bools((n, w, n), 0.3), captured,
                         accepted, rounds), f"N{n} W{w} state {i}{what}")
            # selections: sparse and dense, budgets below and above W*N
            sr, base = dag["slot_round"], dag["base_round"]
            for p_ready, budget in ((0.2, 4 * n), (0.9, max(1, n // 2)),
                                    (0.9, 3 * w * n), (0.5, 1)):
                ready, applied = bools((n, w, n), p_ready), bools((n, w, n), 0.2)
                seq = None if budget % 2 else i32(
                    (n, w, n), 0, 2**31 // (w * n) + 50)
                sel = int((ready & ~applied).sum(dim=(1, 2)).max())
                cover["spilled"] += sel > min(budget, w * n)
                if seq is not None:
                    wide = seq.long() * (w * n) + w * n
                    cover["wrapped_keys"] += int((wide > 2**31 - 1).sum() > 0)
                log.add(kernels, "block_select",
                        (cfg, ring(n, w, b, r), ready, applied, budget, sr,
                         base, seq), f"N{n} W{w} state {i} budget {budget}")
            # transfers: ties in last_wave, the frontier, force on the donor
            lw = t(np.where(rng.random(n) < 0.25, rng.integers(-1, 4, n),
                            rng.integers(8, 11, n)).astype(np.int32))
            nr = dag["node_round"].clone()
            force = bools((n,), 0.2)
            if i % 2:
                force[int(torch.argmax(lw))] = True
            leaves = [i32((n, 3, 5)), bools((n, w, n), 0.5), nr, lw,
                      torch.zeros((n, 3, 0), dtype=torch.int32, device=dev),
                      bools((n,), 0.5)]
            need, donor = kernels.state_transfer_plain(
                cfg, tree_map(torch.Tensor.clone, leaves), nr.clone(), base,
                lw.clone(), force)
            lw_q = torch.sort(lw).values[n - cfg.quorum]
            cover["need_lag"] += int((lw < lw_q - max(2, w // 4)).sum())
            cover["need_frontier"] += int((nr < base).sum())
            cover["need_force"] += int(force.sum())
            cover["donor_needy"] += bool(need[int(donor)])
            log.add(kernels, "state_transfer", (cfg, leaves, nr, base, lw, force),
                    f"N{n} W{w} state {i}")
            # GC at a state with finished slots, with and without the logs,
            # the dead slots' ring rows cleared in the call
            gdag, gcom, before, pa, sa, bf = (
                {k: t(v) for k, v in x.items()} if isinstance(x, dict) else t(x)
                for x in workloads.gc_state(rng, n, w, wrap=wrap))
            drops = (i32((n,)), None if i % 2 else i32((n,)))
            logs = bool(i % 2)
            lost, dead, _ = log.add(
                kernels, "gc_frontier",
                (cfg, gdag, gcom, before, pa, sa, bf, i32((n,), -9, 99),
                 bools((n,), 0.7), bools((n,), 0.2), i32((), 0, n), drops,
                 logs, ring(n, w, b, r)),
                f"N{n} W{w} state {i} logs {logs}")
            cover["collect_logs"][logs] += 1
            cover["lost"] += int(lost.any())
            cover["advanced_2_plus"] += int(dead.sum()) >= 2

    # (b) the calls of real runs (dag_round's too: its 16- and 64-node
    # calls)
    names = SAFEKV_KERNELS + tuple(entries) + ("dag_round",)
    recorded, more = {}, {}
    runs = safekv_recorded_runs(dev, workloads, rng)
    for tag, fn in runs:
        calls = record_calls(kernels, names, fn)
        torch.cuda.synchronize()
        counts = {name: len(c) for name, c in calls.items()}
        check(counts["safekv_submit"] == counts["safekv_board"] > 0
              and counts["gc_frontier"] == counts["state_transfer"]
              == counts["dag_round"]
              and counts["block_select"] == 2 * counts["gc_frontier"],
              f"recorded {tag}: calls {counts}")
        for name, rec in calls.items():
            for j, (args, kw) in enumerate(rec):
                out = log.add(kernels, name, args, f"recorded {tag} call {j}", kw)
                if name == "state_transfer":
                    cover["recorded_transfers"] = (
                        cover.get("recorded_transfers", 0) + int(out[0].sum()))
                if name == "gc_frontier":
                    cover["recorded_lost"] = (cover.get("recorded_lost", 0)
                                              + int(out[0].sum()))
        recorded[tag] = counts
        if tag == f"pnc N{CONS['nodes']}":
            timing = calls
        elif tag in ("pnc N16", "mixed N64"):
            # the kernels line's calls at 16 and 64 nodes: the last
            # submit and round, and the first GC that frees a slot
            gc = calls["gc_frontier"]
            j = next((j for j, (a, _) in enumerate(gc)
                      if bool(kernels.gc_round_plain(
                          *tree_map(torch.Tensor.clone, a))[1].any())),
                     len(gc) - 1)
            more[tag.split()[1].lower()] = {
                "safekv_submit": (calls["safekv_submit"][-1],
                                  calls["safekv_board"][-1]),
                "gc_frontier": gc[j], "dag_round": calls["dag_round"][-1]}
        del calls
    check(cover["rejected"] > 0 and cover["accepted"] > 0
          and cover["spilled"] > 0 and cover["wrapped_keys"] > 0
          and min(cover[k] for k in ("need_lag", "need_frontier",
                                     "need_force", "donor_needy")) > 0
          and cover["advanced_2_plus"] > 0 and cover["lost"] > 0
          and min(cover["collect_logs"]) > 0,
          f"safekv_kernels: coverage {cover}")
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "safekv_kernels", **rec})
    emit("safekv_kernels", by_kernel=log.by, coverage=cover, recorded=recorded)
    timing["more"] = more
    return timing


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def select_bytes(plain, args) -> int:
    """What one ``block_select`` call must move: ``ready`` and ``applied``
    read, ``applied`` written, the keys' inputs read, ``idx`` and
    ``chosen`` written, every output row written once, and each ring row
    the call gathers read once, however many views gather it (its op
    field only where some view chose it: an unchosen row's op lanes are
    written as zeros). The rows gathered are this call's, from ``plain``
    (the plain version) on a copy of ``applied``."""
    cfg, ring, ready, applied, budget, sr, base, seq = args
    v, w, n = ready.shape
    a = min(budget, w * n)
    _, idx, chosen = plain(cfg, ring, ready, applied.clone(), budget, sr,
                           base, seq)
    ring_row = sum(x[0, 0].numel() * x.element_size() for x in ring.values())
    op_row = ring["op"][0, 0].numel() * ring["op"].element_size()
    gathered = int(torch.unique(idx).numel())
    gathered_op = int(torch.unique(idx[chosen]).numel())
    return (3 * v * w * n + _nbytes([seq, sr, base]) + 5 * v * a
            + v * a * ring_row + gathered * (ring_row - op_row)
            + gathered_op * op_row)


def submit_shape(a_args, b_args) -> str:
    """The geometry of one round's accept and board."""
    cfg, _, _, ops, _ = a_args
    n, b = ops["op"].shape
    return (f"N{n} W{cfg.num_rounds} B{b}: accept + board of one round, "
            f"{int(b_args[5].sum())} views accepted")


def gc_shape(kernels, g_args) -> str:
    """The geometry of one round's GC (the frontier and the ring clear)."""
    cfg = g_args[0]
    dead = kernels.gc_round_plain(*tree_map(torch.Tensor.clone, g_args))[1]
    return (f"N{cfg.num_nodes} W{cfg.num_rounds}: frontier + ring clear, "
            f"{int(dead.sum())} slots dead, logs {g_args[12]}")


def safekv_kernel_rows(kernels, calls):
    """Rows of the kernels line for the SafeKV round's four wrappers, each
    timed on recorded calls of the 4-node PN-Counter run (the consensus
    phase's geometry): safekv_submit as one round's accept and board,
    block_select on the last stable delta apply, state_transfer on a round
    in which a view needed a transfer and gc_frontier (with the ring
    clear) on a round in which slots died (both repeated on the state
    they leave); safekv_submit and gc_frontier are timed on the same
    calls of the 16-node PN-Counter run and of harness preset mixed's 64
    nodes too (``more_calls``). Bytes: what the function must move, each
    input read once and each output written once: the accepted views'
    ring rows, the gathered rows (``select_bytes``), the needy views' rows
    of every leaf, the dead slots' rows."""
    def clone(args):
        return tree_map(torch.Tensor.clone, args)

    def submit_calls(a_args, b_args):
        return (lambda: (kernels.safekv_submit(*a_args),
                         kernels.safekv_board(*b_args)),
                lambda: (kernels.safekv_submit_plain(*a_args),
                         kernels.safekv_board_plain(*b_args)))

    more = calls["more"]
    rows = []
    # safekv_submit: accept, then board, of the last recorded round
    (a_args, _), (b_args, _) = (calls["safekv_submit"][-1],
                                calls["safekv_board"][-1])
    cfg, dag, filled, ops, active = a_args
    n, b = ops["op"].shape
    _, buf, _, _, acc, accepted, _ = b_args
    k = int(accepted.sum())
    row_bytes = sum(x[0].numel() * x.element_size() for x in acc.values())
    nbytes = (2 * _nbytes(ops.values()) + 2 * n + 9 * n + 4
              + (n if active is not None else 0)
              + 2 * k * row_bytes + 5 * n + 2 * k)
    call, plain = submit_calls(a_args, b_args)
    rows.append(dict(
        name="safekv_submit", call=call, plain=plain, library=None,
        max_cuda_launches=2, shape=submit_shape(a_args, b_args),
        more_calls={label: (submit_shape(a[0], b[0]),
                            submit_calls(a[0], b[0])[0])
                    for label, got in more.items()
                    for a, b in [got["safekv_submit"]]},
        bytes=nbytes, operations=6 * n * b + k * row_bytes // 4))
    # block_select: the last (stable) delta apply
    args, _ = calls["block_select"][-1]
    cfg, ring, ready, applied, budget, sr, base, seq = args
    v, w, n = ready.shape
    a = min(budget, w * n)
    ring_row = sum(x[0, 0].numel() * x.element_size() for x in ring.values())
    nbytes = select_bytes(kernels.block_select_plain, args)
    rows.append(dict(
        name="block_select", call=lambda args=args: kernels.block_select(*args),
        plain=lambda args=args: kernels.block_select_plain(*args),
        library=None, max_cuda_launches=2,
        shape=f"V{v} W{w} N{n} A{a} B{ring['op'].shape[2]}: the last stable "
        f"delta apply", bytes=nbytes,
        operations=v * w * n * (2 + (seq is not None)) + v * a * ring_row // 4))
    # state_transfer: a round with a transfer, if the run had one
    st_calls = calls["state_transfer"]
    pick = len(st_calls) - 1
    for j, (args, _) in enumerate(st_calls):
        need, donor = kernels.state_transfer_plain(*clone(args))
        if bool(need.any()) and not (need.sum() == 1 and need[int(donor)]):
            pick = j
            break
    args, _ = st_calls[pick]
    cfg, leaves, nr, base, lw, force = args
    need, donor = kernels.state_transfer_plain(*clone(args))
    k = int(need.sum()) - int(need[int(donor)])
    leaf_row = sum(x[0].numel() * x.element_size() for x in leaves)
    n = cfg.num_nodes
    nbytes = 9 * n + 8 + ((k + 1) * leaf_row if k else 0)
    rows.append(dict(
        name="state_transfer",
        call=lambda args=args: kernels.state_transfer(*args),
        plain=lambda args=args: kernels.state_transfer_plain(*args),
        library=None,
        shape=f"N{n}: {k} views adopt the donor's rows ({len(leaves)} leaves, "
        f"round {pick})", bytes=nbytes, operations=4 * n + k * leaf_row // 4))
    # gc_frontier: the frontier and the ring clear of a round with dead slots
    gc_calls = calls["gc_frontier"]
    pick = len(gc_calls) - 1
    for j, (args, _) in enumerate(gc_calls):
        if bool(kernels.gc_round_plain(*clone(args))[1].any()):
            pick = j
            break
    g_args, _ = gc_calls[pick]
    cfg, ring = g_args[0], g_args[13]
    dead = kernels.gc_round_plain(*clone(g_args))[1]
    n, w = cfg.num_nodes, cfg.num_rounds
    d = int(dead.sum())
    logs = g_args[12]
    nwn = n * w * n
    reads = 4 * nwn + w * n + 17 * n + 8 * w + 8 + (4 * nwn if logs else 0)
    packed = 4 * (2 * n + n * w + w + 1 + (n + 1 + 2 * nwn + w if logs else 0))
    recycle = d * (2 * n * n + 3 * n + 9 * n * n + 8)
    slot_ring = sum(x[0].numel() * x.element_size() for x in ring.values())
    rows.append(dict(
        name="gc_frontier",
        call=lambda: kernels.gc_frontier(*g_args),
        plain=lambda: kernels.gc_round_plain(*g_args),
        library=None, max_cuda_launches=2,
        shape=f"{gc_shape(kernels, g_args)}, round {pick}",
        more_calls={label: (gc_shape(kernels, got["gc_frontier"][0]),
                            lambda a=got["gc_frontier"][0]:
                            kernels.gc_frontier(*a))
                    for label, got in more.items()},
        bytes=reads + packed + n + w + recycle + d * slot_ring,
        operations=reads // 4))
    for row in rows:
        row["library_note"] = SAFEKV_LIBRARY_NOTES[row["name"]]
    return rows


def record_rga_churn(dev, kernels, workloads, rounds, names):
    """The first ``rounds`` rounds of the rga_consensus phase (its geometry
    and its churn, the counters read back from the ring after each round,
    as pass 1 would record them) with every call of the named wrappers
    recorded, in-place aliasing kept. Returns ``(calls, stats)``."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime.safecrdt import SafeKV

    g = RGA_CONS
    n, b, k = g["nodes"], g["ops_per_block"], g["keys"]
    kv = SafeKV(DagConfig(n, g["window"]), rga.SPEC, ops_per_block=b,
                device=dev, num_keys=k, capacity=g["capacity"],
                max_depth=g["max_depth"])

    def run():
        minted = {}
        for t in range(rounds):
            info = kv.step(workloads.ops_to_device(
                workloads.rga_churn(n, b, k, t, minted), dev))
            ring = convert.tree_to_numpy(kv.ops_buffer["eff_ctr"])
            minted[t] = np.stack([ring[s, v, : b // 2, 0]
                                  for v, s in enumerate(info["slot"])])

    calls = record_calls(kernels, names, run, aliased=True)
    torch.cuda.synchronize()
    return calls, dict(kv.stats)


def record_orset_consensus(dev, kernels, workloads, names):
    """The orset_consensus phase's two runs repeated with their seeds: its
    CPU-held rounds and its warm-up and timed rounds, every call of the
    named wrappers recorded, in-place aliasing kept. Returns ``(calls,
    compactions)``."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset
    from janus_tpu_torch.runtime.safecrdt import SafeKV
    from janus_tpu_torch.utils.ids import TagMinter

    g = ORSET_CONS
    n, k, b = g["nodes"], g["keys"], g["ops_per_block"]
    compactions = []

    def run():
        for seed, rounds in ((6, g["cpu_rounds"]),
                             (7, g["warmup"] + g["rounds"])):
            rng = np.random.default_rng(seed)
            minters = [TagMinter(i) for i in range(n)]
            kv = SafeKV(DagConfig(n, g["window"]), orset.SPEC,
                        ops_per_block=b, apply_budget=g["budget"],
                        collect_logs=False, device=dev, num_keys=k,
                        capacity=g["capacity"], rm_capacity=g["rm"])
            for _ in range(rounds):
                kv.step(workloads.ops_to_device(
                    workloads.orset_add_remove(rng, minters, k, b), dev))
            compactions.append(kv.stats["compactions"])

    calls = record_calls(kernels, names, run, aliased=True)
    torch.cuda.synchronize()
    return calls, sum(compactions)


def fence_kernel_checks(dev, kernels, workloads, cases):
    """orset_compact (and its orset_watermark and orset_compact_fences
    entries), rga_capture and mark_members against their plain versions
    on the card, bit-equal, in-place updates included, and orset_apply's
    captured mode (JAX's one-lane captured scan; full rows, non-canonical
    rows, a tag captured twice, keys in [-K, 2K)): (a) random inputs:
    OR-Set rows (full and non-canonical ones, tombstoned tags at
    SENTINEL) behind watermarks of rings with and without a live add (one
    lane; harness preset orset's 655,360), with and without a protect
    mask, fresh and in place, and two states in one fused call, at preset
    orset's and the orset_consensus phase's state shapes; RGA
    captures with inserts into full rows (their counters still minted),
    keys in [-K, 2K), every op code, one document hammered, Lamport floors
    at INT32_MAX (the mint wraps), and the rga_consensus submit's shape;
    memberships with duplicates on both sides, masked queries, keys at
    SENTINEL and SENTINEL - 1, queries past one chunk, M = 0, T = 0 and
    the rga_consensus fence's sizes; (b) every call of the rga_consensus
    phase's first rounds (rga_compact's too) and of the orset_consensus
    phase's runs, repeated here with their seeds. Returns the recorded
    calls the kernels line times."""
    entries = {"orset_watermark": kernels.orset_watermark,
               "orset_compact_fences": kernels.orset_compact_fences}
    log = CaseLog(FENCE_KERNELS + ("rga_compact", "orset_apply", "rga_apply"),
                  entries)
    rng = np.random.default_rng(31)
    sent = torch.iinfo(torch.int32).max
    cover = {"wm_sentinel": 0, "wm_live": 0, "kept_by_wm": 0,
             "capture_drops": 0, "capture_wraps": 0, "members": 0,
             "non_members": 0, "one_lane_drops": 0, "walk_drops": 0}

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    def i32(shape, lo, hi):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    # (a) random inputs
    for lead, c, n_ring, adds in FENCE_CHECKS["orset"]:
        rows = {f: t(x) for f, x in workloads.orset_slots(
            rng, lead, c, canonical=False, full_rows=0.4).items()}
        rows["tag_ctr"][..., 0] = torch.where(rows["valid"][..., 0], sent,
                                              rows["tag_ctr"][..., 0])
        op = rng.integers(0, 4, n_ring) if adds else rng.integers(2, 4, n_ring)
        ring = (t(op.astype(np.int32)), t(i32((n_ring,), 0, 2 * c)))
        what = f"{'x'.join(map(str, lead))} C{c} ring {n_ring}"
        wm = log.add(kernels, "orset_watermark", ring, what)
        cover["wm_sentinel" if int(wm[0]) == sent else "wm_live"] += 1
        cover["kept_by_wm"] += int((rows["valid"] & rows["removed"]
                                    & (rows["tag_ctr"] >= wm[0])).sum())
        prot = t(rng.random(lead + (c,)) < 0.2)
        for w_, p_ in ((wm, None), (None, prot), (wm, prot), (None, None)):
            tag = f"{what} wm {w_ is not None} protect {p_ is not None}"
            log.add(kernels, "orset_compact", (rows, w_, p_), tag)
            log.add(kernels, "orset_compact", (rows, w_, p_), tag + " in place",
                    {"out": rows}, aliased=True)
        more = {f: t(x) for f, x in workloads.orset_slots(
            rng, lead, c, canonical=True).items()}
        log.add(kernels, "orset_compact_fences", ((rows, more), *ring),
                what + " fused, two states", aliased=True)
    for r, k, c, b, full in FENCE_CHECKS["captures"]:
        st = {f: t(x) for f, x in workloads.rga_slots(
            rng, (r, k), c, full_rows=full, negative=0.1).items()}
        floor = i32((r, k), -2, c + 2)
        floor[:, ::2] = sent
        st["ctr_floor"] = t(floor)
        ops = workloads.rga_mixed_ops(rng, (r, b), k, c)
        ops["key"][:, : b // 4] = 1
        eff, drop = log.add(kernels, "rga_capture",
                            (st, workloads.ops_to_device(ops, dev)),
                            f"R{r} K{k} C{c} B{b}", host_plain=True)
        cover["capture_drops"] += int(drop.sum())
        cover["capture_wraps"] += int((eff == -(2**31)).sum())
        if (r, k, c) == (RGA_CONS["nodes"], RGA_CONS["keys"],
                         RGA_CONS["capacity"]):  # the churn, mid-run
            minted = {q: i32((r, b // 2), 1, 50) for q in (3, 4)}
            churn = workloads.rga_churn(r, b, k, 5, minted)
            st["ctr_floor"] = t(i32((r, k), 0, 50))
            log.add(kernels, "rga_capture",
                    (st, workloads.ops_to_device(churn, dev)),
                    f"churn R{r} K{k} C{c} B{b}", host_plain=True)
    v_, k_, c_, block = FENCE_CHECKS["walk_shape"]
    for case, modes in FENCE_CHECKS["walks"]:
        st_np, ops_np = workloads.rga_walk_case(rng, case, v_, k_, c_, block)
        st = {f: t(x) for f, x in st_np.items()}
        for mode in modes:
            ops = workloads.ops_to_device(
                {f: x for f, x in ops_np.items()
                 if mode == "captured" or f != "eff_ctr"}, dev)
            out = log.add(kernels, "rga_capture" if mode == "capture"
                          else "rga_apply", (st, ops),
                          f"walk {case} {mode} V{v_} K{k_} C{c_} "
                          f"B{16 * block}", host_plain=True)
            cover["walk_drops"] += int((out[1] if mode == "capture"
                                        else out).sum())
    for m, n_b, span in FENCE_CHECKS["members"]:
        def keys(n):
            x = i32((2, n), -span, span)
            hot = rng.random((2, n)) < 0.05
            return np.where(hot, sent - rng.integers(0, 2, (2, n)),
                            x).astype(np.int32)
        a, b = keys(m), keys(n_b)
        if m and n_b:  # duplicates across the sides
            a[:, : m // 4] = b[:, rng.integers(0, n_b, m // 4)]
        valid = t(rng.random(n_b) < 0.7)
        out = log.add(kernels, "mark_members",
                      ((t(a[0]), t(a[1])), (t(b[0]), t(b[1])), valid),
                      f"M{m} T{n_b} span {span}")
        cover["members"] += int(out.sum())
        cover["non_members"] += int((~out).sum())

    for r, k, c, r_cap, b in FENCE_CHECKS["one_lane"]:
        st = {f: t(x) for f, x in workloads.orset_slots(
            rng, (r, k), c, canonical=False, dup_rows=0.3,
            full_rows=0.5).items()}
        ops = workloads.orset_mixed_ops(rng, (r, b), k, c)
        shape = (r, b, r_cap)
        rm = rng.integers(0, 4, shape)
        ops["rm_rep"] = np.where(rng.random(shape) < 0.1, sent, rm)
        ops["rm_ctr"] = rng.integers(1, c + 2, shape)
        ops["rm_elem"] = rng.integers(0, 8, shape)
        if r_cap > 1:  # one tag captured twice
            for f in ("rm_rep", "rm_ctr", "rm_elem"):
                ops[f][..., 1] = ops[f][..., 0]
        drop = log.add(kernels, "orset_apply",
                       (st, workloads.ops_to_device(ops, dev)),
                       f"captured R{r} K{k} C{c} r_cap {r_cap} B{b}")
        cover["one_lane_drops"] += int(drop.sum())

    # (b) recorded runs
    rga_names = ("rga_capture", "mark_members", "rga_compact", "rga_apply")
    rga_calls, rga_stats = record_rga_churn(
        dev, kernels, workloads, FENCE_CHECKS["rga_rounds"], rga_names)
    advances = rga_stats["compactions"]
    counts = {name: len(c) for name, c in rga_calls.items()}
    check(advances > 0 and counts == {
        "rga_capture": FENCE_CHECKS["rga_rounds"],
        "mark_members": 2 * advances, "rga_compact": 2 * advances,
        "rga_apply": 2 * FENCE_CHECKS["rga_rounds"]},
        f"fence_kernels: rga_consensus calls {counts}, {advances} "
        f"compactions")
    # the delta applies (16,384 lanes a view): the first with no live
    # lane (the floor's clamps alone) and the first with the median live
    # count (the steady state's 4 blocks a view), which the kernels line
    # times (its plain version's time on host copies is this check's:
    # ~35 s for the heaviest, 8 blocks a view); their lanes a group
    applies = rga_calls.pop("rga_apply")
    walks = [rga_walk_stats(*a) for a, _ in applies]
    live = [w["live"] for w in walks]
    timed = live.index(sorted(live)[len(live) // 2])
    picked = sorted({live.index(0) if 0 in live else timed, timed})
    check_ms = {}
    for j in picked:
        t0 = time.perf_counter()
        log.add(kernels, "rga_apply", applies[j][0],
                f"recorded rga_consensus delta apply {j}", applies[j][1],
                aliased=True, host_plain=True)
        check_ms[j] = 1e3 * (time.perf_counter() - t0)
    orset_calls, orset_advances = record_orset_consensus(
        dev, kernels, workloads, ("orset_compact_fences",))
    o_counts = {name: len(c) for name, c in orset_calls.items()}
    check(orset_advances > 0 and o_counts == {
        "orset_compact_fences": orset_advances},
        f"fence_kernels: orset_consensus calls {o_counts}, "
        f"{orset_advances} compactions")
    fence_sorted = [0, 0]  # rows already sorted, rows
    for (rows, _), _ in rga_calls["rga_compact"]:
        got, n = rows_sorted(rows)
        fence_sorted[0] += got
        fence_sorted[1] += n
    for tag, calls in (("rga_consensus", rga_calls),
                       ("orset_consensus", orset_calls)):
        for name, rec in calls.items():
            for j, (args, kw) in enumerate(rec):
                out = log.add(kernels, name, args,
                              f"recorded {tag} call {j}", kw, aliased=True,
                              host_plain=name == "rga_capture")
                if name == "mark_members":
                    cover["members"] += int(out.sum())
    check(all(v > 0 for v in cover.values()),
          f"fence_kernels: coverage {cover}")
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "fence_kernels", **rec})
    emit("fence_kernels", by_kernel=log.by, coverage=cover,
         compact_rows_sorted={"sorted": fence_sorted[0],
                              "rows": fence_sorted[1],
                              "share": fence_sorted[0] / fence_sorted[1]},
         recorded={"rga_consensus": {"rounds": FENCE_CHECKS["rga_rounds"],
                                     "compactions": advances, **counts},
                   "orset_consensus": {"compactions": orset_advances,
                                       **o_counts}},
         delta_applies={"checked": picked, "walks": walks})
    return {**rga_calls, "rga_apply_consensus": applies[timed],
            "rga_apply_consensus_walk": {**walks[timed],
                                         "plain_host_ms": check_ms[timed]},
            **orset_calls}


def rga_churn_model(stream, minted, key):
    """Independent numpy model of document ``key`` under the churn
    ``stream`` (pass 2's op batches) with the counters ``minted`` (pass
    1's): every insert is an element ``(rep, ctr)`` under its anchor (the
    root is (0, 0)), every delete kills its target; the text is the
    depth-first walk with siblings in descending (ctr, rep) order,
    restricted to live elements. Returns ``(ids [n, 2] (rep, ctr), chars
    [n])`` in document order."""
    children, chars, dead = {}, {}, set()
    for t, ops in enumerate(stream):
        L = ops["op"].shape[1] // 2
        for v, j in zip(*np.nonzero((ops["op"][:, :L] == 1)
                                    & (ops["key"][:, :L] == key))):
            me = (int(ops["writer"][v, j]), int(minted[t][v, j]))
            parent = (int(ops["a1"][v, j]), int(ops["a2"][v, j]))
            children.setdefault(parent, []).append(me)
            chars[me] = int(ops["a0"][v, j])
        for v, j in zip(*np.nonzero((ops["op"][:, L:] == 2)
                                    & (ops["key"][:, L:] == key))):
            dead.add((int(ops["a1"][v, L + j]), int(ops["a2"][v, L + j])))
    order, stack = [], [(0, 0)]
    while stack:
        node = stack.pop()
        if node != (0, 0):
            order.append(node)
        # descending (ctr, rep) first: push in ascending order
        stack.extend(sorted(children.get(node, ()), key=lambda e: (e[1], e[0])))
    live = [e for e in order if e not in dead]
    return (np.array(live, np.int64).reshape(-1, 2),
            np.array([chars[e] for e in live], np.int32))


def delete_hit_share(stream, minted) -> float:
    """The share of the stream's deletes whose target (document, rep, ctr)
    had been inserted and was not yet deleted when the delete was
    issued."""
    live, hits, total = set(), 0, 0
    for t, ops in enumerate(stream):
        L = ops["op"].shape[1] // 2
        for v, j in zip(*np.nonzero(ops["op"][:, L:] == 2)):
            target = (int(ops["key"][v, L + j]), int(ops["a1"][v, L + j]),
                      int(ops["a2"][v, L + j]))
            total += 1
            hits += target in live
            live.discard(target)
        for v, j in zip(*np.nonzero(ops["op"][:, :L] == 1)):
            live.add((int(ops["key"][v, j]), int(ops["writer"][v, j]),
                      int(minted[t][v, j])))
    return hits / max(total, 1)


def by_id(st):
    """Each row's valid slots first in (id_ctr, id_rep) order, invalid ones
    after: two states holding the same elements in other slots become
    bit-equal."""
    from janus_tpu_torch.kernels.rga_rows import FIELDS
    from janus_tpu_torch.ops.setops import lex_order

    sent = torch.iinfo(torch.int32).max
    v = st["valid"]
    order = lex_order([~v, torch.where(v, st["id_ctr"], sent),
                       torch.where(v, st["id_rep"], sent)])
    return {f: st[f].gather(-1, order) for f in FIELDS}


def rga_consensus(dev, kernels, workloads):
    """The RGA through SafeKV on the card: 4 nodes, window 8, 1,024-op
    blocks, 128 documents of 1,024 slots (BASELINE config 5's), the churn
    of ``workloads.rga_churn``. Pass 1, off the clock, runs the insert
    lanes alone and records the counters they mint; pass 2 runs the full
    churn (its anchors and deletes name those ids): warm-up rounds, the
    timed rounds, idle rounds until drained. Checks: every batch accepted,
    pass 2 minted pass 1's counters, compactions ran, nothing dropped and
    no document full, the stable views bit-equal and every view's
    prospective state holding the stable one's elements (slot order
    follows the apply order), the texts of three documents equal across
    views and to a numpy model, ``dead`` bool, and each wrapper launched
    as often as a round or a GC advance calls it."""
    from janus_tpu_torch.consensus import DagConfig, tusk
    from janus_tpu_torch.consensus import dag as dagmod
    from janus_tpu_torch.models import rga
    from janus_tpu_torch.runtime.safecrdt import COMMIT_STEPS, SafeKV

    g = RGA_CONS
    n, w, b, k, c = (g[x] for x in ("nodes", "window", "ops_per_block",
                                    "keys", "capacity"))
    L = b // 2
    total = g["warmup"] + g["rounds"] + g["profile_rounds"]

    def make_kv():
        return SafeKV(DagConfig(n, w), rga.SPEC, ops_per_block=b, device=dev,
                      num_keys=k, capacity=c, max_depth=g["max_depth"])

    # pass 1: the insert lanes alone, off the clock
    t0 = time.perf_counter()
    kv, minted = make_kv(), {}
    for t in range(total):
        ops = workloads.rga_churn(n, b, k, t)
        info = kv.step(workloads.ops_to_device(ops, dev))
        check(info["accepted"].all(), f"rga_consensus: pass 1 round {t} "
              f"rejected")
        ring = kv.ops_buffer["eff_ctr"][:, :, :L, 0].cpu().numpy()
        minted[t] = np.stack([ring[s, v] for v, s in enumerate(info["slot"])])
    pass1_s = time.perf_counter() - t0
    del kv

    # pass 2: the full churn
    stream = [workloads.rga_churn(n, b, k, t, minted) for t in range(total)]
    batches = [workloads.ops_to_device(o, dev) for o in stream]
    idle = workloads.ops_to_device(
        {f: np.zeros((n, b), np.int32) for f in stream[0]}, dev)
    kv = make_kv()
    effs = []
    real_capture = kernels.rga_capture

    def capture(*a, **kw):  # keeps each round's counters, without a sync
        out = real_capture(*a, **kw)
        effs.append(out[0])
        return out

    kernels.rga_capture = capture
    try:
        for t in range(g["warmup"]):
            kv.step(batches[t])
        torch.cuda.synchronize()
        stats0 = dict(kv.stats)
        kernels.reset_launches()
        t0 = time.perf_counter()
        for t in range(g["warmup"], g["warmup"] + g["rounds"]):
            info = kv.step(batches[t])
            check(info["accepted"].all(), f"rga_consensus: round {t} rejected")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        kernels.rga_capture = real_capture
    check(len(effs) == g["warmup"] + g["rounds"], "rga_consensus: captures "
          f"{len(effs)}")
    for t, eff in enumerate(effs):
        check(np.array_equal(eff[:, :L, 0].cpu().numpy(), minted[t]),
              f"rga_consensus: round {t} minted other counters than pass 1")
    committed = kv.stats["own_commits"] - stats0["own_commits"]
    lag = kv.commit_latencies()

    def drained():
        return all(torch.equal(x, x[:1].expand_as(x))
                   for f, x in kv.stable.items())

    idle_rounds = 0
    while idle_rounds < g["max_idle"]:
        if idle_rounds >= g["min_idle"] and drained():
            break
        kv.step(idle, record=False)
        idle_rounds += 1
    torch.cuda.synchronize()
    launches = kernels.launches()
    stepped = g["rounds"] + idle_rounds
    advances = kv.stats["compactions"] - stats0["compactions"]
    check(drained(), f"rga_consensus: stable views differ after "
          f"{idle_rounds} idle rounds")
    stable = by_id(kv.stable)
    prosp = by_id(kv.prospective)
    check(all(torch.equal(prosp[f], stable[f]) for f in stable),
          "rga_consensus: a view's prospective state holds other elements "
          "than the stable one")
    occupancy = int(max(rga.element_count(kv.prospective).max(),
                        rga.element_count(kv.stable).max()))
    check(advances > 0 and kv.stats["slots_dropped"] == 0 and occupancy < c,
          f"rga_consensus: {advances} compactions, "
          f"{kv.stats['slots_dropped']} slots dropped, occupancy {occupancy}")
    check(kv.stable["dead"].dtype == torch.bool
          and kv.prospective["dead"].dtype == torch.bool,
          "rga_consensus: dead is not bool")
    texts = {}
    for doc in g["texts"]:
        ids, chars = rga_churn_model(stream[: g["warmup"] + g["rounds"]],
                                     minted, doc)
        for name, st in (("stable", kv.stable), ("prospective",
                                                  kv.prospective)):
            out = rga.text(st, doc)
            for v in range(n):
                live = out["live"][v]
                got = (torch.stack([out["id_rep"][v][live],
                                    out["id_ctr"][v][live]], 1).cpu().numpy(),
                       out["chr"][v][live].cpu().numpy())
                check(np.array_equal(got[0], ids)
                      and np.array_equal(got[1], chars)
                      and not bool(out["overflow"][v]),
                      f"rga_consensus: {name} text of document {doc} at "
                      f"view {v} differs from the numpy model")
        texts[doc] = len(chars)
    expect = {"rga_capture": stepped, "rga_apply": 2 * stepped,
              "mark_members": 2 * advances, "rga_compact": 2 * advances,
              **{name: per * stepped for name, per in ROUND_LAUNCHES.items()}}
    for name, want in expect.items():
        check(launches[name] == want, f"rga_consensus: {name} launched "
              f"{launches[name]} times in {stepped} rounds and {advances} "
              f"GC advances, expected {want}")

    # device work per round and per phase, by the profiler
    from torch.profiler import ProfilerActivity, profile
    extra = batches[g["warmup"] + g["rounds"]:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ops in extra:
            kv.step(ops)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    cfg = kv.cfg
    everything = torch.ones((n, w, n), dtype=torch.bool, device=dev)
    order = torch.zeros((n, w, n), dtype=torch.int32, device=dev)
    applied_none = torch.zeros((n, w, n), dtype=torch.bool, device=dev)
    carry = [tree_map(torch.Tensor.clone, kv._carry()) for _ in range(4)]
    by_phase = {
        "submit": cuda_kernels_of(lambda: kv._submit_device(
            carry[0][0], carry[0][2], *carry[0][4:7], extra[0])),
        "state_transfer": cuda_kernels_of(lambda: kv._state_transfer(
            *carry[1][:4], *carry[1][6:9])),
        "round_step": cuda_kernels_of(lambda: dagmod.round_step(cfg, kv.dag)),
        "causal_closure": cuda_kernels_of(
            lambda: kv._causal_closure(kv.dag, kv.prosp_applied)),
        "commit_view": cuda_kernels_of(lambda: tusk.commit_view(
            cfg, kv.dag, kv.commit, seed=kv.seed, steps=COMMIT_STEPS)),
        "delta_apply_x2": 2 * cuda_kernels_of(lambda: kv._delta_apply(
            carry[2][1], carry[2][4], everything, applied_none,
            kv.commit["slot_round"], kv.dag["base_round"], order)),
        "compaction_at_gc": cuda_kernels_of(lambda: kv._compact_device(
            carry[3][0], carry[3][1], carry[3][4])),
    }
    # ms per GC advance (the fence and the compaction of both states), on
    # copies of the drained state, by CUDA events
    copies = [tree_map(torch.Tensor.clone, (kv.prospective, kv.stable))
              for _ in range(g["compaction_reps"])]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for p_, s_ in copies:
        kv._compact_device(p_, s_, kv.ops_buffer)
    end.record()
    torch.cuda.synchronize()
    gc_ms = start.elapsed_time(end) / len(copies)
    emit("rga_consensus", nodes=n, window=w, ops_per_block=b, keys=k,
         capacity=c, warmup_rounds=g["warmup"], rounds=g["rounds"],
         idle_rounds_to_drain=idle_rounds, seconds=dt,
         ms_per_round=1e3 * dt / g["rounds"],
         ops_per_s=g["rounds"] * n * b / dt,
         committed_ops_per_s=committed * b / dt,
         commit_lag_ticks_p50=float(np.percentile(lag, 50)),
         commit_lag_ticks_p99=float(np.percentile(lag, 99)),
         profiled_rounds=len(extra),
         cuda_kernels_per_round=len(dev_events) / len(extra),
         profiled_device_us_per_round=sum(
             e.time_range.elapsed_us() for e in dev_events) / len(extra),
         device_us_per_round_by_kernel=device_us_by_kernel(dev_events,
                                                           len(extra)),
         cuda_kernels_by_phase=by_phase, ms_per_gc_advance=gc_ms,
         slots_dropped=kv.stats["slots_dropped"] - stats0["slots_dropped"],
         compactions=advances,
         gc_advances=kv.stats["gc_advances"] - stats0["gc_advances"],
         delete_hit_share=delete_hit_share(stream, minted),
         max_element_count=occupancy, live_text_lengths=texts,
         launches=launches, pass1_seconds=pass1_s, stats=kv.stats)
    return launches


def fence_advance(kernels, states, op, a2):
    """One recorded GC advance's rows, the rows it changes (by the plain
    versions) and the bytes it must move: the ring's op and a2 and every
    slot read once, the watermark and the changed rows written once."""
    wm = kernels.orset_watermark_plain(op, a2)
    rows = changed = 0
    for st in states:
        out = kernels.orset_compact_plain(st, wm)
        diff = torch.zeros(st["valid"].shape[:-1], dtype=torch.bool,
                           device=op.device)
        for f, x in st.items():
            diff |= (out[f] != x).any(-1)
        rows += diff.numel()
        changed += int(diff.sum())
    c = states[0]["valid"].shape[-1]
    return rows, changed, 8 * op.numel() + 4 + 14 * c * (rows + changed)


def fresh_calls(fn, args, copies):
    """A call of no arguments that runs ``fn`` on the next of ``copies``
    clones of ``args`` made now, so that an in-place call finds the state
    it was recorded on (the clones are used in turn, the first again after
    the last)."""
    pool = [clone_aliased(args) for _ in range(copies)]
    at = [0]

    def call():
        a = pool[at[0] % copies]
        at[0] += 1
        return fn(*a)
    return call


def fence_kernel_rows(kernels, calls, preset_call):
    """Rows of the kernels line for the three fence and capture wrappers,
    on recorded calls of the main paths: orset_compact as one GC advance
    of the orset_consensus phase (one orset_compact_fences call: the
    watermark and both states' compactions, in place, each timed call on
    a fresh copy of the recorded state, ``FENCE_COPIES`` of them) and, as
    ``preset_orset``, the last advance of harness preset orset's checked
    run (``preset_call``), rga_capture on an rga_consensus submit (the
    last recorded, on the state it leaves), mark_members on an
    rga_consensus fence. Bytes: what the function must move, each input
    read once and each output written once: the ring's op and a2 and each
    slot read, the rows an advance changes written (14 bytes a slot); the
    op fields, the counters written and the rows the lanes gather and
    write back (22 bytes a slot, 4 of floor); the A keys, the queries and
    the marks."""
    rows = []
    (states, op, a2), _ = calls["orset_compact_fences"][-1]
    (p_states, p_op, p_a2), _ = preset_call
    n_rows, changed, nbytes = fence_advance(kernels, states, op, a2)
    p_rows, p_changed, p_bytes = fence_advance(kernels, p_states, p_op, p_a2)
    shape = " x ".join(map(str, states[0]["valid"].shape))
    p_shape = " x ".join(map(str, p_states[0]["valid"].shape))
    slots = sum(st["valid"].numel() for st in states)
    plain_args = clone_aliased((states, op, a2))
    rows.append(dict(
        name="orset_compact",
        call=fresh_calls(kernels.orset_compact_fences, (states, op, a2),
                         FENCE_COPIES),
        plain=lambda: kernels.orset_compact_fences_plain(*plain_args),
        library=None, max_cuda_launches=2,
        shape=f"one GC advance of orset_consensus: ring {op.numel()} lanes, "
        f"2 states {shape}, in place, {changed} of {n_rows} rows changed, "
        f"each call on a fresh copy",
        more_calls={"preset_orset": (
            f"one GC advance of harness preset orset: ring {p_op.numel()} "
            f"lanes, 2 states {p_shape}, in place, {p_changed} of {p_rows} "
            f"rows changed", fresh_calls(
                kernels.orset_compact_fences, (p_states, p_op, p_a2),
                FENCE_COPIES if p_changed else 1))},
        rows_changed={"orset_consensus": changed, "preset_orset": p_changed},
        more_bound_ms={"preset_orset": 1e3 * p_bytes / HBM_BYTES_PER_S},
        bytes=nbytes, operations=2 * op.numel() + slots))
    (state, ops), kw = calls["rga_capture"][-1]
    r, k, c = state["valid"].shape
    b = ops["op"].shape[1]
    read, written = rga_rows_touched(state, ops)
    rows.append(dict(
        name="rga_capture", call=lambda: kernels.rga_capture(state, ops),
        plain=lambda: kernels.rga_capture_plain(state, ops), library=None,
        shape=f"an rga_consensus submit: V{r} K{k} C{c} B{b}",
        rows_read=read, rows_written=written,
        bytes=(4 * 6 * r * b + 4 * r * b + 4 * r
               + (22 * c + 4) * (read + written)),
        operations=7 * c * read))
    (a_keys, b_keys, b_valid), kw = calls["mark_members"][-1]
    m, t = a_keys[0].numel(), b_keys[0].numel()
    pa = ((a_keys[0].long() << 32) | (a_keys[1].long() & 0xFFFFFFFF)).view(-1)
    pb = ((b_keys[0].long() << 32) | (b_keys[1].long() & 0xFFFFFFFF))[b_valid]
    rows.append(dict(
        name="mark_members",
        call=lambda: kernels.mark_members(a_keys, b_keys, b_valid),
        plain=lambda: kernels.mark_members_plain(a_keys, b_keys, b_valid),
        library=lambda: torch.isin(pa, pb),
        shape=f"an rga_consensus fence: M{m} ids, T{t} queries "
        f"({int(b_valid.sum())} valid)",
        bytes=9 * m + 9 * t, operations=m * int(np.ceil(np.log2(max(t, 2))))))
    for row in rows:
        row["library_note"] = FENCE_LIBRARY_NOTES[row["name"]]
    return rows


# -- the LWW-Set and the MVRegister ------------------------------------------

def typed_kv(dev, kind, g):
    """A SafeKV for the LWW-Set (``kind`` "lww") or the MVRegister ("mvr")
    at the geometry ``g`` (LWW_CONS or MVR_CONS)."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import lwwset, mvregister
    from janus_tpu_torch.runtime.safecrdt import SafeKV

    n, w, b, k, c = (g[x] for x in ("nodes", "window", "ops_per_block",
                                    "keys", "capacity"))
    if kind == "lww":
        return SafeKV(DagConfig(n, w), lwwset.SPEC, ops_per_block=b,
                      device=dev, num_keys=k, capacity=c)
    return SafeKV(DagConfig(n, w), mvregister.SPEC, ops_per_block=b,
                  device=dev, num_keys=k, num_writers=n, capacity=c)


def typed_stream(workloads, kind, g, rounds):
    """The phase's op batches (int32 numpy ``[N, B]``) of ``rounds``
    rounds, drawn from its seed."""
    rng = np.random.default_rng(g["seed"])
    n, b, k = g["nodes"], g["ops_per_block"], g["keys"]
    if kind == "lww":
        return [workloads.lww_add_remove(rng, n, k, b, t, num_elems=g["elems"])
                for t in range(rounds)]
    return [workloads.mvr_writes(rng, n, k, b) for _ in range(rounds)]


def typed_store_stream(workloads, ticks):
    """TYPED_STORE's op batches: per tick ``{"lww": ..., "mvr": ...}``
    int32 numpy ``[R, B]``, keys Zipf-skewed in a hot window of D/2 keys
    rotating every tick (harness preset mixed_delta's traffic shape)."""
    g = TYPED_STORE
    R, K, B, hot = g["R"], g["K"], g["B"], g["budget"] // 2
    rng = np.random.default_rng(g["seed"])
    return [{"lww": workloads.lww_add_remove(rng, R, K, B, t, hot=hot),
             "mvr": workloads.mvr_writes(rng, R, K, B, hot=hot, tick=t)}
            for t in range(ticks)]


def typed_store_arms(dev):
    """The phase's two Stores: a full arm and a delta arm at D."""
    from janus_tpu_torch.runtime.store import Store

    g = TYPED_STORE
    types = {"lww": dict(num_keys=g["K"], capacity=g["lww_capacity"]),
             "mvr": dict(num_keys=g["K"], num_writers=g["R"],
                         capacity=g["mvr_capacity"])}
    return {"full": (Store(g["R"], types, device=dev), False),
            f"delta_D{g['budget']}": (Store(g["R"], types,
                                            dirty_budget=g["budget"],
                                            device=dev), True)}


def live_lanes(ops, codes) -> int:
    return int(sum(int((ops["op"] == c).sum()) for c in codes))


def typed_kernel_checks(dev, kernels, workloads, cases):
    """The eight LWW-Set and MVRegister wrappers against their plain
    versions on the card, bit-equal, in-place updates and drop counts
    included: (a) random inputs: canonical and non-canonical rows (an elem
    twice in a row), full rows that drop, hazard ops (keys in [-2K, 2K),
    every op code, writers in [-2W, 2W), stamps with negative low words,
    equal stamps, wclocks at the int32 extremes), more concurrent writers
    than V, rows hammered by more lanes than a walk's window, the trees'
    row-list levels (gather, scratch, scatter) and the main paths' shapes,
    and the MVRegister walk's edge cases (``workloads.mvr_walk_case``);
    (b) every call of the first rounds of lww_consensus and mvr_consensus
    and of the first ticks and the late tick of both typed_store arms,
    repeated here with their seeds (the ticks between unchecked); the LWW
    union's edge cases (``workloads.lww_union_case``). Returns, per
    wrapper, one recorded main-path call to time (the one with the most
    live lanes, for an apply)."""
    t_start = time.perf_counter()
    log = CaseLog(TYPED_KERNELS)
    rng = np.random.default_rng(41)
    cover = {"lww_drops": 0, "lww_overflow": 0, "ok_zero": 0,
             "mvr_drops": 0, "mvr_overflow": 0, "hot_lanes": 0}

    def on(tree):
        return {f: torch.as_tensor(np.asarray(x), device=dev)
                for f, x in tree.items()}

    # (a) random inputs
    for lead, ca, cb, canonical in TYPED_CHECKS["lww_unions"]:
        a = on(workloads.lww_slots(rng, lead, ca, canonical=canonical,
                                   dup_rows=0.3, full_rows=0.5,
                                   num_elems=ca + cb))
        b = on(workloads.lww_slots(rng, lead, cb, canonical=canonical,
                                   dup_rows=0.3, full_rows=0.5,
                                   num_elems=ca + cb))
        what = f"{'x'.join(map(str, lead))} C{ca}+{cb}"
        _, ovf = log.add(kernels, "lww_union", (a, b, ca), what)
        cover["lww_overflow"] += int(ovf.sum())
        out = {f: torch.empty((2,) + lead + (ca,), dtype=x.dtype, device=dev)
               for f, x in a.items()}
        log.add(kernels, "lww_union", (a, b, ca), what + " into 2 replicas",
                {"out": out})
    lww_edge_cases(dev, kernels, workloads, log, np.random.default_rng(45))
    # the walk's edge cases (workloads.lww_walk_case) in the three modes
    for case in workloads.LWW_WALK_CASES:
        for v, k, c, b in TYPED_CHECKS["lww_walks"]:
            for mode in ("apply", "captured", "capture"):
                st, ops = (on(x) for x in workloads.lww_walk_case(
                    rng, case, (v, b), k, c, captured=mode == "captured"))
                log.add(kernels, "lww_capture" if mode == "capture" else
                        "lww_apply", (st, ops),
                        f"walk {case} {mode} V{v} K{k} C{c} B{b}",
                        host_plain=True)
    for lead, va, vb, w, span, canonical in TYPED_CHECKS["mvr_merges"]:
        a = on(workloads.mvr_slots(rng, lead, va, w, canonical=canonical,
                                   span=span))
        b = on(workloads.mvr_slots(rng, lead, vb, w, canonical=canonical,
                                   span=span))
        what = f"{'x'.join(map(str, lead))} V{va}+{vb} W{w}"
        _, ovf = log.add(kernels, "mvr_merge", (a, b, va), what)
        cover["mvr_overflow"] += int(ovf.sum())
        out = {f: torch.empty((2,) + tuple(x.shape), dtype=x.dtype,
                              device=dev) for f, x in a.items()}
        log.add(kernels, "mvr_merge", (a, b, va), what + " into 2 replicas",
                {"out": out})
    # one row-list level of each kind on random rows: level 1 (gather from
    # the state), a middle level (scratch) and the last (scatter into R)
    for kind, p, k, c, w in TYPED_CHECKS["row_levels"]:
        if kind == "lww":
            make = lambda lead: on(workloads.lww_slots(  # noqa: E731
                rng, lead, c, canonical=False, dup_rows=0.2, full_rows=0.3))
            name = "lww_union_rows"
        else:
            make = lambda lead: on(workloads.mvr_slots(  # noqa: E731
                rng, lead, c, w, span=5))
            name = "mvr_merge_rows"
        rows = torch.as_tensor(rng.permutation(k).astype(np.int32), device=dev)
        for n_rows in (k, k // 3, 0):
            n_t = torch.tensor(n_rows, dtype=torch.int32, device=dev)
            a, b, o = make((p, k)), make((p, k)), make((p, k))
            log.add(kernels, name, (a, b, o, rows, n_t),
                    f"P{p} K{k} C{c} n {n_rows} gather")
            log.add(kernels, name, (a, b, o, rows, n_t),
                    f"P{p} K{k} C{c} n {n_rows} scratch", {"gather": False})
            log.add(kernels, name, ({f: x[:1] for f, x in a.items()},
                                    {f: x[:1] for f, x in b.items()},
                                    make((3, k)), rows, n_t),
                    f"R3 K{k} C{c} n {n_rows} scatter", {"scatter": True})
    for v, k, c, b, mode, hot in TYPED_CHECKS["lww_applies"]:
        st = on(workloads.lww_slots(rng, (v, k), c, canonical=False,
                                    dup_rows=0.3, full_rows=0.4,
                                    num_elems=2 * c))
        ops = workloads.lww_mixed_ops(rng, (v, b), k, 2 * c,
                                      captured=mode == "captured")
        if hot:
            ops["key"][:, : 9 * b // 10] = 1
            cover["hot_lanes"] += 9 * b // 10
        what = f"{mode} V{v} K{k} C{c} B{b}{' hot' if hot else ''}"
        if mode == "capture":
            ok, drop = log.add(kernels, "lww_capture",
                               (st, workloads.ops_to_device(ops, dev)), what)
            cover["ok_zero"] += int((ok == 0).sum())
        else:
            drop = log.add(kernels, "lww_apply",
                           (st, workloads.ops_to_device(ops, dev)), what)
        cover["lww_drops"] += int(drop.sum())
    for v, k, vc, w, b, mode, hot in TYPED_CHECKS["mvr_applies"]:
        st = on(workloads.mvr_slots(rng, (v, k), vc, w, canonical=False))
        st["clock"][..., 0] = torch.where(st["valid"], 2**31 - 1,
                                          st["clock"][..., 0])
        ops = workloads.mvr_mixed_ops(rng, (v, b), k, w,
                                      captured=mode == "captured",
                                      num_values=40)
        if hot:
            ops["key"][:, : 9 * b // 10] = 1
            cover["hot_lanes"] += 9 * b // 10
        what = f"{mode} V{v} K{k} Vc{vc} W{w} B{b}{' hot' if hot else ''}"
        name = "mvr_capture" if mode == "capture" else "mvr_apply"
        out = log.add(kernels, name, (st, workloads.ops_to_device(ops, dev)),
                      what)
        cover["mvr_drops"] += int((out[1] if mode == "capture" else out).sum())
    # the walk's edge cases (workloads.mvr_walk_case) in the three modes
    from janus_tpu_torch.kernels.mvr_rows import OP_FIELDS
    v, k = TYPED_CHECKS["mvr_walk_geometry"]
    for case, vc, w, b, modes in TYPED_CHECKS["mvr_walks"]:
        st, ops = workloads.mvr_walk_case(rng, case, v, k, vc, w, b)
        st = on(st)
        for mode in modes:
            o = ops if mode == "captured" else {f: ops[f] for f in OP_FIELDS}
            name = "mvr_capture" if mode == "capture" else "mvr_apply"
            log.add(kernels, name, (st, workloads.ops_to_device(o, dev)),
                    f"walk {case} {mode} V{v} K{k} Vc{vc} W{w} B{b}",
                    host_plain=True)

    random_s = time.perf_counter() - t_start
    # (b) recorded main-path calls, each checked as it is made
    keep = {}
    apply_codes = {"lww_apply": (1, 2), "lww_capture": (1, 2),
                   "mvr_apply": (1,), "mvr_capture": (1,)}
    tag = {"run": "", "arm": "", "ticks": "", "quiet": False}
    # level 1 of typed_store's LWW tree, per arm, for the first ticks and
    # the late one: its input rows already in elem order, the rows holding
    # a valid record, and the tail lengths of the unsorted (row_order)
    level1 = {}

    def level1_spy(name, fn):
        def call(*args, **kw):
            if typed_level1(name, args, kw) and not tag["quiet"]:
                record_level1(level1, f"{tag['arm']} {tag['ticks']}", name,
                              args, ("elem",))
            return fn(*args, **kw)
        return call

    def recorded():
        for kind, g in (("lww", LWW_CONS), ("mvr", MVR_CONS)):
            tag["run"] = f"{kind}_consensus"
            kv = typed_kv(dev, kind, g)
            for ops in typed_stream(workloads, kind, g,
                                    TYPED_CHECKS["rounds"]):
                kv.step(workloads.ops_to_device(ops, dev))
            del kv
        tag["run"] = "typed_store"
        arms = typed_store_arms(dev)
        inner = {n: getattr(kernels, n) for n in TYPED_KERNELS[:2]}
        for n, fn in inner.items():
            setattr(kernels, n, level1_spy(n, fn))
        first, late = TYPED_CHECKS["ticks"], TYPED_CHECKS["late_tick"]
        try:
            for t, tick in enumerate(typed_store_stream(workloads, late + 1)):
                tag["quiet"] = first <= t < late
                tag["ticks"] = (f"ticks 0-{first - 1}" if t < first
                                else f"tick {t}")
                batch = {tc: workloads.ops_to_device(o, dev)
                         for tc, o in tick.items()}
                for arm, (st, use_delta) in arms.items():
                    tag["arm"] = arm
                    st.fused_tick(batch, delta=use_delta)
        finally:
            tag["quiet"] = False
            for n, fn in inner.items():
                setattr(kernels, n, fn)

    counts = check_calls(
        kernels, log, TYPED_KERNELS, recorded,
        lambda name, i: f"recorded {tag['run']} call {i}", keep=keep,
        score=lambda name, args: (live_lanes(args[1], apply_codes[name])
                                  if name in apply_codes else 0),
        aliased=True, skip=lambda: tag["quiet"])
    torch.cuda.synchronize()
    check(all(counts[n] > 0 for n in TYPED_KERNELS),
          f"typed_kernels: recorded calls {counts}")
    check(all(v > 0 for v in cover.values()),
          f"typed_kernels: coverage {cover}")
    check(len(level1) == 4 and all(r[1] > 0 for r in level1.values()),
          f"typed_kernels: level-1 rows of typed_store {sorted(level1)}")
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "typed_kernels", **rec})
    emit("typed_kernels", by_kernel=log.by, coverage=cover,
         level1_rows_sorted=level1_report(level1),
         random_seconds=random_s,
         recorded_seconds=time.perf_counter() - t_start - random_s,
         recorded={"rounds": TYPED_CHECKS["rounds"],
                   "ticks": TYPED_CHECKS["ticks"],
                   "late_tick": TYPED_CHECKS["late_tick"], "calls": counts})
    return keep


def lww_gate_model(state, ops, E):
    """Independent numpy model of the LWW-Set capture's gate on one call:
    ``state`` the views' rows as the capture read them (numpy fields
    ``[V, K, C]``), ``ops`` their batches (numpy ``[V, B]``). Per (view,
    key, elem), lane by lane in lane order, a remove's ``ok`` is its
    element's containment (an add stamp that is not (0, 0) and not below
    the remove stamp, the low word unsigned: add wins ties) as the
    batch's earlier lanes left it; an add raises the add stamp, a remove
    with ``ok`` the remove stamp. Every other lane's ``ok`` is 1. Returns
    int32 ``[V, B]``."""
    V, K, C = state["valid"].shape
    check(C >= E, f"lww gate model: rows of {C} slots can fill with {E} "
          f"elems")

    def ts(hi, lo):
        return (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)

    sel = state["valid"]
    v, k, _ = np.nonzero(sel)
    el = state["elem"][sel]
    check(((el >= 0) & (el < E)).all(), "lww gate model: an elem outside "
          "[0, E)")
    at = (v * K + k) * E + el
    check(np.unique(at).size == at.size, "lww gate model: an elem twice in "
          "a row")
    add = np.zeros(V * K * E, np.int64)
    rm = np.zeros(V * K * E, np.int64)
    add[at] = ts(state["add_hi"][sel], state["add_lo"][sel])
    rm[at] = ts(state["rm_hi"][sel], state["rm_lo"][sel])
    ok = np.ones(ops["op"].shape, np.int32)
    lv, lb = np.nonzero((ops["op"] == 1) | (ops["op"] == 2))
    key, el = ops["key"][lv, lb], ops["a0"][lv, lb]
    check(((key >= 0) & (key < K) & (el >= 0) & (el < E)).all(),
          "lww gate model: a key or elem out of range")
    grp = (lv * K + key) * E + el
    order = np.argsort(grp, kind="stable")   # lane order within a group
    lv, lb, grp = lv[order], lb[order], grp[order]
    pos = np.arange(grp.size)
    first = np.r_[True, grp[1:] != grp[:-1]] if grp.size else pos > 0
    rank = pos - np.maximum.accumulate(np.where(first, pos, 0))
    stamp = ts(ops["a1"][lv, lb], ops["a2"][lv, lb])
    is_add = ops["op"][lv, lb] == 1
    for t in range(int(rank.max()) + 1 if rank.size else 0):
        w = rank == t   # one lane of each group: distinct groups
        g, st, a = grp[w], stamp[w], is_add[w]
        add[g[a]] = np.maximum(add[g[a]], st[a])
        g, st = g[~a], st[~a]
        hit = (add[g] != 0) & (add[g] >= rm[g])
        rm[g] = np.where(hit, np.maximum(rm[g], st), rm[g])
        ok[lv[w][~a], lb[w][~a]] = hit
    return ok


def lww_fold_model(stream, oks, K, E):
    """Independent numpy model of the LWW-Set after every op of ``stream``
    (the accepted batches) applied: per (key, elem) the max add stamp over
    the adds and the max remove stamp over the removes whose ``ok``
    (``oks``, per batch ``[N, B]``, from ``lww_gate_model``) is 1, as int64
    microseconds (0: never stamped). Returns ``(add [K, E], rm [K, E])``."""
    add = np.zeros((K, E), np.int64)
    rm = np.zeros((K, E), np.int64)
    for ops, ok in zip(stream, oks):
        ts = (ops["a1"].astype(np.int64) << 31) | ops["a2"].astype(np.int64)
        at = ops["key"].astype(np.int64) * E + ops["a0"]
        is_add = ops["op"] == 1
        is_rm = (ops["op"] == 2) & (ok == 1)
        np.maximum.at(add.reshape(-1), at[is_add], ts[is_add])
        np.maximum.at(rm.reshape(-1), at[is_rm], ts[is_rm])
    return add, rm
def lww_rows_of_model(workloads, add, rm, C):
    """The canonical rows ``[K, C]`` (elem, add_hi, add_lo, rm_hi, rm_lo,
    valid) the model's stamps give: the stamped elems in ascending order,
    SENTINEL and zeros after."""
    K, E = add.shape
    sent = np.iinfo(np.int32).max
    out = {f: np.zeros((K, C), np.int32) for f in
           ("elem", "add_hi", "add_lo", "rm_hi", "rm_lo")}
    out["elem"][:] = sent
    out["valid"] = np.zeros((K, C), bool)
    for k in range(K):
        es = np.nonzero((add[k] > 0) | (rm[k] > 0))[0]
        check(es.size <= C, f"lww model: key {k} holds {es.size} elems")
        n = es.size
        out["elem"][k, :n] = es
        out["valid"][k, :n] = True
        for pol, x in (("add", add), ("rm", rm)):
            hi, lo = workloads.lww_stamps(x[k, es])
            out[f"{pol}_hi"][k, :n], out[f"{pol}_lo"][k, :n] = hi, lo
    return out


def mvr_fold_model(writes, K, V, W):
    """Independent numpy model of one view's stable MVRegister state: the
    writes its stable applies received, in order (``writes``: per apply
    call numpy ``(key [n], val [n], wclock [n, W])`` of its write lanes),
    each joined into its key's row as the causal frontier of the row's
    values and the write (a value whose clock another value's strictly
    dominates, or an exact (val, clock) twin of an earlier value, is
    dropped), ordered by (val, clock lanes) and cut to V. Returns ``(val
    [K, V], valid [K, V], clock [K, V, W], drops)``, the invalid tail
    (SENTINEL, zeros) as the state holds it."""
    vals = [np.zeros(0, np.int64) for _ in range(K)]
    clocks = [np.zeros((0, W), np.int64) for _ in range(K)]
    drops = 0
    for key, val, wclock in writes:
        check(((key >= 0) & (key < K)).all(), "mvr model: a key out of range")
        for kk, x, c in zip(key.tolist(), val.astype(np.int64),
                            wclock.astype(np.int64)):
            v = np.append(vals[kk], x)
            cl = np.vstack([clocks[kk], c[None]])
            n = v.size
            le = (cl[:, None, :] <= cl[None, :, :]).all(-1)
            strictly = le & (cl[:, None, :] < cl[None, :, :]).any(-1)
            twin = le & le.T & (v[:, None] == v[None, :])
            keep = ~strictly.any(1) & ~(twin & np.tri(n, k=-1, dtype=bool)
                                        ).any(1)
            v, cl = v[keep], cl[keep]
            order = np.lexsort([cl[:, i] for i in range(W - 1, -1, -1)]
                               + [v])
            drops += max(order.size - V, 0)
            vals[kk], clocks[kk] = v[order[:V]], cl[order[:V]]
    out_val = np.full((K, V), np.iinfo(np.int32).max, np.int64)
    out_valid = np.zeros((K, V), bool)
    out_clock = np.zeros((K, V, W), np.int64)
    for kk in range(K):
        n = vals[kk].size
        out_val[kk, :n], out_valid[kk, :n] = vals[kk], True
        out_clock[kk, :n] = clocks[kk]
    return out_val, out_valid, out_clock, drops


def consensus_rounds(kernels, kv, batches, idle, g, kind, expect,
                     per_round=None):
    """The timed part of a consensus phase on ``kv``: ``g["warmup"]``
    rounds off the clock, the timed rounds (``per_round(r)`` after timed
    round r, from 1, when given; it must not read the device back), idle
    rounds until every view's stable state is bit-equal (between
    ``min_idle`` and ``max_idle``). Checks every batch accepted, the
    drain, and each wrapper's launches against ``expect(stepped)``
    (``{name: count}`` for the ``stepped`` rounds counted, idle ones
    included) beside ``ROUND_LAUNCHES``. Returns a dict of the timed
    seconds, committed blocks, the commit lags, the idle rounds, the
    launches and the stats before the clock started."""
    total = g["warmup"] + g["rounds"]
    for t in range(g["warmup"]):
        info = kv.step(batches[t])
        check(info["accepted"].all(), f"{kind}_consensus: warm-up round "
              f"{t} rejected")
    torch.cuda.synchronize()
    stats0 = dict(kv.stats)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for t in range(g["warmup"], total):
        info = kv.step(batches[t])
        check(info["accepted"].all(), f"{kind}_consensus: round {t} "
              f"rejected")
        if per_round is not None:
            per_round(t - g["warmup"] + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    committed = kv.stats["own_commits"] - stats0["own_commits"]
    lag = kv.commit_latencies()

    def drained():
        return all(torch.equal(x, x[:1].expand_as(x))
                   for x in kv.stable.values())

    idle_rounds = 0
    while idle_rounds < g["max_idle"]:
        if idle_rounds >= g["min_idle"] and drained():
            break
        kv.step(idle, record=False)
        idle_rounds += 1
    torch.cuda.synchronize()
    launches = kernels.launches()
    stepped = g["rounds"] + idle_rounds
    check(drained(), f"{kind}_consensus: stable views differ after "
          f"{idle_rounds} idle rounds")
    want = {**{name: per * stepped for name, per in ROUND_LAUNCHES.items()},
            **expect(stepped)}
    for name, want_n in want.items():
        check(launches[name] == want_n, f"{kind}_consensus: {name} launched "
              f"{launches[name]} times in {stepped} rounds, expected {want_n}")
    return dict(dt=dt, committed=committed, lag=lag, idle_rounds=idle_rounds,
                launches=launches, stats0=stats0)


def consensus_emit(kind, kv, g, extra, run, step=None, **out):
    """Profile ``extra`` rounds of ``kv`` (``step(kv, ops)``, by default
    ``kv.step``) and emit the phase's line from ``run``
    (``consensus_rounds``' result) and ``out``."""
    from torch.profiler import ProfilerActivity, profile

    step = step or (lambda kv, ops: kv.step(ops))
    n, w, b, k = (g[x] for x in ("nodes", "window", "ops_per_block", "keys"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ops in extra:
            step(kv, ops)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    state_mb = sum(x.numel() * x.element_size()
                   for st in (kv.prospective, kv.stable)
                   for x in st.values()) / 1e6
    dt, lag = run["dt"], run["lag"]
    emit(f"{kind}_consensus", nodes=n, window=w, ops_per_block=b, keys=k,
         apply_budget=kv.apply_budget, warmup_rounds=g["warmup"],
         rounds=g["rounds"], idle_rounds_to_drain=run["idle_rounds"],
         seconds=dt, ms_per_round=1e3 * dt / g["rounds"],
         ops_per_s=g["rounds"] * n * b / dt,
         committed_ops_per_s=run["committed"] * b / dt,
         commit_lag_ticks_p50=float(np.percentile(lag, 50)),
         commit_lag_ticks_p99=float(np.percentile(lag, 99)),
         profiled_rounds=len(extra),
         cuda_kernels_per_round=len(dev_events) / len(extra),
         profiled_device_us_per_round=sum(
             e.time_range.elapsed_us() for e in dev_events) / len(extra),
         device_us_per_round_by_kernel=dict(list(device_us_by_kernel(
             dev_events, len(extra)).items())[:12]),
         slots_dropped=kv.stats["slots_dropped"]
         - run["stats0"]["slots_dropped"],
         state_mb=state_mb, launches=run["launches"], stats=kv.stats, **out)


def typed_consensus(dev, kernels, workloads, kind):
    """The LWW-Set (``kind`` "lww", LWW_CONS) or the MVRegister ("mvr",
    MVR_CONS) through SafeKV on the card: warm-up rounds, the timed
    rounds, idle rounds until every view's stable state is bit-equal, a
    record pass (the same rounds on a fresh SafeKV, untimed, bit-equal to
    the timed run at its end), then a few profiled rounds. Checks: every
    batch accepted; the stable views bit-equal; each wrapper launched as
    often as a round calls it. The LWW-Set: every view's prospective state
    holds the stable elements by (key, elem); each remove's ``ok`` is
    decided in numpy from the rows its capture read (``lww_gate_model``),
    and each (key, elem)'s add and remove stamps equal a numpy max-fold
    over the committed ops with those ``ok``. The MVRegister: the stable
    state equals a numpy frontier fold (``mvr_fold_model``) of the writes
    its applies received, in their order; every surviving pair of values
    of a key is concurrent (a numpy pairwise clock check) and no key
    holds more than V values; the (view, key) rows where prospective and
    stable differ are counted (a frontier cut to V depends on the join
    order)."""
    from janus_tpu_torch.kernels.lww_rows import canonical_row

    g = LWW_CONS if kind == "lww" else MVR_CONS
    n, b, k, c = (g[x] for x in ("nodes", "ops_per_block", "keys",
                                 "capacity"))
    total = g["warmup"] + g["rounds"]
    stream = typed_stream(workloads, kind, g, total + g["profile_rounds"])
    batches = [workloads.ops_to_device(o, dev) for o in stream]
    idle = workloads.ops_to_device(
        {f: np.zeros((n, b), np.int32) for f in stream[0]}, dev)
    kv = typed_kv(dev, kind, g)
    run = consensus_rounds(
        kernels, kv, batches, idle, g, kind,
        lambda stepped: {f"{kind}_capture": stepped,
                         f"{kind}_apply": 2 * stepped})
    idle_rounds, stepped = run["idle_rounds"], g["rounds"] + run["idle_rounds"]

    # the record pass: what the numpy models need, taken just before each
    # call: the LWW-Set's capture inputs (the gate decided at once), the
    # MVRegister's stable applies' write lanes of view 0
    t_rec = time.perf_counter()
    again = typed_kv(dev, kind, g)

    def take(_, args, kw):
        state, ops = args
        if kind == "lww":
            host = {f: x.cpu().numpy() for f, x in ops.items()}
            return host, lww_gate_model(
                {f: x.cpu().numpy() for f, x in state.items()}, host,
                g["elems"])
        if state["val"].data_ptr() != again.stable["val"].data_ptr():
            return None   # a prospective apply
        live = ops["op"][0] == 1
        return tuple(ops[f][0][live].cpu().numpy()
                     for f in ("key", "a0", "wclock"))

    def rerun():
        for t in range(total):
            again.step(batches[t])
        for _ in range(idle_rounds):
            again.step(idle, record=False)

    name = "lww_capture" if kind == "lww" else "mvr_apply"
    rec = [x for x in record_calls(kernels, (name,), rerun, take=take)[name]
           if x is not None]
    for f in kv.stable:
        check(torch.equal(again.stable[f], kv.stable[f])
              and torch.equal(again.prospective[f], kv.prospective[f]),
              f"{kind}_consensus: the record pass's {f} differs from the "
              f"timed run's")
    check(again.stats["state_transfers"] == 0, f"{kind}_consensus: a state "
          f"transfer in the record pass (the models follow each view's own "
          f"applies)")
    del again
    out = {}
    if kind == "lww":
        from janus_tpu_torch.models import lwwset
        check(len(rec) == total + idle_rounds, f"lww_consensus: {len(rec)} "
              f"captures recorded")
        for t, (ops, _) in enumerate(rec[:total]):
            check(all(np.array_equal(ops[f], stream[t][f]) for f in ops),
                  f"lww_consensus: round {t}'s captured ops differ from "
                  f"its batch")
        prosp = canonical_row({f: kv.prospective[f] for f in lwwset.FIELDS})
        stab = canonical_row({f: kv.stable[f] for f in lwwset.FIELDS})
        check(all(torch.equal(prosp[f], stab[f]) for f in stab),
              "lww_consensus: a view's prospective state holds other "
              "elements or stamps than the stable one")
        oks = [ok for _, ok in rec[:total]]
        add, rm = lww_fold_model(stream[:total], oks, k, g["elems"])
        want = lww_rows_of_model(workloads, add, rm, c)
        got = {f: x[0].cpu().numpy() for f, x in stab.items()}
        for f, x in want.items():
            check(np.array_equal(got[f], x), f"lww_consensus: stable {f} "
                  f"differs from the numpy max-fold of the committed ops")
        rm_lanes = sum(int((o["op"] == 2).sum()) for o in stream[:total])
        out.update(removes=rm_lanes,
                   removes_ok=int(sum(int(((o["op"] == 2) & (x == 1)).sum())
                                      for o, x in zip(stream[:total], oks))),
                   live_elements=int(lwwset.live_count(kv.stable)[0].sum()),
                   stamped_elements=int(stab["valid"][0].sum()),
                   add_wins_ties=int(((add == rm) & (add > 0)).sum()))
    else:
        from janus_tpu_torch.models import mvregister
        check(len(rec) == stepped + g["warmup"], f"mvr_consensus: "
              f"{len(rec)} stable applies recorded")
        m_val, m_valid, m_clock, m_drops = mvr_fold_model(
            rec, k, c, kv.stable["clock"].shape[-1])
        for f, x in (("val", m_val), ("valid", m_valid), ("clock", m_clock)):
            check(np.array_equal(kv.stable[f][0].cpu().numpy(), x),
                  f"mvr_consensus: stable {f} differs from the numpy "
                  f"frontier fold of the writes its applies received")
        # a frontier cut to V depends on the join order once it overflows,
        # so prospective (certify order) may differ from stable (commit
        # order) where values were dropped: counted, not required
        differ = torch.zeros_like(kv.stable["valid"][..., 0])
        for f in kv.stable:
            x, y = kv.prospective[f], kv.stable[f]
            differ |= (x != y).reshape(x.shape[:2] + (-1,)).any(-1)
        out["prospective_keys_differing"] = int(differ.sum())
        clock = kv.stable["clock"][0].cpu().numpy().astype(np.int64)
        valid = kv.stable["valid"][0].cpu().numpy()
        nv = valid.sum(-1)
        check(int(nv.max()) <= c, f"mvr_consensus: a key holds {nv.max()} "
              f"values, more than V={c}")
        pairs = 0
        for key in np.nonzero(nv > 1)[0]:
            cl = clock[key][valid[key]]
            le = (cl[:, None, :] <= cl[None, :, :]).all(-1)
            np.fill_diagonal(le, False)
            check(not le.any(), f"mvr_consensus: key {key} holds two "
                  f"values one of whose clocks dominates the other's")
            pairs += len(cl) * (len(cl) - 1) // 2
        out.update(keys_with_concurrent_values=int((nv > 1).sum()),
                   concurrent_pairs=pairs, max_values_per_key=int(nv.max()),
                   values=int(nv.sum()), stable_writes_view0=int(
                       sum(x[0].size for x in rec)),
                   model_drops_view0=m_drops,
                   key_clock_max=int(mvregister.key_clock(
                       kv.stable)[0].max()))
    out["record_pass_seconds"] = time.perf_counter() - t_rec
    consensus_emit(kind, kv, g, batches[total:], run, capacity=c, **out)
    return run["launches"]


def lww_consensus(dev, kernels, workloads):
    return typed_consensus(dev, kernels, workloads, "lww")


def mvr_consensus(dev, kernels, workloads):
    return typed_consensus(dev, kernels, workloads, "mvr")


def store_arms(kernels, phase, arms, batches, ticks, rows_ok, want, R, B):
    """The timed part of a two-type store phase: one warm-up tick
    (``batches[0]``) off the clock, then ``ticks`` ticks with the arms
    (``{name: (Store, delta)}``, a "full" arm among them) in turns. After
    every tick: every leaf's replica rows bit-equal and equal to the full
    arm's, and ``rows_ok(full_store, tick)`` (the type's canonical-row
    checks). Then each arm's launches per tick are checked against
    ``want[name]``, no delta arm may have overflowed, and three more ticks
    of each arm are profiled. Returns ``(launches, the full arm's Store,
    {arm: its numbers})``."""
    for st, use_delta in arms.values():
        st.fused_tick(batches[0], delta=use_delta)
        st.flush_metrics()
    torch.cuda.synchronize()
    kernels.reset_launches()
    names = list(arms)
    tick_ms = {name: [] for name in arms}
    grew = {name: dict.fromkeys(kernels.WRAPPERS, 0) for name in arms}
    full = arms["full"][0]
    for t in range(1, ticks + 1):
        for name in (names if t % 2 else names[::-1]):
            st, use_delta = arms[name]
            before = kernels.launches()
            t0 = time.perf_counter()
            st.fused_tick(batches[t], delta=use_delta)
            torch.cuda.synchronize()
            tick_ms[name].append(1e3 * (time.perf_counter() - t0))
            for kk, v in kernels.launches().items():
                grew[name][kk] += v - before[kk]
        for name, (st, _) in arms.items():
            for tc, state in st.states.items():
                for f, x in state.items():
                    check(torch.equal(x, x[:1].expand_as(x)),
                          f"{phase} {name}: replica rows of {tc}.{f} "
                          f"differ after tick {t}")
                    check(torch.equal(x, full.states[tc][f]),
                          f"{phase} {name}: {tc}.{f} differs from the "
                          f"full arm after tick {t}")
        rows_ok(full, t)
    launches = kernels.launches()
    overflows = {name: {tc: int(st._fused_acc.get(f"overflow_{tc}", 0))
                        for tc in st.states}
                 for name, (st, _) in arms.items()}
    fracs = {name: st.flush_metrics() for name, (st, _) in arms.items()}
    per_tick = {name: {kk: v / ticks for kk, v in counted.items() if v}
                for name, counted in grew.items()}
    for name in arms:
        check(per_tick[name] == want[name], f"{phase} {name}: launches "
              f"per tick {per_tick[name]}, expected {want[name]}")
    check(all(x == 0 for name, (_, delta) in arms.items() if delta
              for x in overflows[name].values()),
          f"{phase}: delta overflows {overflows}")
    out = {}
    for name, (st, use_delta) in arms.items():
        more = iter(batches[1:4])
        seen, dev_ms = device_profile(
            lambda st=st, use_delta=use_delta: st.fused_tick(next(more),
                                                             delta=use_delta),
            reps=3)
        ms = tick_ms[name]
        out[name] = dict(cuda_kernels_per_tick=seen / 3,
                         device_ms_per_tick=dev_ms / 3,
                         ms_per_tick=sum(ms) / ticks, ms_per_tick_min=min(ms),
                         ms_per_tick_max=max(ms),
                         converged_ops_per_s=R * B * 2 * ticks
                         / (sum(ms) / 1e3),
                         dirty_fraction=fracs[name],
                         overflows=overflows[name],
                         launches_per_tick=per_tick[name])
    return launches, full, out


def typed_store(dev, kernels, workloads):
    """Both types through ``Store.fused_tick`` at harness preset
    mixed_delta's geometry (TYPED_STORE): a full arm (``join_replicas``
    every tick) and a delta arm at D (``converge_delta`` through the
    row-list trees), the same pre-generated streams, 24 timed ticks after
    one warm-up tick, the arms in turns (``store_arms``). After every tick:
    every leaf's replica rows bit-equal, the rows canonical (an LWW row
    sorted by elem, an MVRegister row its own causal frontier), and the
    delta arm bit-equal to the full arm (the invariant ``converge_delta``
    claims)."""
    from janus_tpu_torch.kernels.lww_rows import canonical_row
    from janus_tpu_torch.kernels.mvr_rows import frontier
    from janus_tpu_torch.models import lwwset

    g = TYPED_STORE
    R, K, B, D, ticks = (g[x] for x in ("R", "K", "B", "budget", "ticks"))
    host = typed_store_stream(workloads, ticks + 1)
    batches = [{tc: workloads.ops_to_device(o, dev) for tc, o in h.items()}
               for h in host]

    def rows_ok(full, t):
        lww0 = {f: full.states["lww"][f][0] for f in lwwset.FIELDS}
        canon = canonical_row(lww0)
        check(all(torch.equal(canon[f], lww0[f]) for f in canon),
              f"typed_store: an LWW row is not canonical after tick {t}")
        mvr0 = {f: full.states["mvr"][f][0] for f in ("val", "valid",
                                                       "clock")}
        again, _ = frontier(mvr0["val"], mvr0["valid"], mvr0["clock"],
                            g["mvr_capacity"])
        check(all(torch.equal(again[f], mvr0[f]) for f in mvr0),
              f"typed_store: an MVRegister row is not its frontier after "
              f"tick {t}")

    levels = int(np.ceil(np.log2(R)))
    want = {"full": {"lww_apply": 1, "mvr_apply": 1, "lww_union": levels,
                     "mvr_merge": levels},
            f"delta_D{D}": {"lww_apply": 1, "mvr_apply": 1, "dirty_rows": 2,
                            "delta_select": 2, "lww_union_rows": levels,
                            "mvr_merge_rows": levels}}
    launches, full, arm_out = store_arms(
        kernels, "typed_store", typed_store_arms(dev), batches, ticks,
        rows_ok, want, R, B)
    state_mb = {tc: sum(x.numel() * x.element_size()
                        for x in full.states[tc].values()) / 1e6
                for tc in ("lww", "mvr")}
    mvr_full = int((full.states["mvr"]["valid"][0].sum(-1)
                    == g["mvr_capacity"]).sum())
    emit("typed_store", replicas=R, keys=K, lww_capacity=g["lww_capacity"],
         mvr_capacity=g["mvr_capacity"], writers=R,
         ops_per_replica_per_type=B, hot_window=D // 2, ticks=ticks,
         state_mb=state_mb, mvr_keys_at_capacity=mvr_full,
         lww_live_elements=int(lwwset.live_count(full.states["lww"])[0].sum()),
         arms=arm_out, launches=launches)
    return launches


def rows_touched(state_valid, ops, codes):
    """``(rows gathered, rows written)``: the distinct (view, row) pairs the
    live lanes (op code in ``codes``) of an apply gather (JAX's clamp rule)
    and write back (in-range keys)."""
    from janus_tpu_torch.models.base import gather_index, scatter_index

    V, K = state_valid.shape[:2]
    live = torch.zeros_like(ops["op"], dtype=torch.bool)
    for c in codes:
        live |= ops["op"] == c
    v = torch.arange(V, device=live.device).view(V, 1).expand_as(live)
    wi, ok = scatter_index(ops["key"], K)
    read = torch.unique((v * K + gather_index(ops["key"], K))[live]).numel()
    written = torch.unique((v * K + wi)[live & ok]).numel()
    return read, written


def union_level_row(kernels, name, call, per, ops, phase):
    """A kernels-line row of a union (or merge) wrapper on one recorded
    level of a store phase's converge tree: ``call`` is its (args, kwargs),
    the full mode's ``(a, b, cap)`` or the row-list mode's ``(a, b, out,
    rows, n_rows)``. Bytes: each input slot read once and each output slot
    written once, ``per`` bytes a slot (and the listed rows); operations:
    ``ops(slots in, rows joined)``."""
    args, kw = call
    if len(args) == 3:
        a, b, cap = args
        out = kw.get("out")
        rep = 1 if out is None else out["valid"].shape[0]
        nrows = a["valid"][..., 0].numel()
        ca, cb = a["valid"].shape[-1], b["valid"].shape[-1]
        return dict(
            name=name, call=lambda: kernels.WRAPPERS[name](*args, **kw),
            plain=lambda: plain_of(kernels, name)(*args, **kw), library=None,
            shape=f"a {phase} converge level: {nrows} rows of {ca} + {cb} "
            f"slots into {rep} replica(s)",
            bytes=per * nrows * (ca + cb + rep * cap),
            operations=ops(ca + cb, nrows))
    a, b, out, _, n_rows = args
    m = int(n_rows)
    p, _, c = a["valid"].shape
    scatter = kw.get("scatter", False)
    rep = out["valid"].shape[0] if scatter else 1
    return dict(
        name=name, call=lambda: kernels.WRAPPERS[name](*args, **kw),
        plain=lambda: plain_of(kernels, name)(*args, **kw), library=None,
        shape=f"a {phase} delta level: {m} listed rows x {p} pair(s) of "
        f"{c} slots, into {rep} replica(s)",
        rows_joined=m * p,
        bytes=per * m * p * c * 2 + per * m * c * (p if not scatter else rep)
        + 4 * m + 4, operations=ops(2 * c, m * p))


def longest_walk(ops, K, codes) -> int:
    """The most live lanes (op code in ``codes``) of one view that gather
    one row: the longest of an apply's sequential row walks, counted on
    the host from the op lanes."""
    op = ops["op"].cpu().numpy()
    key = ops["key"].cpu().numpy().astype(np.int64)
    row = np.clip(np.where(key < 0, key + K, key), 0, K - 1)
    live = np.isin(op, codes)
    view = np.broadcast_to(np.arange(op.shape[0])[:, None], op.shape)
    return int(np.bincount((view * K + row)[live]).max(initial=0))


def typed_kernel_rows(kernels, calls):
    """Rows of the kernels line for the eight LWW-Set and MVRegister
    wrappers, each on a recorded main-path call (typed_kernel_checks): the
    applies and captures on the consensus phases' calls with the most
    live lanes, the unions and merges on typed_store's. Bytes: each input
    read once and each output written once; an apply reads a live lane's
    fields, only the op of a lane that is not live (grouping the live
    lanes exists so that no other field of it is read), writes a
    capture's ok or wclock for every lane, and moves the rows its live
    lanes gather and write back, not the whole state. Operations: a union
    one per record; an LWW-Set apply one per slot of its row per live
    lane; an MVRegister apply the frontier of V + 1 entries, 2 (V + 1)^2
    W compares, at a row's first write and 2 V W at each later one (the
    row is a frontier then), V W for an observed max; a merge 2 (Va +
    Vb)^2 W per row. The applies' plain versions (thousands of small
    launches a call) are timed, not profiled."""
    rows = []
    for name in ("lww_union", "mvr_merge", "lww_union_rows",
                 "mvr_merge_rows"):
        if name.startswith("lww"):
            per, ops = 21, (lambda n, r: n * r)
        else:
            wl = calls[name][0][0]["clock"].shape[-1]
            per, ops = 5 + 4 * wl, (lambda n, r, wl=wl: 2 * n * n * wl * r)
        rows.append(union_level_row(kernels, name, calls[name], per, ops,
                                    "typed_store"))
    for name, codes in (("lww_apply", (1, 2)), ("lww_capture", (1, 2)),
                        ("mvr_apply", (1,)), ("mvr_capture", (1,))):
        (state, ops), kw = calls[name]
        V, K, c = state["valid"].shape
        Bn = ops["op"].shape[1]
        read, written = rows_touched(state["valid"], ops, codes)
        live = live_lanes(ops, codes)
        capture = name.endswith("capture")
        if name.startswith("lww"):
            # a live lane: op, key, a0, a1, a2 (and ok, captured); the
            # capture writes every lane's ok
            row_b = 21 * c
            lane_b = 20 + 4 * ("ok" in ops)
            out_b = 4 * V * Bn if capture else 0
            n_ops = live * c
        else:
            # a live lane: op, key, a0, writer (and wclock, captured); the
            # capture writes every lane's wclock. A row's first write
            # takes the frontier of its V + 1 entries, 2 (V + 1)^2 W
            # compares; a later one joins the singleton to a frontier,
            # 2 V W; the observed max (uncaptured, capture) is V W a write
            wl = state["clock"].shape[-1]
            row_b = c * (5 + 4 * wl)
            lane_b = 16 + 4 * wl * ("wclock" in ops)
            out_b = 4 * wl * V * Bn if capture else 0
            joins = (read * 2 * (c + 1) ** 2 * wl
                     + (live - read) * 2 * c * wl)
            captured = "wclock" in ops
            n_ops = ((0 if captured else live * c * wl)
                     + (joins if captured or capture else 0))
        extra = ({"longest_walk": longest_walk(ops, K, codes)}
                 if name.startswith("mvr") else
                 {"walk_stats": lww_walk_stats(state, ops)})
        rows.append(dict(
            name=name, **extra, call=lambda n=name, s=state, o=ops:
                kernels.WRAPPERS[n](s, o),
            plain=lambda n=name, s=state, o=ops: plain_of(kernels, n)(s, o),
            library=None, shape=f"{'lww' if name[0] == 'l' else 'mvr'}"
            f"_consensus {'submit' if capture else 'delta apply'}: "
            f"V{V} K{K} C{c} B{Bn}, {live} live lanes",
            rows_read=read, rows_written=written,
            bytes=(lane_b * live + 4 * (V * Bn - live) + out_b + 4 * V
                   + row_b * (read + written)),
            operations=n_ops, profile_plain=False))
    for row in rows:
        row["library_note"] = TYPED_LIBRARY_NOTES[row["name"]]
    return rows


# -- the 2P-Set and the 2P2P Graph -------------------------------------------

def tp_kv(dev, kind, g):
    """A SafeKV for the 2P-Set (``kind`` "tpset", TPSET_CONS) or the Graph
    ("graph", GRAPH_CONS)."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import graph, tpset
    from janus_tpu_torch.runtime.safecrdt import SafeKV

    n, w, b, k = (g[x] for x in ("nodes", "window", "ops_per_block", "keys"))
    if kind == "tpset":
        return SafeKV(DagConfig(n, w), tpset.SPEC, ops_per_block=b,
                      device=dev, num_keys=k, capacity=g["capacity"])
    return SafeKV(DagConfig(n, w), graph.SPEC, ops_per_block=b, device=dev,
                  num_keys=k, v_capacity=g["v_capacity"],
                  e_capacity=g["e_capacity"])


def tp_stream(workloads, kind, g, rounds):
    """The phase's op batches (int32 numpy ``[N, B]``) of ``rounds``
    rounds, drawn from its seed."""
    rng = np.random.default_rng(g["seed"])
    n, b, k = g["nodes"], g["ops_per_block"], g["keys"]
    if kind == "tpset":
        return [workloads.tpset_add_remove(rng, n, k, b, num_elems=g["elems"])
                for _ in range(rounds)]
    return [workloads.graph_ops(rng, n, k, b, num_vertices=g["vertices"],
                                out_degree=g["out_degree"])
            for _ in range(rounds)]


def tp_store_stream(workloads, ticks):
    """TP_STORE's op batches: per tick ``{"tpset": ..., "graph": ...}``
    int32 numpy ``[R, B]``, keys Zipf-skewed in a hot window of D/2 keys
    rotating every tick (harness preset mixed_delta's traffic shape)."""
    g = TP_STORE
    R, K, B, hot = g["R"], g["K"], g["B"], g["budget"] // 2
    rng = np.random.default_rng(g["seed"])
    return [{"tpset": workloads.tpset_add_remove(
                 rng, R, K, B, num_elems=g["elems"], hot=hot, tick=t),
             "graph": workloads.graph_ops(
                 rng, R, K, B, num_vertices=g["vertices"],
                 out_degree=g["out_degree"], hot=hot, tick=t)}
            for t in range(ticks)]


def tp_store_arms(dev):
    """The phase's two Stores: a full arm and a delta arm at D."""
    from janus_tpu_torch.runtime.store import Store

    g = TP_STORE
    types = {"tpset": dict(num_keys=g["K"], capacity=g["tp_capacity"]),
             "graph": dict(num_keys=g["K"], v_capacity=g["v_capacity"],
                           e_capacity=g["e_capacity"])}
    return {"full": (Store(g["R"], types, device=dev), False),
            f"delta_D{g['budget']}": (Store(g["R"], types,
                                            dirty_budget=g["budget"],
                                            device=dev), True)}


def tp_level1(name, args, kw):
    """The tree ("tpset", "vertex" or "edge") of a call of a 2P union
    wrapper ``name`` that is level 1 of one of ``tp_store``'s converge
    trees, else None: the full mode's level 1 joins the two halves of
    TP_STORE's R replicas, the row-list mode's gathers its rows from the
    state."""
    a = args[0]
    if name.endswith("_rows"):
        if not kw.get("gather", True):
            return None
    elif a["valid"].shape[0] != (TP_STORE["R"] + 1) // 2:
        return None
    if name.startswith("edge"):
        return "edge"
    return ("tpset" if a["valid"].shape[-1] == TP_STORE["tp_capacity"]
            else "vertex")


def union_edge_cases(dev, kernels, log, rng, layouts, geo):
    """Edge cases of warp-merge unions, kernel against plain: for each
    ``(layout, wrapper name, cases, make)`` of ``layouts`` (``make(rng,
    case, lead, c)`` a case's rows, numpy) at ``geo``'s rows and
    capacities: fresh at a capacity below, at and above one row's, into
    two planes (the broadcast), aliased (``out`` the first input, as the
    converge's last level writes into the replicas it read), with rows of
    unequal widths, and the row-list tree over states of ``geo``'s
    replicas with 0, 1 and all rows listed (at 2 its one level writes the
    rows it read)."""
    from janus_tpu_torch.kernels.replica_tree import join_tree_rows

    k = geo["rows"]

    def on(t):
        return {f: torch.as_tensor(x, device=dev) for f, x in t.items()}

    for layout, name, names, make in layouts:
        for c in geo["capacities"]:
            for case in names:
                a, b = (on(t) for t in make(rng, case, (2, k), c))
                what = f"edge {case} 2x{k} C{c}"
                for cap in (c // 2, c, 3 * c):
                    log.add(kernels, name, (a, b, cap), f"{what} cap {cap}")
                out = {f: torch.zeros((2, 2, k, c), dtype=x.dtype, device=dev)
                       for f, x in a.items()}
                log.add(kernels, name, (a, b, c), what + " out",
                        {"out": out})
                narrow = {f: x[..., : c // 3].contiguous()
                          for f, x in b.items()}
                log.add(kernels, name, (a, narrow, c), what + " narrow b")
                mine = tree_map(torch.Tensor.clone, a)
                kernels.WRAPPERS[name](mine, b, c, out={
                    f: x.unsqueeze(0) for f, x in mine.items()})
                ref, _ = plain_of(kernels, name)(a, b, c)
                torch.cuda.synchronize()
                err = tree_err(mine, ref)
                check(err == 0, f"{name} {what} aliased: max_abs_err {err}")
                log.by[name]["cases"] += 1
                for r in geo["replicas"]:
                    more = make(rng, case, (2, k), c)
                    reps = [{f: x[i] for f, x in t.items()}
                            for t in (a, b, *map(on, more)) for i in (0, 1)]
                    st = {f: torch.stack([x[f] for x in reps[:r]])
                          for f in layout.fields}
                    rows = torch.as_tensor(
                        rng.permutation(k).astype(np.int32), device=dev)
                    for n_rows in (0, 1, k):
                        n = torch.tensor(n_rows, dtype=torch.int32,
                                         device=dev)
                        check_calls(
                            kernels, log, (name + "_rows",),
                            lambda: join_tree_rows(
                                layout.fields,
                                getattr(kernels, name + "_rows"), st, rows, n),
                            f"{what} rows R{r} n{n_rows}")


def tp_edge_cases(dev, kernels, workloads, log, rng):
    """The 2P unions' edge cases (``workloads.tp_union_case``) for both
    layouts at ``TP_UNION_EDGE``'s rows and capacities
    (``union_edge_cases``)."""
    from janus_tpu_torch.kernels.slot_union import EDGE, TP

    union_edge_cases(dev, kernels, log, rng, [
        (layout, name, workloads.TP_UNION_CASES,
         lambda rng, case, lead, c, e=layout is EDGE:
             workloads.tp_union_case(rng, case, lead, c, edges=e))
        for layout, name in ((TP, "tp_union"), (EDGE, "edge_union"))],
        TP_UNION_EDGE)


def lww_edge_cases(dev, kernels, workloads, log, rng):
    """The LWW union's edge cases (``workloads.lww_union_case``) at
    ``LWW_UNION_EDGE``'s rows and capacities (``union_edge_cases``)."""
    from janus_tpu_torch.kernels.slot_union import LWW

    union_edge_cases(dev, kernels, log, rng, [
        (LWW, "lww_union", workloads.LWW_UNION_CASES,
         workloads.lww_union_case)], LWW_UNION_EDGE)


def typed_level1(name, args, kw):
    """Whether a call of ``lww_union`` or ``lww_union_rows`` is level 1 of
    ``typed_store``'s LWW converge tree: the full mode's level 1 joins the
    two halves of TYPED_STORE's R replicas, the row-list mode's gathers its
    rows from the state."""
    if name.endswith("_rows"):
        return kw.get("gather", True)
    return args[0]["valid"].shape[0] == (TYPED_STORE["R"] + 1) // 2


def tp_kernel_checks(dev, kernels, workloads, cases):
    """The nine 2P-Set and Graph wrappers against their plain versions on
    the card, bit-equal, in-place updates, drop and overflow counts
    included: (a) random inputs: canonical and non-canonical rows (a key
    twice in a row, one copy tombstoned), full rows that drop, hazard ops
    (keys in [-2K, 2K), op codes from -1 to 5, self-loops, endpoints at
    INT32_MAX), rows hammered by more lanes than a row's bucket holds,
    the trees' row-list levels (gather, scratch, scatter), masks with the
    sentinel quirk, CV = 0, and the main paths' widths, and the walk's
    edge cases (``workloads.graph_walk_case``, their plain versions on the
    host) at each instantiation's widths; (b) every call of
    the first rounds of tpset_consensus and graph_consensus (edge_count of
    the prospective views after each) and of the first ticks and the late
    tick of both tp_store arms, repeated here with their seeds (the ticks
    between unchecked). Returns, per wrapper,
    one recorded main-path call to time: an apply's with the most live
    lanes, edge_mask's with the most live edges, a union's on the most
    slots (the 2P-Set's tree, where the Graph's vertex tree has the same
    wrapper)."""
    t_start = time.perf_counter()
    log = CaseLog(TP_KERNELS)
    rng = np.random.default_rng(43)
    cover = {"overflow": 0, "tp_drops": 0, "graph_drops": 0, "ok_zero": 0,
             "hot_lanes": 0, "quirk_edges": 0}
    section_s = {}

    def lap(name):
        torch.cuda.synchronize()
        section_s[name] = time.perf_counter() - t_start - sum(
            section_s.values())

    def on(tree):
        return {f: torch.as_tensor(np.asarray(x), device=dev)
                for f, x in tree.items()}

    # (a) random inputs
    for edges, lead, ca, cb, canonical in TP_CHECKS["unions"]:
        kw = dict(canonical=canonical, dup_rows=0.3, full_rows=0.5,
                  edges=edges)
        a = on(workloads.tp_slots(rng, lead, ca, **kw))
        b = on(workloads.tp_slots(rng, lead, cb, **kw))
        name = "edge_union" if edges else "tp_union"
        what = f"{'x'.join(map(str, lead))} C{ca}+{cb}"
        _, ovf = log.add(kernels, name, (a, b, ca), what)
        cover["overflow"] += int(ovf.sum())
        out = {f: torch.empty((2,) + lead + (ca,), dtype=x.dtype, device=dev)
               for f, x in a.items()}
        log.add(kernels, name, (a, b, ca), what + " into 2 replicas",
                {"out": out})
    lap("unions")
    tp_edge_cases(dev, kernels, workloads, log, np.random.default_rng(44))
    lap("edge_cases")
    for layout, p, k, c in TP_CHECKS["row_levels"]:
        edges = layout == "edge"
        name = "edge_union_rows" if edges else "tp_union_rows"

        def make(lead):
            return on(workloads.tp_slots(rng, lead, c, canonical=False,
                                         dup_rows=0.2, full_rows=0.3,
                                         edges=edges))
        rows = torch.as_tensor(rng.permutation(k).astype(np.int32), device=dev)
        for n_rows in (k, k // 3, 0):
            n_t = torch.tensor(n_rows, dtype=torch.int32, device=dev)
            a, b, o = make((p, k)), make((p, k)), make((p, k))
            log.add(kernels, name, (a, b, o, rows, n_t),
                    f"P{p} K{k} C{c} n {n_rows} gather")
            log.add(kernels, name, (a, b, o, rows, n_t),
                    f"P{p} K{k} C{c} n {n_rows} scratch", {"gather": False})
            log.add(kernels, name, ({f: x[:1] for f, x in a.items()},
                                    {f: x[:1] for f, x in b.items()},
                                    make((3, k)), rows, n_t),
                    f"R3 K{k} C{c} n {n_rows} scatter", {"scatter": True})
    lap("row_levels")
    for v, k, c, b, mode, keys in TP_CHECKS["tp_applies"]:
        st = on(workloads.tp_slots(rng, (v, k), c, canonical=False,
                                   dup_rows=0.3, full_rows=0.4,
                                   num_elems=2 * c))
        ops = workloads.tp_mixed_ops(rng, (v, b), k, 2 * c,
                                     hazards=keys != "flat",
                                     captured=mode == "captured")
        if keys == "hot":
            ops["key"][:, : 9 * b // 10] = 1
            cover["hot_lanes"] += 9 * b // 10
        what = f"{mode} V{v} K{k} C{c} B{b} {keys}"
        dops = workloads.ops_to_device(ops, dev)
        if mode == "capture":
            ok, drop = log.add(kernels, "tpset_capture", (st, dops), what)
            cover["ok_zero"] += int((ok == 0).sum())
        else:
            drop = log.add(kernels, "tpset_apply", (st, dops), what)
        cover["tp_drops"] += int(drop.sum())
    lap("tp_applies")
    for v, k, cv, ce, nv, b, mode, keys in TP_CHECKS["graph_applies"]:
        st = on(workloads.graph_slots(rng, (v, k), cv, ce, nv,
                                      canonical=False, dup_rows=0.3,
                                      full_rows=0.4, at_max=0.05))
        ops = workloads.graph_mixed_ops(rng, (v, b), k, nv,
                                        hazards=keys != "flat",
                                        captured=mode == "captured")
        if keys == "hot":
            ops["key"][:, : 9 * b // 10] = 1
            cover["hot_lanes"] += 9 * b // 10
        what = f"{mode} V{v} K{k} CV{cv} CE{ce} B{b} {keys}"
        dops = workloads.ops_to_device(ops, dev)
        if mode == "capture":
            ok, drop = log.add(kernels, "graph_capture", (st, dops), what)
            cover["ok_zero"] += int((ok == 0).sum())
        else:
            drop = log.add(kernels, "graph_apply", (st, dops), what)
        cover["graph_drops"] += int(drop.sum())
    lap("graph_applies")
    v, k, nv, b = TP_CHECKS["walk_geometry"]
    for kind, cv, ce in TP_CHECKS["walks"]:
        fields = (("op", "key", "a0", "a1") if kind == "graph"
                  else ("op", "key", "a0"))
        for case in workloads.GRAPH_WALK_CASES:
            st, ops = workloads.graph_walk_case(rng, case, v, k, cv, ce, nv,
                                                b, edges=kind == "graph")
            st = on(st)
            for mode in (("captured",) if case == "long"
                         else ("apply", "captured", "capture")):
                o = ops if mode == "captured" else {f: ops[f] for f in fields}
                name = f"{kind}_{'capture' if mode == 'capture' else 'apply'}"
                log.add(kernels, name, (st, workloads.ops_to_device(o, dev)),
                        f"walk {case} {mode} V{v} K{k} C{cv}+{ce} B{b}",
                        host_plain=True)
    lap("walks")
    for lead, cv, ce, nv, at_max in TP_CHECKS["masks"]:
        st = on(workloads.graph_slots(rng, lead, cv, ce, nv, canonical=False,
                                      dup_rows=0.3, at_max=at_max))
        out = log.add(kernels, "edge_mask", (st,),
                      f"{'x'.join(map(str, lead))} CV{cv} CE{ce}")
        at_sent = (st["src"] == 2**31 - 1) | (st["dst"] == 2**31 - 1)
        cover["quirk_edges"] += int((out & at_sent).sum())
    lap("masks")

    random_s = time.perf_counter() - t_start
    # (b) recorded main-path calls, each checked as it is made
    keep = {}
    apply_codes = {"tpset_apply": (1, 2), "tpset_capture": (1, 2),
                   "graph_apply": (1, 2, 3, 4), "graph_capture": (1, 2, 3, 4)}
    tag = {"run": "", "arm": "", "ticks": "", "quiet": False}
    # level 1 of each tp_store tree, per arm and for the first ticks and
    # the late one: its input rows already in key order, the rows holding
    # a valid record, and the tail lengths of the unsorted (row_order)
    level1 = {}

    def level1_spy(name, fn):
        def call(*args, **kw):
            tree = tp_level1(name, args, kw)
            if tree is not None and not tag["quiet"]:
                record_level1(level1, f"{tag['arm']} {tree} {tag['ticks']}",
                              name, args, ("src", "dst") if tree == "edge"
                              else ("elem",))
            return fn(*args, **kw)
        return call

    def recorded():
        for kind, g in (("tpset", TPSET_CONS), ("graph", GRAPH_CONS)):
            tag["run"] = f"{kind}_consensus"
            kv = tp_kv(dev, kind, g)
            for ops in tp_stream(workloads, kind, g, TP_CHECKS["rounds"]):
                kv.step(workloads.ops_to_device(ops, dev))
                if kind == "graph":
                    kv.query_prospective("edge_count")
            del kv
        tag["run"] = "tp_store"
        arms = tp_store_arms(dev)
        inner = {n: getattr(kernels, n) for n in TP_KERNELS[:4]}
        for n, fn in inner.items():
            setattr(kernels, n, level1_spy(n, fn))
        first, late = TP_CHECKS["ticks"], TP_CHECKS["late_tick"]
        try:
            for t, tick in enumerate(tp_store_stream(workloads, late + 1)):
                tag["quiet"] = first <= t < late
                tag["ticks"] = (f"ticks 0-{first - 1}" if t < first
                                else f"tick {t}")
                batch = {tc: workloads.ops_to_device(o, dev)
                         for tc, o in tick.items()}
                for arm, (st, use_delta) in arms.items():
                    tag["arm"] = arm
                    st.fused_tick(batch, delta=use_delta)
        finally:
            tag["quiet"] = False
            for n, fn in inner.items():
                setattr(kernels, n, fn)

    counts = check_calls(
        kernels, log, TP_KERNELS, recorded,
        lambda name, i: f"recorded {tag['run']} call {i}", keep=keep,
        score=lambda name, args: (
            live_lanes(args[1], apply_codes[name]) if name in apply_codes
            else int((args[0]["e_valid"] & ~args[0]["e_removed"]).sum())
            if name == "edge_mask" else args[0]["valid"].numel()),
        aliased=True, skip=lambda: tag["quiet"])
    torch.cuda.synchronize()
    check(all(counts[n] > 0 for n in TP_KERNELS),
          f"tp_kernels: recorded calls {counts}")
    check(all(v > 0 for v in cover.values()), f"tp_kernels: coverage {cover}")
    check(len(level1) == 12 and all(r[1] > 0 for r in level1.values()),
          f"tp_kernels: level-1 rows of tp_store {sorted(level1)}")
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "tp_kernels", **rec})
    emit("tp_kernels", by_kernel=log.by, coverage=cover,
         level1_rows_sorted=level1_report(level1),
         random_seconds=random_s, random_seconds_by_section=section_s,
         recorded_seconds=time.perf_counter() - t_start - random_s,
         recorded={"rounds": TP_CHECKS["rounds"], "ticks": TP_CHECKS["ticks"],
                   "late_tick": TP_CHECKS["late_tick"], "calls": counts})
    return keep


def lane_waves(groups):
    """``(order, rank)`` of lanes grouped by ``groups`` (int64, one per
    live lane, in lane order): ``order`` sorts the lanes by group, stably,
    and ``rank[i]`` is lane ``order[i]``'s place in its group, so the lanes
    of rank t touch distinct groups."""
    order = np.argsort(groups, kind="stable")
    grp = groups[order]
    pos = np.arange(grp.size)
    first = np.r_[True, grp[1:] != grp[:-1]] if grp.size else pos > 0
    return order, pos - np.maximum.accumulate(np.where(first, pos, 0))


def tp_touched_rows(state, ops, codes):
    """The keys the live lanes (op code in ``codes``) of one call name,
    int64 numpy ``[Ku]`` ascending, and the state's rows at them, numpy
    ``[V, Ku, C]`` per leaf (gathered on the card, so only those rows are
    copied)."""
    live = torch.zeros_like(ops["op"], dtype=torch.bool)
    for c in codes:
        live |= ops["op"] == c
    keys = torch.unique(ops["key"][live].long())
    rows = {f: x.index_select(1, keys).cpu().numpy() for f, x in state.items()}
    return keys.cpu().numpy(), rows


def tp_gate_model(keys, rows, ops, E, changed):
    """Independent numpy model of the 2P-Set capture's gate on one call:
    ``rows`` the views' rows at ``keys`` as the capture read them (numpy
    ``[V, Ku, C]``), ``ops`` their batches (numpy ``[V, B]``). Per (view,
    key, elem) a status, absent, live or removed; lane by lane in lane
    order, a remove's ``ok`` is its elem's being live as the batch's earlier
    lanes left it, and then removes it; an add makes an absent elem live.
    Every other lane's ``ok`` is 1. Adds to ``changed`` the lanes of each
    op ("a", "r") that changed the status. Returns int32 ``[V, B]``."""
    V, Ku, C = rows["valid"].shape
    idx = np.flatnonzero(rows["valid"])
    el = rows["elem"].reshape(-1)[idx]
    check(((el >= 0) & (el < E)).all(), "tp gate model: an elem outside "
          "[0, E)")
    at = idx // C * E + el
    status = np.zeros(V * Ku * E, np.int8)    # 0 absent, 1 live, 2 removed
    status[at] = np.where(rows["removed"].reshape(-1)[idx], 2, 1)
    check(np.count_nonzero(status) == at.size, "tp gate model: an elem "
          "twice in a row")
    ok = np.ones(ops["op"].shape, np.int32)
    lv, lb = np.nonzero((ops["op"] == 1) | (ops["op"] == 2))
    ki = np.searchsorted(keys, ops["key"][lv, lb])
    el = ops["a0"][lv, lb]
    check(((el >= 0) & (el < E)).all(), "tp gate model: an elem out of "
          "range")
    order, rank = lane_waves((lv * Ku + ki) * E + el)
    lv, lb = lv[order], lb[order]
    grp = ((lv * Ku + ki[order]) * E + el[order])
    is_add = ops["op"][lv, lb] == 1
    for t in range(int(rank.max()) + 1 if rank.size else 0):
        w = rank == t   # one lane of each group: distinct groups
        g, a = grp[w], is_add[w]
        new = status[g[a]] == 0
        status[g[a]] = np.where(new, 1, status[g[a]])
        hit = status[g[~a]] == 1
        changed["a"] += int(new.sum())
        changed["r"] += int(hit.sum())
        status[g[~a]] = np.where(hit, 2, status[g[~a]])
        ok[lv[w][~a], lb[w][~a]] = hit
    return ok


def tp_fold_model(stream, oks, K, E):
    """Independent numpy model of the 2P-Set after every op of ``stream``
    (the accepted batches) replayed with the captured ``oks``: an elem is
    held if any add or any remove with ``ok`` named it, tombstoned if such
    a remove did (replay is order-free). Returns ``(held, removed)`` bool
    ``[K, E]``."""
    held = np.zeros(K * E, bool)
    removed = np.zeros(K * E, bool)
    for ops, ok in zip(stream, oks):
        at = ops["key"].astype(np.int64) * E + ops["a0"]
        rm = (ops["op"] == 2) & (ok == 1)
        held[at[(ops["op"] == 1) | rm]] = True
        removed[at[rm]] = True
    return held.reshape(K, E), removed.reshape(K, E)


def tp_rows_of_model(present, removed, C, names=("elem",)):
    """The canonical rows ``[K, C]`` a model's status gives: the held keys
    in ascending order with their tombstones, SENTINEL after. ``present``
    is bool ``[K, E]`` over one key, or ``[K, E, E]`` over (src, dst)
    pairs (``names`` the key fields)."""
    K = present.shape[0]
    sent = np.iinfo(np.int32).max
    out = {f: np.full((K, C), sent, np.int32) for f in names}
    out["removed"] = np.zeros((K, C), bool)
    out["valid"] = np.zeros((K, C), bool)
    flat = present.reshape(K, -1)
    n = flat.sum(-1)
    check(int(n.max(initial=0)) <= C, f"tp model: a key holds {n.max()} "
          f"records, more than C={C}")
    k, idx = np.nonzero(flat)   # row-major: ascending per key
    slot = np.arange(k.size) - np.repeat(np.cumsum(n) - n, n)
    if len(names) == 1:
        out[names[0]][k, slot] = idx
    else:
        side = present.shape[-1]
        out[names[0]][k, slot], out[names[1]][k, slot] = idx // side, idx % side
    out["removed"][k, slot] = removed.reshape(K, -1)[k, idx]
    out["valid"][k, slot] = True
    return out


def graph_gate_model(keys, rows, ops, NV, changed):
    """Independent numpy model of the Graph capture's gates on one call:
    ``rows`` the views' rows at ``keys`` as the capture read them,
    ``ops`` their batches. Per (view, key) a vertex status over the NV ids
    and an edge status over (src, dst) pairs (absent, live or removed);
    lane by lane in lane order: rv passes if its vertex is live with no
    live edge from or to it, ae if both endpoints are live, re if the edge
    is live, every other code passes; a passing op then applies (av makes
    an absent vertex live, rv removes it, ae makes an absent edge live, re
    removes it). Adds to ``changed`` the lanes of each op ("av", "rv",
    "ae", "re") that changed a status. Returns the ``ok`` int32 ``[V,
    B]``."""
    V, Ku, CV = rows["v_valid"].shape
    CE = rows["e_valid"].shape[-1]
    vs = np.zeros((V * Ku, NV), np.int8)
    es = np.zeros((V * Ku, NV, NV), np.int8)
    idx = np.flatnonzero(rows["v_valid"])
    x = rows["v"].reshape(-1)[idx]
    check(((x >= 0) & (x < NV)).all(), "graph model: a vertex out of range")
    vs[idx // CV, x] = np.where(rows["v_removed"].reshape(-1)[idx], 2, 1)
    check(np.count_nonzero(vs) == idx.size, "graph model: a vertex twice "
          "in a row")
    idx = np.flatnonzero(rows["e_valid"])
    s, d = rows["src"].reshape(-1)[idx], rows["dst"].reshape(-1)[idx]
    check(((s >= 0) & (s < NV) & (d >= 0) & (d < NV)).all(),
          "graph model: an endpoint out of range")
    es[idx // CE, s, d] = np.where(rows["e_removed"].reshape(-1)[idx], 2, 1)
    check(np.count_nonzero(es) == idx.size, "graph model: an edge twice in "
          "a row")
    ok = np.ones(ops["op"].shape, np.int32)
    lv, lb = np.nonzero((ops["op"] >= 1) & (ops["op"] <= 4))
    g = lv * Ku + np.searchsorted(keys, ops["key"][lv, lb])
    order, rank = lane_waves(g)
    lv, lb, g = lv[order], lb[order], g[order]
    code, x, y = (ops[f][lv, lb] for f in ("op", "a0", "a1"))
    for t in range(int(rank.max()) + 1 if rank.size else 0):
        w = rank == t
        gw, cw, xw, yw = g[w], code[w], x[w], y[w]
        vx, vy, ex = vs[gw, xw], vs[gw, yw], es[gw, xw, yw]
        incident = ((es[gw, xw, :] == 1).any(-1)
                    | (es[gw, :, xw] == 1).any(-1))
        gate = np.where(cw == 2, (vx == 1) & ~incident,
                        np.where(cw == 3, (vx == 1) & (vy == 1),
                                 np.where(cw == 4, ex == 1, True)))
        ok[lv[w], lb[w]] = gate
        av, rv = cw == 1, (cw == 2) & gate
        ae, re = (cw == 3) & gate, (cw == 4) & gate
        changed["av"] += int((vx[av] == 0).sum())
        changed["rv"] += int(rv.sum())
        changed["ae"] += int((ex[ae] == 0).sum())
        changed["re"] += int(re.sum())
        vs[gw[av], xw[av]] = np.where(vx[av] == 0, 1, vx[av])
        vs[gw[rv], xw[rv]] = 2
        es[gw[ae], xw[ae], yw[ae]] = np.where(ex[ae] == 0, 1, ex[ae])
        es[gw[re], xw[re], yw[re]] = 2
    return ok


def graph_fold_model(stream, oks, K, NV):
    """Independent numpy model of the Graph after every op of ``stream``
    replayed with the captured ``oks``: a vertex is held if an av or a
    passing rv named it, removed if a passing rv did; an edge is held if a
    passing ae or re named it, removed if a passing re did. Returns
    ``(v_held, v_removed [K, NV], e_held, e_removed [K, NV, NV])``."""
    vh, vr = np.zeros(K * NV, bool), np.zeros(K * NV, bool)
    eh, er = np.zeros(K * NV * NV, bool), np.zeros(K * NV * NV, bool)
    for ops, ok in zip(stream, oks):
        key = ops["key"].astype(np.int64)
        code, gate = ops["op"], ok == 1
        vat = key * NV + ops["a0"]
        eat = (key * NV + ops["a0"]) * NV + ops["a1"]
        rv, ae, re = (code == 2) & gate, (code == 3) & gate, (code == 4) & gate
        vh[vat[(code == 1) | rv]] = True
        vr[vat[rv]] = True
        eh[eat[ae | re]] = True
        er[eat[re]] = True
    return (vh.reshape(K, NV), vr.reshape(K, NV), eh.reshape(K, NV, NV),
            er.reshape(K, NV, NV))


def tp_consensus(dev, kernels, workloads, kind):
    """The 2P-Set (``kind`` "tpset", TPSET_CONS) or the Graph ("graph",
    GRAPH_CONS) through SafeKV on the card: warm-up rounds, the timed
    rounds (the Graph's edge_count of the prospective views after each, as
    LookupEdges reads it; the live counts after the rounds of
    ``live_after``, kept on the card until the clock stops), idle rounds
    until every view's stable state is bit-equal, a record pass (the same
    rounds on a fresh SafeKV, untimed, bit-equal to the timed run at its
    end), then a few profiled rounds. Checks: every batch accepted; no
    slot dropped; the stable views bit-equal; every view's prospective
    state holds the stable records by key; each wrapper launched as often
    as a round calls it; each capture's ``ok`` decided in numpy from the
    rows it read (``tp_gate_model`` / ``graph_gate_model``), and the stable
    state equal to a numpy fold of the committed ops with those ``ok``
    (``tp_fold_model`` / ``graph_fold_model``); the Graph's stable
    edge_count equal to a numpy dangling-edge filter of the model."""
    from janus_tpu_torch.kernels.tp_rows import (canonical_row, edge_view,
                                                 vertex_view)
    from janus_tpu_torch.models import graph, tpset

    g = TPSET_CONS if kind == "tpset" else GRAPH_CONS
    n, b, k = (g[x] for x in ("nodes", "ops_per_block", "keys"))
    total = g["warmup"] + g["rounds"]
    stream = tp_stream(workloads, kind, g, total + g["profile_rounds"])
    batches = [workloads.ops_to_device(o, dev) for o in stream]
    idle = workloads.ops_to_device(
        {f: np.zeros((n, b), np.int32) for f in stream[0]}, dev)
    kv = tp_kv(dev, kind, g)
    counted = {}   # round -> device counts, read after the clock stops

    def per_round(r):
        if kind == "graph":
            edges = kv.query_prospective("edge_count")
        if r in g["live_after"]:
            counted[r] = ([tpset.live_count(kv.prospective)[0].sum()]
                          if kind == "tpset" else
                          [graph.vertex_count(kv.prospective)[0].sum(),
                           edges[0].sum()])

    run = consensus_rounds(
        kernels, kv, batches, idle, g, kind,
        lambda stepped: {f"{kind}_capture": stepped,
                         f"{kind}_apply": 2 * stepped,
                         **({"edge_mask": g["rounds"]} if kind == "graph"
                            else {})},
        per_round)
    idle_rounds = run["idle_rounds"]
    check(kv.stats["slots_dropped"] == 0, f"{kind}_consensus: "
          f"{kv.stats['slots_dropped']} slot records dropped")
    if kind == "tpset":
        views = [(canonical_row(kv.prospective), canonical_row(kv.stable))]
    else:
        views = [(canonical_row(vertex_view(kv.prospective)),
                  canonical_row(vertex_view(kv.stable))),
                 (canonical_row(edge_view(kv.prospective), ("src", "dst")),
                  canonical_row(edge_view(kv.stable), ("src", "dst")))]
    for prosp, stab in views:
        check(all(torch.equal(prosp[f], stab[f]) for f in stab),
              f"{kind}_consensus: a view's prospective state holds other "
              f"records than the stable one")

    # the record pass: each capture's touched rows and ops, its gate
    # decided in numpy at once
    t_rec = time.perf_counter()
    again = tp_kv(dev, kind, g)
    codes = (1, 2) if kind == "tpset" else (1, 2, 3, 4)
    spent = {"copy": 0.0, "model": 0.0}
    labels = ("a", "r") if kind == "tpset" else ("av", "rv", "ae", "re")
    changed = dict.fromkeys(labels, 0)

    def take(_, args, kw):
        state, ops = args
        t_take = time.perf_counter()
        host = {f: x.cpu().numpy() for f, x in ops.items()}
        keys, rows = tp_touched_rows(state, ops, codes)
        t_model = time.perf_counter()
        ok = (tp_gate_model(keys, rows, host, g["elems"], changed)
              if kind == "tpset" else
              graph_gate_model(keys, rows, host, g["vertices"], changed))
        spent["copy"] += t_model - t_take
        spent["model"] += time.perf_counter() - t_model
        return host, ok

    def rerun():
        for t in range(total):
            again.step(batches[t])

    name = f"{kind}_capture"
    rec = record_calls(kernels, (name,), rerun, take=take)[name]
    for _ in range(idle_rounds):
        again.step(idle, record=False)
    for f in kv.stable:
        check(torch.equal(again.stable[f], kv.stable[f])
              and torch.equal(again.prospective[f], kv.prospective[f]),
              f"{kind}_consensus: the record pass's {f} differs from the "
              f"timed run's")
    check(again.stats["state_transfers"] == 0, f"{kind}_consensus: a state "
          f"transfer in the record pass (the models follow each view's own "
          f"applies)")
    del again
    check(len(rec) == total, f"{kind}_consensus: {len(rec)} captures "
          f"recorded")
    for t, (ops, _) in enumerate(rec):
        check(all(np.array_equal(ops[f], stream[t][f]) for f in ops),
              f"{kind}_consensus: round {t}'s captured ops differ from its "
              f"batch")
    oks = [ok for _, ok in rec]
    out = {}
    if kind == "tpset":
        held, removed = tp_fold_model(stream[:total], oks, k, g["elems"])
        want = tp_rows_of_model(held, removed, g["capacity"])
        got = {f: x[0].cpu().numpy() for f, x in views[0][1].items()}
        for f, x in want.items():
            check(np.array_equal(got[f], x), f"tpset_consensus: stable {f} "
                  f"differs from the numpy fold of the committed ops")
        rm = [o["op"] == 2 for o in stream[:total]]
        out.update(
            removes=int(sum(int(r.sum()) for r in rm)),
            removes_ok=int(sum(int((r & (x == 1)).sum())
                               for r, x in zip(rm, oks))),
            live_after_round={r: int(c[0]) for r, c in counted.items()},
            live_elements=int(tpset.live_count(kv.stable)[0].sum()),
            tombstones=int((kv.stable["removed"][0]
                            & kv.stable["valid"][0]).sum()))
        out["removes_ok_share"] = out["removes_ok"] / max(out["removes"], 1)
    else:
        nv = g["vertices"]
        vh, vr, eh, er = graph_fold_model(stream[:total], oks, k, nv)
        want = {**tp_rows_of_model(vh, vr, g["v_capacity"]),
                **{f"e_{f}": x for f, x in tp_rows_of_model(
                    eh, er, g["e_capacity"], ("src", "dst")).items()}}
        (_, vst), (_, est) = views
        got = {**{f: x[0].cpu().numpy() for f, x in vst.items()},
               **{f"e_{f}": x[0].cpu().numpy() for f, x in est.items()}}
        for f, x in want.items():
            check(np.array_equal(got[f], x), f"graph_consensus: stable {f} "
                  f"differs from the numpy fold of the committed ops")
        v_live = vh & ~vr
        e_live = eh & ~er & v_live[:, :, None] & v_live[:, None, :]
        counts = kv.query_stable("edge_count")
        check(np.array_equal(counts[0].cpu().numpy(),
                             e_live.sum((1, 2)).astype(np.int32)),
              "graph_consensus: stable edge_count differs from a numpy "
              "dangling-edge filter of the model")
        pass_share = {}
        for code, label in ((2, "rv"), (3, "ae"), (4, "re")):
            lanes = sum(int((o["op"] == code).sum()) for o in stream[:total])
            passed = sum(int(((o["op"] == code) & (x == 1)).sum())
                         for o, x in zip(stream[:total], oks))
            pass_share[label] = passed / max(lanes, 1)
        out.update(
            gate_pass_share=pass_share,
            after_round={r: {"vertices": int(c[0]), "edges": int(c[1])}
                         for r, c in counted.items()},
            live_vertices=int(graph.vertex_count(kv.stable)[0].sum()),
            live_edges=int(counts[0].sum()),
            dangling_edges=int((eh & ~er).sum() - e_live.sum()))
    # the share of each op's lanes that changed the state at its origin's
    # capture (an add of a held elem or a remove whose gate failed changes
    # nothing)
    lanes = {label: sum(int((o["op"] == code).sum()) for o in stream[:total])
             for code, label in enumerate(labels, 1)}
    out["changing_share"] = {label: changed[label] / max(lanes[label], 1)
                             for label in labels}
    out["changing_share_all"] = (sum(changed.values())
                                 / max(sum(lanes.values()), 1))
    out["record_pass_seconds"] = time.perf_counter() - t_rec
    out["record_pass_copy_seconds"] = spent["copy"]
    out["record_pass_model_seconds"] = spent["model"]

    def step(kv, ops):
        kv.step(ops)
        if kind == "graph":
            kv.query_prospective("edge_count")

    consensus_emit(kind, kv, g, batches[total:], run, step, **out)
    return run["launches"]


def tpset_consensus(dev, kernels, workloads):
    return tp_consensus(dev, kernels, workloads, "tpset")


def graph_consensus(dev, kernels, workloads):
    return tp_consensus(dev, kernels, workloads, "graph")


def tp_store(dev, kernels, workloads):
    """Both types through ``Store.fused_tick`` at harness preset
    mixed_delta's geometry (TP_STORE): a full arm (``join_replicas``, two
    trees for the Graph) and a delta arm at D (``converge_delta`` through
    the row-list trees), the same pre-generated streams, 24 timed ticks
    after one warm-up tick, the arms in turns (``store_arms``). After every
    tick: every leaf's replica rows bit-equal, the rows canonical (each
    block sorted by its keys), and the delta arm bit-equal to the full arm
    (the invariant ``converge_delta`` claims)."""
    from janus_tpu_torch.kernels.tp_rows import (canonical_row, edge_view,
                                                 vertex_view)
    from janus_tpu_torch.models import graph, tpset

    g = TP_STORE
    R, K, B, D, ticks = (g[x] for x in ("R", "K", "B", "budget", "ticks"))
    host = tp_store_stream(workloads, ticks + 1)
    batches = [{tc: workloads.ops_to_device(o, dev) for tc, o in h.items()}
               for h in host]

    def rows_ok(full, t):
        row0 = {tc: {f: x[0] for f, x in full.states[tc].items()}
                for tc in ("tpset", "graph")}
        for blk, keys in ((row0["tpset"], ("elem",)),
                          (vertex_view(row0["graph"]), ("elem",)),
                          (edge_view(row0["graph"]), ("src", "dst"))):
            canon = canonical_row(blk, keys)
            check(all(torch.equal(canon[f], blk[f]) for f in canon),
                  f"tp_store: a row is not canonical after tick {t}")

    levels = int(np.ceil(np.log2(R)))
    want = {"full": {"tpset_apply": 1, "graph_apply": 1,
                     "tp_union": 2 * levels, "edge_union": levels},
            f"delta_D{D}": {"tpset_apply": 1, "graph_apply": 1,
                            "dirty_rows": 2, "delta_select": 2,
                            "tp_union_rows": 2 * levels,
                            "edge_union_rows": levels}}
    launches, full, arm_out = store_arms(
        kernels, "tp_store", tp_store_arms(dev), batches, ticks, rows_ok,
        want, R, B)
    state_mb = {tc: sum(x.numel() * x.element_size()
                        for x in full.states[tc].values()) / 1e6
                for tc in ("tpset", "graph")}
    gs = full.states["graph"]
    emit("tp_store", replicas=R, keys=K, tp_capacity=g["tp_capacity"],
         v_capacity=g["v_capacity"], e_capacity=g["e_capacity"],
         ops_per_replica_per_type=B, hot_window=D // 2, ticks=ticks,
         state_mb=state_mb,
         tpset_live_elements=int(tpset.live_count(full.states["tpset"])[0].sum()),
         graph_live_vertices=int(graph.vertex_count(gs)[0].sum()),
         graph_live_edges=int(graph.edge_count(gs)[0].sum()),
         arms=arm_out, launches=launches)
    return launches


def tp_kernel_rows(kernels, calls):
    """Rows of the kernels line for the nine 2P-Set and Graph wrappers,
    each on a recorded main-path call (tp_kernel_checks): the applies and
    captures on the consensus phases' calls with the most live lanes, the
    unions on tp_store's, edge_mask on a graph_consensus query. Bytes:
    each input read once and each output written once; an apply reads a
    live lane's fields, only the op of a lane that is not live, writes a
    capture's ok for every lane, and moves the rows its live lanes gather
    and write back, not the whole state. Operations: a union one per
    record; an apply one per slot of its row per live lane; edge_mask two
    compares per vertex slot for each live edge (a dead edge is not
    tested), and of its bytes only what this input needs: the flags of
    every slot and the output, the tombstones of valid slots, the ids of
    live vertices and the endpoints of live edges."""
    rows = [union_level_row(kernels, name, calls[name], per,
                            lambda n, r: n * r, "tp_store")
            for name, per in (("tp_union", 6), ("edge_union", 10),
                              ("tp_union_rows", 6), ("edge_union_rows", 10))]
    for name, codes in (("tpset_apply", (1, 2)), ("tpset_capture", (1, 2)),
                        ("graph_apply", (1, 2, 3, 4)),
                        ("graph_capture", (1, 2, 3, 4))):
        (state, ops), kw = calls[name]
        valid = state["valid"] if name.startswith("tpset") else state["v"]
        V, K = valid.shape[:2]
        Bn = ops["op"].shape[1]
        read, written = rows_touched(valid, ops, codes)
        live = live_lanes(ops, codes)
        capture = name.endswith("capture")
        if name.startswith("tpset"):
            c = state["valid"].shape[-1]
            row_b, lane_b, width = 6 * c, 12 + 4 * ("ok" in ops), c
            shape = f"C{c}"
        else:
            cv, ce = state["v"].shape[-1], state["src"].shape[-1]
            row_b, lane_b, width = 6 * cv + 10 * ce, 16 + 4 * ("ok" in ops), \
                cv + ce
            shape = f"CV{cv} CE{ce}"
        blocks, threads = kernels.walk_occupancy(
            not name.startswith("tpset"), width if name.startswith("tpset")
            else state["v"].shape[-1], 0 if name.startswith("tpset")
            else state["src"].shape[-1])
        rows.append(dict(
            name=name, longest_walk=longest_walk(ops, K, codes),
            walk_blocks_per_sm=blocks, walk_threads_per_block=threads,
            call=lambda n=name, s=state, o=ops:
                kernels.WRAPPERS[n](s, o),
            plain=lambda n=name, s=state, o=ops: plain_of(kernels, n)(s, o),
            library=None, shape=f"{name.split('_')[0]}_consensus "
            f"{'submit' if capture else 'delta apply'}: V{V} K{K} {shape} "
            f"B{Bn}, {live} live lanes",
            rows_read=read, rows_written=written,
            bytes=(lane_b * live + 4 * (V * Bn - live)
                   + (4 * V * Bn if capture else 0) + 4 * V
                   + row_b * (read + written)),
            operations=live * width, profile_plain=False))
    (state,), kw = calls["edge_mask"]
    lead = tuple(state["v"].shape[:-1])
    nrows, cv, ce = int(np.prod(lead)), state["v"].shape[-1], \
        state["src"].shape[-1]
    live_edges = int((state["e_valid"] & ~state["e_removed"]).sum())
    # what the filter needs of this input: every slot's valid flag and
    # every edge's output byte; the tombstone of a valid slot; the id of a
    # live vertex and both endpoints of a live edge
    valid_v, valid_e = int(state["v_valid"].sum()), int(state["e_valid"].sum())
    live_v = int((state["v_valid"] & ~state["v_removed"]).sum())
    mask_bytes = (nrows * (cv + 2 * ce) + valid_v + valid_e + 4 * live_v
                  + 8 * live_edges)
    r = torch.arange(nrows, device=state["v"].device).view(lead + (1,)).long()
    v_live = state["v_valid"] & ~state["v_removed"]
    pv = ((r << 32) | state["v"].long())[v_live]
    pe = torch.cat([((r << 32) | state[f].long()).view(-1)
                    for f in ("src", "dst")])
    rows.append(dict(
        name="edge_mask", call=lambda: kernels.edge_mask(state),
        plain=lambda: kernels.edge_mask_plain(state),
        library=lambda: torch.isin(pe, pv),
        shape=f"a graph_consensus edge_count: {nrows} rows of CV{cv} CE{ce}, "
        f"{live_v} live vertices, {live_edges} live edges",
        bytes=mask_bytes, operations=2 * cv * live_edges))
    for row in rows:
        row["library_note"] = TP_LIBRARY_NOTES[row["name"]]
    return rows


def harness_tensor(dev, kernels, workloads, smi):
    """The port's run_tensor (janus_tpu_torch.bench.harness) at presets
    pnc (config 1), orset (config 2 at 16 nodes) and mixed (config 3, 64
    nodes, consensus on), on the card, uncut (HARNESS lists any cut of
    ticks). Per preset, one JSON line with the run's Results.to_dict(),
    each SafeKV's stats (slots_dropped among them) and the checks: after
    the drain every view's stable state is the same; where a type dropped
    no slot record, every view's prospective state equals its stable state
    (slots dropped by capacity depend on the batching of the applies, so a
    type that dropped some may end with the two apart, as in the JAX
    package); the PN-Counter's values equal a numpy sum of the ops of
    every accepted batch; a few dispatches of each SafeKV make no host
    synchronisation. After the checks, the profiler reads the CUDA
    kernels and device time of a few more loaded rounds of each SafeKV.
    Returns the launches of the three runs."""
    import dataclasses

    from janus_tpu_torch.bench import harness
    from janus_tpu_torch.obs.metrics import get_registry

    launches = {name: 0 for name in kernels.WRAPPERS}
    for preset in HARNESS["presets"]:
        cfg = harness.PRESETS[preset]
        cut = HARNESS["cut_ticks"].get(preset)
        if cut is not None:
            cfg = dataclasses.replace(cfg, ticks=cut)
        get_registry().reset()  # the stage histograms of this run only
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases
        observe = {}
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = harness.run_tensor(cfg, device=dev, observe=observe)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        run_launches = kernels.launches()
        for name, k in run_launches.items():
            launches[name] += k
        kvs = observe["kvs"]
        stats = {code: dict(kv.stats) for code, kv in kvs.items()}  # the run's
        same = {}
        for code, kv in kvs.items():
            # slots dropped by capacity depend on how blocks were batched
            # into applies, so a type that dropped any may end with
            # prospective and stable states apart (the JAX package's too)
            exact = stats[code]["slots_dropped"] == 0
            same[code] = all(torch.equal(kv.prospective[f], kv.stable[f])
                             for f in kv.stable)
            check(same[code] or not exact, f"harness {preset} {code}: "
                  f"prospective differs from stable after the drain")
            for name, st in (("stable", kv.stable),
                             ("prospective", kv.prospective)):
                agree = all(torch.equal(x, x[:1].expand_as(x))
                            for x in st.values())
                check(agree or (name == "prospective" and not exact),
                      f"harness {preset} {code}: views' {name} states differ")
        if "pnc" in kvs:
            pnc_sum_check(f"harness {preset}", cfg, observe, kvs["pnc"])
        syncs = []
        for code, kv in kvs.items():
            idle = workloads.ops_to_device(
                {f: np.zeros_like(v) for f, v in
                 observe["batches"][code][0].items()}, dev)
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                pending = [kv.step_dispatch(idle, record=False)
                           for _ in range(HARNESS["sync_rounds"])]
            torch.cuda.set_sync_debug_mode("default")
            syncs += [str(c.message)[:160] for c in caught
                      if "synchroniz" in str(c.message).lower()]
            for packed, meta in pending:
                kv.step_absorb(packed, meta)
        check(not syncs, f"harness {preset}: host syncs in step_dispatch: "
              f"{syncs[:3]}")
        # a loaded round of each SafeKV after the run, by the profiler
        profiled = {}
        for code, kv in kvs.items():
            batch = workloads.ops_to_device(observe["batches"][code][0], dev)
            kv.step(batch, record=False)
            seen, dev_ms = device_profile(lambda: kv.step(batch, record=False),
                                          reps=HARNESS["profile_rounds"])
            profiled[code] = {
                "cuda_kernels_per_round": seen / HARNESS["profile_rounds"],
                "device_ms_per_round": dev_ms / HARNESS["profile_rounds"]}
        for name in SAFEKV_KERNELS + CONSENSUS_KERNELS:
            check(run_launches[name] > 0, f"harness {preset}: {name} never "
                  f"launched")
        d = res.to_dict()
        d.pop("reference", None)
        emit("harness_tensor", preset=preset, nvidia_smi=smi,
             config=dataclasses.asdict(cfg), ticks_cut=cut is not None,
             seconds=seconds, results=d,
             slots_dropped={code: st["slots_dropped"]
                            for code, st in stats.items()},
             prospective_equals_stable=same, profiled_rounds=profiled,
             stats=stats, host_syncs_in_dispatch=len(syncs),
             launches=run_launches,
             peak_memory_gb=(torch.cuda.max_memory_allocated() - held) / 2**30)
        del observe, kvs, res
        torch.cuda.empty_cache()
    return launches


def pnc_sum_check(what, cfg, observe, kv, views=None):
    """The PN-Counter's stable values (of ``views``, default all) equal a
    numpy sum of the ops of every batch a harness run's rounds accepted."""
    expect = np.zeros(cfg.num_objects, np.int64)
    host = observe["batches"]["pnc"]
    for code, idx, acc in observe["rounds"]:
        if code != "pnc" or idx is None:
            continue
        o = host[idx]
        sign = np.where(o["op"] == 1, 1, np.where(o["op"] == 2, -1, 0))
        amount = (sign * o["a0"].astype(np.int64))[acc]
        np.add.at(expect, o["key"][acc].ravel(), amount.ravel())
    got = kv.query_stable("get").cpu().numpy()
    if views is not None:
        got = got[views]
    check((got == wrap32(expect)[None]).all(),
          f"{what}: PN-Counter values differ from the numpy sum of the "
          f"accepted ops")


def views_agree(what, state, views=None) -> None:
    """Every view (of ``views``, default all) of ``state`` bit-equal."""
    for f, x in state.items():
        if views is not None:
            x = x[torch.as_tensor(views, device=x.device)]
        check(torch.equal(x, x[:1].expand_as(x)), f"{what}: views' {f} "
              f"differ")


def adaptive_runs(harness):
    """(run name, config) of the harness_adaptive phase."""
    import dataclasses

    runs = [(p, harness.PRESETS[p]) for p in ADAPTIVE["presets"]]
    for name, (base, change) in ADAPTIVE["variants"].items():
        cfg = harness.PRESETS[base]
        runs.append((name, dataclasses.replace(
            cfg, name=f"{cfg.name}_{name}", **change)))
    return runs


def harness_adaptive(dev, kernels, workloads, smi, ring_calls):
    """run_tensor_adaptive through harness.run on the card at presets
    orset_adaptive (saturated), orset_adaptive_light (the trickle, the
    controller on) and orset_fixed_light (the trickle at fixed B), uncut,
    and the light preset under a latency target the card's seal misses
    (ADAPTIVE's variants). Per run: B within floor and ceiling and on the
    quantum at every tick; every target the controller's law applied to
    the run's recorded (backlog, seal ms) observations; every resize and
    refusal counted, and one ring_resize launch for each; the ring at the
    final B; every view's stable state the same after the drain (whose
    ticks keep boarding the trickle, so prospective states may hold blocks
    still in flight); the saturated run and the
    fixed run holding B at 5,120, the tight trickle resizing, the tight
    floor run reaching the floor. Prints each run's block trace, resizes,
    refusals, safe-update p50/p99 and tick ms. Records every ring_resize
    call (its ring cloned) into ``ring_calls`` by run. Returns the
    launches of the runs."""
    import dataclasses

    from janus_tpu_torch.bench import harness
    from janus_tpu_torch.obs.metrics import Registry, get_registry

    launches = {name: 0 for name in kernels.WRAPPERS}
    fig7 = {}
    for name, cfg in adaptive_runs(harness):
        get_registry().reset()
        observe, out = {}, []
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec = record_calls(kernels, ("ring_resize",), lambda: out.append(
            harness.run(cfg, device=dev, observe=observe)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        run_launches = kernels.launches()
        for k, v in run_launches.items():
            launches[k] += v
        res, kv, ticks = out[0], observe["kv"], observe["ticks"]
        what = f"harness_adaptive {name}"
        b_max, floor = cfg.ops_per_block, cfg.block_floor
        quantum = min(64, b_max)
        trace = [t[0] for t in ticks] + [kv.B]
        check(all(floor <= b <= b_max and (b % quantum == 0 or b == floor)
                  for b in trace), f"{what}: B off its range: {sorted(set(trace))}")
        sched = harness.adaptive_scheduler(cfg, registry=Registry())
        law = []
        for i, (_, backlog, seal_ms, target, _) in enumerate(ticks):
            sched.observe(backlog, seal_ms)
            if cfg.adaptive and sched.maybe_adjust() != target:
                law.append(i)
        check(not law, f"{what}: targets off the controller's law at ticks "
              f"{law[:8]}")
        resized = sum(t[4] is True for t in ticks)
        refused = sum(t[4] is False for t in ticks)
        check(res.extra["block_resizes"] == kv.stats["block_resizes"]
              == resized, f"{what}: resizes {res.extra['block_resizes']}, "
              f"{kv.stats['block_resizes']}, {resized}")
        check(res.extra["resize_refusals"] == refused, f"{what}: refusals")
        check(run_launches["ring_resize"] == resized + refused
              == len(rec["ring_resize"]), f"{what}: ring_resize launched "
              f"{run_launches['ring_resize']} times for {resized} resizes and "
              f"{refused} refusals")
        check(all(x.shape[2] == kv.B for x in kv.ops_buffer.values())
              and kv.safe_host.shape[2] == kv.B, f"{what}: ring not at B")
        # the drive's drain ticks keep boarding the trickle, so the last
        # blocks are still in flight: only the stable views must agree
        views_agree(what, kv.stable)
        if name in ("orset_adaptive", "orset_fixed_light"):
            check(set(trace) == {b_max} and resized == 0,
                  f"{what}: B left {b_max}: {sorted(set(trace))}")
        if name == "light_tight":
            check(resized > 0 and min(trace) < b_max,
                  f"{what}: the controller never resized")
        if name == "floor_tight":
            check(min(trace) == floor, f"{what}: B never reached the floor "
                  f"{floor}: {sorted(set(trace))}")
        ring_calls[name] = rec["ring_resize"]
        d = res.to_dict()
        d.pop("reference", None)
        seal = np.asarray([t[2] for t in ticks])
        safe = d["latency"]["safeUpdate"]
        fig7[name] = {"safe_p50_ms": safe.get("median_ms"),
                      "safe_p99_ms": safe.get("p99_ms"),
                      "tick_ms_avg": res.extra["tick_ms_avg"],
                      "block_min": min(trace), "resizes": resized}
        emit("harness_adaptive", run=name, nvidia_smi=smi,
             config=dataclasses.asdict(cfg), seconds=seconds, results=d,
             block_trace_every_tick=trace, block_min=min(trace),
             block_resizes=resized, resize_refusals=refused,
             safe_update_p50_ms=safe.get("median_ms"),
             safe_update_p99_ms=safe.get("p99_ms"),
             tick_ms_avg=res.extra["tick_ms_avg"],
             seal_ms={"p50": float(np.percentile(seal, 50)),
                      "p90": float(np.percentile(seal, 90)),
                      "max": float(seal.max())},
             slots_dropped=kv.stats["slots_dropped"],
             launches={k: v for k, v in run_launches.items() if v})
        del observe, out, res, kv
        torch.cuda.empty_cache()
    check(launches["ring_resize"] > 0, "harness_adaptive: ring_resize never "
          "launched")
    emit("harness_adaptive_fig7", nvidia_smi=smi, runs=fig7)
    return launches


def harness_faults(dev, kernels, workloads, smi):
    """run_tensor through harness.run on the card at the Fig 11 presets,
    uncut: byzantine (16 nodes, nodes 12-15 signing tampered digests at
    0.25 through the integrity plane) and its control byzantine0 (the same
    secure path at 0), pnc8 and crash (8 nodes, 2 crashed). Checks: the
    control prunes nothing and reads health OK; the Byzantine run prunes
    blocks, keeps committing (the GC frontier past the window) and reads
    DEGRADED naming one of the injecting nodes, whose equivocation counts
    are the only non-zero ones; every live view's stable state the same;
    the PN-Counter's stable values those of a numpy sum of the accepted
    ops. Prints throughput, commit lag p50/p99 and safe-update latency per
    preset, and the Fig 11 deltas. Returns the launches of the runs."""
    import dataclasses

    from janus_tpu_torch.bench import harness
    from janus_tpu_torch.obs.metrics import get_registry

    launches = {name: 0 for name in kernels.WRAPPERS}
    reads = {}
    injecting = set(FAULTS["injecting"])
    for preset in FAULTS["presets"]:
        cfg = harness.PRESETS[preset]
        get_registry().reset()
        observe = {}
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = harness.run(cfg, device=dev, observe=observe)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        run_launches = kernels.launches()
        for k, v in run_launches.items():
            launches[k] += v
        what = f"harness_faults {preset}"
        active = observe["active"]
        views = None if active is None else np.nonzero(active)[0]
        for code, kv in observe["kvs"].items():
            views_agree(f"{what} {code}", kv.stable, views)
            check(kv.stats["own_commits"] > 0, f"{what}: no commit")
        if "pnc" in observe["kvs"]:
            pnc_sum_check(what, cfg, observe, observe["kvs"]["pnc"], views)
        health = res.extra.get("health")
        if cfg.byzantine:
            kv = observe["kvs"][cfg.type_code]
            check(kv.base_round() > cfg.window, f"{what}: the GC frontier "
                  f"stopped at {kv.base_round()}")
            equiv = health["equivocation"]
            if cfg.invalid_rate == 0:
                check(res.extra["pruned_blocks"] == 0
                      and health["status"] == "OK" and not equiv,
                      f"{what}: the control pruned or degraded: {health}")
            else:
                named = [v for v in injecting
                         if any(f"node {v}:" in r for r in health["reasons"])]
                check(res.extra["pruned_blocks"] > 0
                      and health["status"] == "DEGRADED" and named
                      and set(equiv) <= injecting
                      and all(c > 0 for c in equiv.values()),
                      f"{what}: pruning or health off: "
                      f"{res.extra['pruned_blocks']} {health}")
        d = res.to_dict()
        d.pop("reference", None)
        safe = d["latency"]["safeUpdate"]
        reads[preset] = {
            "throughput_ops_per_sec": d["throughput_ops_per_sec"],
            "commit_lag_ticks_p50": res.extra["commit_lag_ticks_p50"],
            "commit_lag_ticks_p99": res.extra["commit_lag_ticks_p99"],
            "safe_p50_ms": safe.get("median_ms"),
            "safe_p99_ms": safe.get("p99_ms"),
            "tick_ms_avg": res.extra["tick_ms_avg"]}
        emit("harness_faults", preset=preset, nvidia_smi=smi,
             config=dataclasses.asdict(cfg), seconds=seconds, results=d,
             **reads[preset], pruned_blocks=res.extra.get("pruned_blocks"),
             health=health,
             stats={code: dict(kv.stats)
                    for code, kv in observe["kvs"].items()},
             launches={k: v for k, v in run_launches.items() if v})
        del observe, res
        torch.cuda.empty_cache()

    def delta(a, b):
        x, y = (reads[p]["throughput_ops_per_sec"] for p in (a, b))
        return (x - y) / y if y else None
    emit("harness_faults_fig11", nvidia_smi=smi,
         byzantine_vs_control_throughput=delta("byzantine", "byzantine0"),
         crash_vs_pnc8_throughput=delta("crash", "pnc8"), reads=reads)
    return launches


def ring_kernel_checks(dev, kernels, workloads, cases, ring_calls):
    """ring_resize against its plain version on the card, bit-equal (the
    new ring and the live-tail flag): random rings of every type's extras
    (workloads.RING_EXTRAS) at RING_CHECKS' geometries, grows, clean
    shrinks and shrinks with one live tail lane (refused); then every
    ring_resize call of the harness_adaptive runs, recorded there.
    Returns the recorded calls."""
    log = CaseLog(("ring_resize",))
    rng = np.random.default_rng(16)
    refusals = 0
    for kind, extras in sorted(workloads.RING_EXTRAS.items()):
        for w, n, b, new_b in RING_CHECKS["geometries"]:
            for live in ((False, True) if new_b < b else (False,)):
                ring = workloads.ops_to_device(workloads.ring_resize_case(
                    rng, w, n, b, new_b, extras, live), dev)
                _, flag = log.add(kernels, "ring_resize", (ring, new_b),
                                  f"{kind} W{w} N{n} B{b}->{new_b}"
                                  f"{' live tail' if live else ''}")
                check(int(flag.item()) == int(live), f"ring_resize {kind} "
                      f"B{b}->{new_b}: flag {int(flag.item())}")
                refusals += live
    recorded = {}
    for run, calls in ring_calls.items():
        for j, (args, kw) in enumerate(calls):
            log.add(kernels, "ring_resize", args, f"recorded {run} call {j}",
                    kw)
        recorded[run] = len(calls)
    check(sum(recorded.values()) > 0, "ring_kernels: no recorded call")
    cases.append({"kernel": "ring_resize", "case": "ring_kernels",
                  **log.by["ring_resize"]})
    emit("ring_kernels", by_kernel=log.by, refusals_checked=refusals,
         recorded=recorded)
    return ring_calls


def ring_bytes(ring, new_b) -> int:
    """What a resize must move: the kept lanes of every field read once
    (and op's tail lanes on a shrink, for the live check), the new ring
    written once."""
    b = ring["op"].shape[2]
    lanes = sum(x[:, :, 0].numel() for x in ring.values())
    tail = ring["op"][:, :, 0].numel() * max(0, b - new_b)
    return 4 * (lanes * (min(b, new_b) + new_b) + tail)


def ring_library(ring, new_b):
    """One PyTorch call a field: ``F.pad`` for a grow, a slice made
    contiguous for a shrink (and the tail's any() for its check)."""
    import torch.nn.functional as F

    b = ring["op"].shape[2]
    if new_b > b:
        return lambda: [F.pad(x, (0, 0) * (x.dim() - 3) + (0, new_b - b))
                        for x in ring.values()]
    return lambda: ([x[:, :, :new_b].contiguous() for x in ring.values()],
                    (ring["op"][:, :, new_b:] != 0).any())


def ring_kernel_rows(kernels, ring_calls):
    """The kernels line's ring_resize row on the largest recorded shrink
    of the harness_adaptive runs (the 5,120-lane OR-Set ring halved), with
    a grow timed beside it (``grow``): the largest recorded one, or, when
    the runs grew no ring, that shrink's kept lanes grown back."""
    calls = [c for run in ring_calls.values() for c in run]
    size = {id(c): ring_bytes(*c[0]) for c in calls}
    shrinks = [c for c in calls if c[0][1] < c[0][0]["op"].shape[2]]
    grows = [c for c in calls if c[0][1] > c[0][0]["op"].shape[2]]
    (ring, new_b), _ = max(shrinks or calls, key=lambda c: size[id(c)])
    undone = not grows and new_b < ring["op"].shape[2]
    if undone:
        kept = {f: x[:, :, :new_b].contiguous() for f, x in ring.items()}
        grows = [((kept, ring["op"].shape[2]), {})]
        size[id(grows[0])] = 0
    w, n, b = ring["op"].shape
    nbytes = ring_bytes(ring, new_b)
    row = dict(
        name="ring_resize",
        call=lambda: kernels.ring_resize(ring, new_b),
        plain=lambda: kernels.ring_resize_plain(ring, new_b),
        library=ring_library(ring, new_b),
        shape=f"a recorded resize of harness_adaptive: W{w} N{n} "
        f"B{b}->{new_b}, {len(ring)} fields",
        bytes=nbytes, operations=nbytes // 4,
        library_note="per field: a slice made contiguous (a shrink) or "
        "F.pad (a grow), and the op tail's any()")
    if grows:
        (g_ring, g_b), _ = max(grows, key=lambda c: size[id(c)])
        g_bytes = ring_bytes(g_ring, g_b)
        gw, gn, gb = g_ring["op"].shape
        row["grow"] = {
            "shape": f"W{gw} N{gn} B{gb}->{g_b}"
                     f"{', the shrink undone' if undone else ''}",
            "ms": time_cuda(lambda: kernels.ring_resize(g_ring, g_b)),
            "device_ms": device_burst_ms(
                lambda: kernels.ring_resize(g_ring, g_b)),
            "plain_ms": time_cuda(
                lambda: kernels.ring_resize_plain(g_ring, g_b)),
            "library_ms": time_cuda(ring_library(g_ring, g_b)),
            "bytes": g_bytes, "bound_ms": 1e3 * g_bytes / HBM_BYTES_PER_S}
    return [row]


def ingest_ring(dev, rng, n, w, b, lanes, rm):
    """A ring of pnc's six op fields ``[W, N, b]`` and, with ``lanes``,
    that many capture lanes ``[W, N, b, rm]``, with its buffer_filled."""
    fields = [torch.as_tensor(rng.integers(-9, 9, (w, n, b), dtype=np.int32),
                              device=dev) for _ in range(6)]
    fields += [torch.as_tensor(rng.integers(-9, 9, (w, n, b, rm),
                                            dtype=np.int32), device=dev)
               for _ in range(lanes)]
    filled = torch.as_tensor(rng.random((w, n)) < 0.3, device=dev)
    return tuple(fields), filled


def ingest_args(dev, workloads, rng, n, w, ring=None, messages=0):
    """A random DAG state (blocks and certificates sparse, so many
    ingested blocks are fresh) and a wire batch packed as
    ``dag.ingest_batch`` packs it (its dedupe included); payload rows
    when ``ring`` is given. Returns the wrapper's (args, kwargs)."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.kernels.dag_ingest import pack

    d, _, _ = workloads.consensus_state(rng, n, w)
    for f in ("block_exists", "cert_exists", "edges", "acks"):
        d[f] = d[f] & (rng.random(d[f].shape) < 0.35)
    row = 0 if ring is None else sum(x[0, 0].numel() for x in ring[0])
    blocks, sigs, certs, seen = workloads.wire_batch(
        rng, n, d["slot_round"], payload=row, messages=messages)
    uniq, pays, keys = [], [], set()
    for blk in blocks:
        if (blk[0], blk[1]) not in keys:
            keys.add((blk[0], blk[1]))
            if len(blk) > 3:
                pays.append((len(uniq), blk[3]))
            uniq.append(blk)
    flat, counts = pack(n, uniq, sigs, certs, seen, pays)
    state = {f: torch.as_tensor(v, device=dev) for f, v in d.items()}
    return ((DagConfig(n, w), state, torch.as_tensor(flat, device=dev),
             counts), {"ring": ring})


def ingest_kernel_checks(dev, kernels, workloads, cases):
    """dag_ingest against its plain version on the card, bit-equal (the
    DAG fields and the ring, both updated in place), on random wire
    batches: stale and ahead-of-window rounds, duplicate (r, src) copies
    and re-sends with other edges, node ids out of range, empty seen_by,
    payload rows for pnc's ring and the OR-Set's capture lanes; and
    dag_round's split mode against its plain version with and without
    active, withhold and invalid."""
    from janus_tpu_torch.consensus import DagConfig

    g = INGEST_CHECKS
    log = CaseLog(SPLIT_KERNELS)
    rng = np.random.default_rng(12)
    for n, w in g["shapes"]:
        for i in range(g["batches"]):
            ring = None
            if i % 3 == 1:
                ring = ingest_ring(dev, rng, n, w, g["pnc_block"], 0, g["rm"])
            elif i % 3 == 2:
                ring = ingest_ring(dev, rng, n, w, g["orset_block"], 3, g["rm"])
            args, kw = ingest_args(dev, workloads, rng, n, w, ring,
                                   messages=4 * n if i == 0 else 0)
            log.add(kernels, "dag_ingest", args, f"N{n} W{w} batch {i} "
                    f"counts {args[3]}", kw)
        cfg = DagConfig(n, w)
        for i in range(g["split_states"]):
            d, _, _ = workloads.consensus_state(rng, n, w, wrap=i % 3 == 2)
            d = {f: torch.as_tensor(v, device=dev) for f, v in d.items()}
            owned = torch.as_tensor(rng.random(n) < 0.5, device=dev)
            masks = [torch.as_tensor(m, device=dev)
                     for m in workloads.round_masks(rng, n, w)]
            for keep in ((0, 0, 0), (1, 1, 1), (1, 0, 0), (0, 1, 1)):
                sel = [m if k else None for m, k in zip(masks, keep)]
                log.add(kernels, "dag_round", (cfg, d, *sel),
                        f"split N{n} W{w} state {i} masks {keep}",
                        {"owned": owned})
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "ingest_kernels", **rec})
    emit("ingest_kernels", by_kernel=log.by)


class SplitCluster:
    """The processes of a split deployment, in this process: one
    ``SplitNode`` each from ``make(i, send)``, over in-memory broadcast
    pipes; ``corrupt`` maps a sender to a hook applied to its frames in
    transit."""

    def __init__(self, make, count, corrupt=None):
        self.boxes = [[] for _ in range(count)]
        self.corrupt = corrupt or {}
        self.nodes = [make(i, self._sender(i)) for i in range(count)]

    def _sender(self, i):
        def send(data):
            fn = self.corrupt.get(i)
            data = fn(data) if fn else data
            for j, box in enumerate(self.boxes):
                if j != i:
                    box.append(data)
        return send

    def deliver(self, i):
        for data in self.boxes[i]:
            self.nodes[i].receive(data)
        self.boxes[i].clear()


class SplitFeed:
    """Each process's client batches: its owned nodes' rows of an op
    batch (``draw(i)`` returns the host rows), resubmitted until accepted;
    the accepted ones are kept by (round, source) for the numpy fold."""

    def __init__(self, dev, owned, draw, safe_share=0.0, rng=None):
        self.dev, self.owned, self.draw = dev, owned, draw
        self.safe_share, self.rng = safe_share, rng
        self.pending = [None] * len(owned)
        self.boarded = {}
        self.safe_sent = 0

    def batch(self, i):
        if self.pending[i] is None:
            host = self.draw(i)
            safe = None
            if self.safe_share:
                safe = (self.rng.random(host["op"].shape) < self.safe_share)
                safe &= self.owned[i][:, None]
            ops = {f: torch.as_tensor(x, device=self.dev)
                   for f, x in host.items()}
            self.pending[i] = (host, ops, safe)
        return self.pending[i]

    def absorb(self, i, info):
        if info is None:
            return
        host, _, safe = self.pending[i]
        own = np.nonzero(self.owned[i])[0]
        if info["accepted"][own].all():
            for v in own:
                self.boarded[(int(info["round"][v]), int(v))] = {
                    f: x[v] for f, x in host.items()}
            self.safe_sent += 0 if safe is None else int(safe.sum())
            self.pending[i] = None


class TcpCluster:
    """Processes whose bytes arrive by their TcpPeers' receive threads."""

    def __init__(self, nodes):
        self.nodes = nodes

    def deliver(self, i):
        pass


def split_step(cluster, feed, i, idle=False):
    """Deliver process i's inbox and step it once (its pending batch, or
    an idle block); returns the step info."""
    cluster.deliver(i)
    node = cluster.nodes[i]
    if idle:
        return node.step(None, record=False)
    host, ops, safe = feed.batch(i)
    info = node.step(ops, safe=safe)
    feed.absorb(i, info)
    return info


def owned_stable(node, v):
    return {f: x[v] for f, x in node.kv.stable.items() if f != "_rm_cap"}


def split_views_agree(nodes, owned):
    """The owned views' stable states bit-equal across the processes."""
    views = [owned_stable(node, int(np.nonzero(o)[0][0]))
             for node, o in zip(nodes, owned)]
    return all(torch.equal(views[0][f], x[f]) for x in views[1:]
               for f in views[0])


def split_commits(nodes, owned):
    """Each process's owned view's committed order, (round, source)."""
    return [node.kv.ordered_commits(int(np.nonzero(o)[0][0]))
            for node, o in zip(nodes, owned)]


def split_drain(cluster, feed, owned, g, what):
    """Idle iterations until every boarded batch committed in every owned
    view and those views' stable states agree; returns the count."""
    nodes = cluster.nodes
    idle = 0
    while idle < g["max_idle"]:
        if idle >= g["min_idle"]:
            commits = split_commits(nodes, owned)
            if all(set(feed.boarded) <= set(c) for c in commits) \
                    and split_views_agree(nodes, owned):
                break
        for i in range(len(nodes)):
            split_step(cluster, feed, i, idle=True)
        idle += 1
    torch.cuda.synchronize()
    commits = split_commits(nodes, owned)
    check(all(set(feed.boarded) <= set(c) for c in commits),
          f"{what}: a boarded batch did not commit in {idle} idle iterations")
    check(split_views_agree(nodes, owned), f"{what}: owned stable views "
          f"differ across the processes after {idle} idle iterations")
    return idle


def split_check(nodes, owned, what):
    """No frame failed verification; the committed orders agree on their
    common prefix. Returns the shortest committed order's length."""
    for i, node in enumerate(nodes):
        check(node.stats["verified_bad"] == 0, f"{what}: process {i} "
              f"dropped {node.stats['verified_bad']} frames")
    commits = split_commits(nodes, owned)
    common = min(len(c) for c in commits)
    check(common > 0 and all(c[:common] == commits[0][:common]
                             for c in commits),
          f"{what}: committed orders disagree on their common prefix")
    return common


def pnc_fold(commits, boarded, k, n):
    """P and N ``[K, N]`` of the blocks in ``commits`` that carried a
    batch, folded in numpy (writer lane = the op's writer field)."""
    p = np.zeros((k, n), np.int64)
    m = np.zeros((k, n), np.int64)
    for key in commits:
        ops = boarded.get(tuple(key))
        if ops is None:
            continue
        for code, acc in ((1, p), (2, m)):
            live = ops["op"] == code
            np.add.at(acc, (ops["key"][live], ops["writer"][live]),
                      ops["a0"][live])
    return wrap32(p), wrap32(m)


def split_pnc_fold_check(nodes, owned, feed, k, n, what):
    for node, o in zip(nodes, owned):
        v = int(np.nonzero(o)[0][0])
        p, m = pnc_fold(node.kv.ordered_commits(v), feed.boarded, k, n)
        st = owned_stable(node, v)
        check(np.array_equal(st["p"].cpu().numpy(), p)
              and np.array_equal(st["n"].cpu().numpy(), m),
              f"{what}: process {v}'s stable P/N differ from the numpy fold "
              f"of its committed blocks")


def split_make(dev, kind, g, owned):
    """``make(i, send)`` for a cluster of ``kind`` (pnc or orset)."""
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset, pncounter
    from janus_tpu_torch.net.splitnode import SplitNode

    n, w, b, k = (g[x] for x in ("nodes", "window", "ops_per_block", "keys"))
    if kind == "pnc":
        spec, dims = pncounter.SPEC, dict(num_keys=k, num_writers=n)
    else:
        spec = orset.SPEC
        dims = dict(num_keys=k, capacity=g["capacity"], rm_capacity=g["rm"],
                    apply_budget=g["budget"])

    def make(i, send):
        return SplitNode(DagConfig(n, w), spec, b, owned[i], send=send,
                         device=dev, **dims)
    return make


def split_draw(workloads, kind, g, owned, seed):
    """The host batch a process draws: its owned rows of a PN-Counter
    uniform batch or an OR-Set 50/50 add/remove batch (tags minted by the
    owning node), the other rows no-ops."""
    from janus_tpu_torch.utils.ids import TagMinter

    n, b, k = g["nodes"], g["ops_per_block"], g["keys"]
    rng = np.random.default_rng(seed)
    minters = [TagMinter(v) for v in range(n)]

    def draw(i):
        out = {f: np.zeros((n, b), np.int32) for f in
               ("op", "key", "a0", "a1", "a2", "writer")}
        for v in np.nonzero(owned[i])[0]:
            if kind == "pnc":
                row = workloads.pnc_uniform(rng, 1, k, b)
                row["writer"][:] = v
            else:
                row = workloads.orset_add_remove(rng, [minters[v]], k, b)
            for f in out:
                out[f][v] = row[f][0]
        return out
    return draw


def split_run(dev, kernels, workloads, kind, g, seed, twin=None):
    """One split cluster of ``kind``: key exchange, ``warmup`` iterations,
    ``steps`` (timed) iterations, then idle ones to drain; ``twin``
    (a second cluster's ``make``) is stepped beside it for the first
    ``g['cpu_steps']`` iterations and held bit-equal to it after every
    process step. Returns the cluster, the feed, the owned masks and the
    timed run's numbers."""
    from janus_tpu_torch.obs import stages
    from janus_tpu_torch.obs.metrics import get_registry

    n = g["nodes"]
    owned = [np.arange(n) == i for i in range(n)]
    cluster = SplitCluster(split_make(dev, kind, g, owned), n)
    feed = SplitFeed(dev, owned, split_draw(workloads, kind, g, owned, seed),
                     g.get("safe", 0.0), np.random.default_rng(seed + 1))
    shadow = None
    if twin is not None:
        shadow = (SplitCluster(twin, n),
                  SplitFeed(torch.device("cpu"), owned,
                            split_draw(workloads, kind, g, owned, seed),
                            g.get("safe", 0.0),
                            np.random.default_rng(seed + 1)))
    for c in (cluster,) + (() if shadow is None else (shadow[0],)):
        for node in c.nodes:
            node.start()
    tx = get_registry().counter("split_tx_bytes_total")
    hist = stages.stage_histograms("split")["ingest"]
    total = g["warmup"] + g["steps"]
    for t in range(total):
        if t == g["warmup"]:
            torch.cuda.synchronize()
            for node in cluster.nodes:
                node.kv.latency_log.clear()
            kernels.reset_launches()
            tx0 = tx.value
            own0 = sum(node.kv.stats["own_commits"] for node in cluster.nodes)
            hist.reset()
            t0 = time.perf_counter()
        for i in range(n):
            info = split_step(cluster, feed, i)
            if shadow is not None and t < g["cpu_steps"]:
                ref = split_step(*shadow, i)
                check((info is None) == (ref is None) and (
                    info is None or np.array_equal(info["accepted"],
                                                   ref["accepted"])),
                      f"split {kind}: iteration {t} process {i} accepted "
                      f"differently on the CPU")
                a, b_ = cluster.nodes[i].kv, shadow[0].nodes[i].kv
                for name in ("dag", "stable"):
                    for f, x in getattr(a, name).items():
                        check(torch.equal(x.cpu(), getattr(b_, name)[f]),
                              f"split {kind}: iteration {t} process {i} "
                              f"{name}.{f} differs from the CPU run")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launches()
    tx_bytes = tx.value - tx0
    ingest = {"count": hist.count, "mean_ms": hist.sum / max(hist.count, 1) / 1e6,
              **{f"p{q}_ms": hist.percentile(q / 100) / 1e6
                 for q in (50, 90, 99)}}
    committed = sum(node.kv.stats["own_commits"]
                    for node in cluster.nodes) - own0
    lag = np.concatenate([node.kv.commit_latencies() for node in cluster.nodes])
    idle = split_drain(cluster, feed, owned, g, f"split {kind}")
    run = dict(seconds=dt, iterations=g["steps"], process_steps=g["steps"] * n,
               launches=launches, tx_bytes=tx_bytes, ingest=ingest,
               lag=lag, idle=idle, committed_blocks=committed)
    return cluster, feed, owned, run


def split_profile(cluster, feed, steps):
    """CUDA kernels and device µs per process step over ``steps``
    iterations, by the profiler, and dag_ingest's and dag_round's device
    µs per process step."""
    from torch.profiler import ProfilerActivity, profile
    n = len(cluster.nodes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            for i in range(n):
                split_step(cluster, feed, i)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    per = steps * n
    by = device_us_by_kernel(events, per)
    return dict(cuda_kernels_per_process_step=len(events) / per,
                device_us_per_process_step=sum(
                    e.time_range.elapsed_us() for e in events) / per,
                dag_ingest_device_us_per_process_step=sum(
                    v for k, v in by.items() if "dag_ingest" in k),
                dag_round_device_us_per_process_step=sum(
                    v for k, v in by.items() if "dag_round" in k),
                device_us_per_process_step_by_kernel=dict(
                    list(by.items())[:12]))


def split_emit(kind, g, cluster, run, prof, extra):
    n = g["nodes"]
    steps = run["process_steps"]
    lag = run["lag"]
    launches = run["launches"]
    check(launches["dag_round"] == steps, f"split {kind}: dag_round launched "
          f"{launches['dag_round']} times in {steps} process steps")
    check(0 < launches["dag_ingest"] <= steps, f"split {kind}: dag_ingest "
          f"launched {launches['dag_ingest']} times in {steps} process steps")
    emit(f"split_consensus_{kind}", nodes=n, processes=n,
         window=g["window"], ops_per_block=g["ops_per_block"],
         keys=g["keys"], warmup_iterations=g["warmup"],
         iterations=run["iterations"], seconds=run["seconds"],
         ms_per_iteration=1e3 * run["seconds"] / run["iterations"],
         ms_per_step_per_node=1e3 * run["seconds"] / steps,
         committed_ops_per_s=run["committed_blocks"] * g["ops_per_block"]
         / run["seconds"],
         commit_lag_rounds_p50=float(np.percentile(lag, 50)),
         commit_lag_rounds_p99=float(np.percentile(lag, 99)),
         blocks_committed_own=int(lag.size),
         wire_bytes_per_step=run["tx_bytes"] / steps,
         wire_bytes_per_iteration=run["tx_bytes"] / run["iterations"],
         split_ingest_histogram=run["ingest"],
         dag_ingest_launches_per_step=launches["dag_ingest"] / steps,
         launches=launches, idle_iterations_to_drain=run["idle"],
         signatures="ecdsa" if cluster.nodes[0].use_ecdsa else "keyed-hash",
         stats=[node.stats for node in cluster.nodes], **prof, **extra)


def split_consensus(dev, kernels, workloads, cases, split_calls):
    """The split deployment on the card (see SPLIT_PNC, SPLIT_ORSET): per
    type a recorded pass (every dag_ingest and dag_round call replayed
    against its plain version; the PN-Counter's first iterations also
    against the same cluster on the CPU) and a timed pass; then a cluster
    with a tampered process. Checks: no frame fails verification, the
    committed orders agree, every boarded batch commits and the owned
    stable views agree after the drain, the PN-Counter's equal a numpy
    fold of the committed blocks' payloads; the tampered process is
    dropped and the honest ones keep advancing."""
    from janus_tpu_torch.consensus import DagConfig

    log = CaseLog(SPLIT_KERNELS + ("orset_replay",))
    total = {}
    for kind, g, seed in (("pnc", SPLIT_PNC, 21), ("orset", SPLIT_ORSET, 22)):
        n = g["nodes"]
        owned = [np.arange(n) == i for i in range(n)]
        twin = (split_make(torch.device("cpu"), kind, g, owned)
                if kind == "pnc" else None)
        t0 = time.perf_counter()
        checked = {"orset_replay": 0} if kind == "orset" else {}
        calls = record_calls(
            kernels, SPLIT_KERNELS + tuple(checked), lambda: split_run(
                dev, kernels, workloads, kind, g, seed, twin=twin),
            take=checking_take(kernels, log, checked, f"split {kind}"))
        torch.cuda.synchronize()
        record_s = time.perf_counter() - t0
        check(all(kw.get("owned") is not None for _, kw in calls["dag_round"]),
              f"split {kind}: a dag_round call without the split mode")
        for name in SPLIT_KERNELS:
            for j, (args, kw) in enumerate(calls[name]):
                log.add(kernels, name, args, f"split {kind} recorded call {j}",
                        kw)
        recorded = {name: len(c) for name, c in calls.items()}
        check(kind == "pnc" or checked["orset_replay"] > 0,
              "split orset: no orset_replay call checked")
        if kind == "pnc":
            with_blocks = [c for c in calls["dag_ingest"] if c[0][3][0] > 0]
            split_calls["dag_ingest"] = with_blocks[-1]
            split_calls["dag_round"] = calls["dag_round"][-1]
        del calls

        cluster, feed, owned, run = split_run(dev, kernels, workloads, kind, g,
                                              seed)
        common = split_check(cluster.nodes, owned, f"split {kind}")
        if kind == "pnc":
            split_pnc_fold_check(cluster.nodes, owned, feed, g["keys"], n,
                                 "split pnc")
        else:
            for i, node in enumerate(cluster.nodes):
                check(canonical_rows({f: node.kv.stable[f][i:i + 1] for f in
                                      ("valid", "tag_rep", "tag_ctr", "elem",
                                       "removed")}),
                      f"split orset: process {i}'s stable rows not canonical")
        prof = split_profile(cluster, feed, g["profile_steps"])
        split_emit(kind, g, cluster, run, prof, dict(
            recorded_pass_seconds=record_s, recorded_calls=recorded,
            committed_common_prefix=common, safe_ops_sent=feed.safe_sent,
            safe_acks=sum(int(node.kv.safe_acks().sum())
                          for node in cluster.nodes),
            cpu_checked_iterations=g.get("cpu_steps", 0) if kind == "pnc"
            else 0))
        for name, x in run["launches"].items():
            total[name] = total.get(name, 0) + x
        del cluster, feed

    # a process whose frames are corrupted in transit: its blocks fail
    # verification everywhere honest, and the honest 2f+1 keep committing
    def flip(data):
        mut = bytearray(data)
        if len(mut) > 24:
            mut[20] ^= 0xFF
        return bytes(mut)

    g = SPLIT_TAMPER
    n = g["nodes"]
    # each dropped frame logs a warning; the phase line counts them
    logging.getLogger("janus.splitnode").setLevel(logging.ERROR)
    owned = [np.arange(n) == i for i in range(n)]
    cluster = SplitCluster(split_make(dev, "pnc", g, owned), n,
                           corrupt={n - 1: flip})
    feed = SplitFeed(dev, owned, split_draw(workloads, "pnc", g, owned, 23))
    for node in cluster.nodes:
        node.start()
    done = [False] * n
    for _ in range(g["steps"]):
        for i in range(n):
            info = split_step(cluster, feed, i, idle=done[i])
            done[i] = done[i] or (info is not None and bool(info["accepted"][i]))
    torch.cuda.synchronize()
    honest = cluster.nodes[:n - 1]
    rounds = [int(node.kv.dag["node_round"][i]) for i, node in enumerate(honest)]
    check(all(done[:n - 1]), "split tamper: an honest batch never boarded")
    check(any(node.stats["verified_bad"] > 0 for node in honest),
          "split tamper: no honest process detected the tampered frames")
    check(min(rounds) > 10, f"split tamper: honest node rounds {rounds}")
    feed.boarded = {key: v for key, v in feed.boarded.items()
                    if key[1] != n - 1}
    for i, node in enumerate(honest):
        commits = node.kv.ordered_commits(i)
        check(all(src != n - 1 for _, src in commits),
              f"split tamper: process {i} committed a tampered block")
        check(set(feed.boarded) <= set(commits), f"split tamper: an honest "
              f"batch did not commit in process {i}'s view")
    split_pnc_fold_check(honest, owned[:n - 1], feed, g["keys"], n,
                         "split tamper")
    emit("split_tamper", processes=n, tampered=n - 1, iterations=g["steps"],
         honest_node_rounds=rounds,
         verified_bad=[node.stats["verified_bad"] for node in cluster.nodes])
    del cluster
    for name, rec in log.by.items():
        cases.append({"kernel": name, "case": "split_recorded", **rec})
    emit("split_kernels", by_kernel=log.by)
    return total


def split_tcp(dev, kernels, workloads):
    """Two processes of the PN-Counter cluster (two nodes each) over
    loopback TCP (``TcpPeer``): each step waits until the peer holds every
    byte sent; checks as split_consensus's (no bad frame, committed orders
    agree, every boarded batch commits, stable views agree and equal the
    numpy fold) and ms per step."""
    import socket
    import threading

    from janus_tpu_torch.net.dagplane import TcpPeer

    g = SPLIT_TCP
    n = g["nodes"]
    owned = [np.arange(n) < n // 2, np.arange(n) >= n // 2]
    sent, got = [0, 0], [0, 0]
    lock = threading.Condition()
    peers = [None, None]
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def sender(i):
        def send(data):
            with lock:
                sent[i] += len(data)
            peers[i].send(data)
        return send

    cluster = TcpCluster([split_make(dev, "pnc", g, owned)(i, sender(i))
                          for i in range(2)])

    def receiver(i):
        def receive(data):
            cluster.nodes[i].receive(data)
            with lock:
                got[i] += len(data)
                lock.notify_all()
        return receive

    accepted = {}
    th = threading.Thread(target=lambda: accepted.update(
        sock=srv.accept()[0]))
    th.start()
    peers[1] = TcpPeer.connect("127.0.0.1", port, receiver(1))
    th.join()
    peers[0] = TcpPeer(accepted["sock"], receiver(0))

    def settle(i):
        with lock:
            check(lock.wait_for(lambda: got[1 - i] == sent[i], timeout=30),
                  f"split_tcp: {sent[i] - got[1 - i]} bytes still in flight")

    feed = SplitFeed(dev, owned, split_draw(workloads, "pnc", g, owned, 24))
    try:
        for i, node in enumerate(cluster.nodes):
            node.start()
            settle(i)
        for _ in range(4):
            for i in range(2):
                split_step(cluster, feed, i)
                settle(i)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(g["steps"]):
            for i in range(2):
                split_step(cluster, feed, i)
                settle(i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernels.launches()
        idle = 0
        while idle < g["max_idle"]:
            commits = split_commits(cluster.nodes, owned)
            if idle >= g["min_idle"] and all(
                    set(feed.boarded) <= set(c) for c in commits) \
                    and split_views_agree(cluster.nodes, owned):
                break
            for i in range(2):
                split_step(cluster, feed, i, idle=True)
                settle(i)
            idle += 1
        torch.cuda.synchronize()
        commits = split_commits(cluster.nodes, owned)
        check(all(set(feed.boarded) <= set(c) for c in commits),
              "split_tcp: a boarded batch did not commit")
        check(split_views_agree(cluster.nodes, owned),
              "split_tcp: stable views differ across the processes")
        common = split_check(cluster.nodes, owned, "split_tcp")
        split_pnc_fold_check(cluster.nodes, owned, feed, g["keys"], n,
                             "split_tcp")
    finally:
        for peer in peers:
            if peer is not None:
                peer.close()
        srv.close()
    emit("split_tcp", processes=2, nodes=n, ops_per_block=g["ops_per_block"],
         keys=g["keys"], iterations=g["steps"], seconds=dt,
         ms_per_step=1e3 * dt / (2 * g["steps"]),
         ms_per_iteration=1e3 * dt / g["steps"],
         wire_bytes=sum(sent), idle_iterations_to_drain=idle,
         committed_common_prefix=common, boarded_batches=len(feed.boarded),
         signatures="ecdsa" if cluster.nodes[0].use_ecdsa else "keyed-hash")
    return launches


def split_kernel_rows(kernels, split_calls):
    """The kernels line's dag_ingest row, timed on the last recorded call
    of the PN-Counter split cluster that carried blocks. Its bytes: the
    packed batch, slot_round, block_exists and node_round read, every DAG
    cell the batch sets, node_round, and the payload rows and their
    buffer_filled bytes written; its operations: one per int32 of the
    batch."""
    args, kw = split_calls["dag_ingest"]
    cfg, state, msgs, counts = args
    probe = tree_map(torch.Tensor.clone, (state, kw))
    kernels.dag_ingest_plain(cfg, probe[0], msgs, counts, **probe[1])
    cells = sum(int((probe[0][f] != state[f]).sum()) for f in state
                if f != "node_round")
    rows = counts[4] * sum(x[0, 0].numel() for x in kw["ring"][0])
    nbytes = (4 * msgs.numel() + 4 * state["slot_round"].numel()
              + state["block_exists"].numel() + 2 * 4 * cfg.num_nodes
              + cells + 4 * rows + counts[4])
    return [dict(
        name="dag_ingest",
        call=lambda: kernels.dag_ingest(*args, **kw),
        plain=lambda: kernels.dag_ingest_plain(*args, **kw),
        library=None, bytes=nbytes, operations=msgs.numel(),
        shape=f"N{cfg.num_nodes} W{cfg.num_rounds}, {counts[0]} blocks, "
              f"{counts[1]} sigs, {counts[2]} certs, {counts[4]} payload "
              f"rows: last recorded split pnc call with blocks",
        library_note="no single PyTorch call computes it: slot-guarded "
                     "scatters of three message kinds, a first-write-wins "
                     "edge merge read from the state before the batch, a "
                     "scatter-max and the ring rows")]


def split_round_fields(kernels, split_calls):
    """dag_round's split instantiation on the last recorded split call:
    ms, device ms and plain ms, for the dag_round row."""
    args, kw = split_calls["dag_round"]
    call = lambda: kernels.dag_round(*args, **kw)  # noqa: E731
    plain = lambda: kernels.dag_round_plain(*args, **kw)  # noqa: E731
    return {"split_ms": time_cuda(call),
            "split_device_ms": device_burst_ms(call),
            "split_plain_ms": time_cuda(plain),
            "split_shape": f"N{args[0].num_nodes} W{args[0].num_rounds}, "
                           f"owned, last recorded split pnc call"}


def kernels_line(dev, kernels, path_launches, fast_ops, cases, timing_calls,
                 orset_calls, delta_calls, rga_calls, safekv_calls,
                 fence_calls, typed_calls, tp_calls, split_calls, ring_calls):
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
    from janus_tpu_torch.kernels.orset_capture import MAX_BUCKETS

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
        extra = {}
        if name == "dag_round":  # one kernel; its 16- and 64-node calls
            extra = dict(max_cuda_launches=1, more_calls={
                label: (f"N{a[0].num_nodes} W{a[0].num_rounds}, last "
                        f"recorded SafeKV call", lambda a=a, fn=fn: fn(*a))
                for label, got in safekv_calls["more"].items()
                for a, _ in [got["dag_round"]]})
        kerns.append(dict(
            name=name, call=lambda fn=fn, args=args: fn(*args),
            plain=lambda name=name, args=args: plain_of(kernels, name)(*args),
            library=None, **extra,
            shape=f"N{args[0].num_nodes} W{args[0].num_rounds}, "
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
            extra = dict(apply_rows_touched(rows, args[1]),
                         max_cuda_launches=2,
                         walk_stats=apply_walk_stats(*args))
            row_bytes = sum(x[0, 0].numel() * x.element_size()
                            for x in rows.values())
            row_elems = sum(x[0, 0].numel() for x in rows.values())
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        nops = sum(t.numel() for t in ins)
        if extra:
            nbytes += row_bytes * (extra["rows_read"] + extra["rows_written"])
            nops += row_elems * extra["rows_read"]
        if name == "orset_capture":  # the call's buckets in tag order
            got, n_ = buckets_sorted(args[1], args[0]["valid"].shape[1],
                                     MAX_BUCKETS)
            extra = {"buckets_sorted": {"sorted": got, "buckets": n_}}
        if name == "orset_replay":  # its records a (view, row) group
            extra = {"walk_stats": replay_walk_stats(*args)}
        if name == "slot_union":  # its input rows in tag order
            got = [rows_sorted(x, keys=ORSET_KEYS) for x in args[:2]]
            extra = {"rows_sorted": {"sorted": sum(x[0] for x in got),
                                     "rows": sum(x[1] for x in got)}}
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
    kerns += rga_kernel_rows(kernels, rga_calls, (
        fence_calls["rga_apply_consensus"],
        fence_calls["rga_apply_consensus_walk"]))
    kerns += safekv_kernel_rows(kernels, safekv_calls)
    kerns += fence_kernel_rows(kernels, fence_calls,
                               orset_calls["orset_compact_fences"])
    kerns += typed_kernel_rows(kernels, typed_calls)
    kerns += tp_kernel_rows(kernels, tp_calls)
    kerns += split_kernel_rows(kernels, split_calls)
    kerns += ring_kernel_rows(kernels, ring_calls)

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
        measure_t0 = time.perf_counter()
        row = {k: kern[k] for k in ("bytes", "operations", "shape",
                                    "cells_touched", "keys_marked",
                                    "rows_read", "rows_written", "rows_joined",
                                    "rows_sorted", "buckets_sorted",
                                    "longest_walk", "walk_blocks_per_sm",
                                    "walk_stats", "max_cuda_launches",
                                    "walk_threads_per_block", "library_note",
                                    "grow", "consensus", "rows_changed",
                                    "more_bound_ms")
               if k in kern}
        row["ms"] = time_cuda(kern["call"])
        reps, one_ms = plain_reps(kern["plain"])
        # a plain version over the budget is its one timed call (seconds
        # of small launches: no second call for the same figure)
        row["plain_ms"] = (one_ms if one_ms > PLAIN_BUDGET_MS else
                           time_cuda(kern["plain"], reps=reps, warmup=0))
        row["library_ms"] = (None if kern["library"] is None
                             else time_cuda(kern["library"]))
        row["device_ms"] = device_burst_ms(kern["call"])
        if "longest_walk" in kern:  # device time per write of that walk
            row["device_us_per_write"] = (1e3 * row["device_ms"]
                                          / kern["longest_walk"])
        before = kernels.WRAPPERS[name].launches
        row["profiler_kernels_seen"], _ = device_profile(kern["call"], reps=20)
        row["profiled_launches"] = kernels.WRAPPERS[name].launches - before
        if "max_cuda_launches" in kern:  # a launch limit the row states
            got = row["cuda_launches_per_call"] = graph_kernels(kern["call"])
            check(0 < got <= kern["max_cuda_launches"],
                  f"{name}: {got} CUDA kernels a call (a captured graph), "
                  f"at most {kern['max_cuda_launches']} stated")
        if "shape" in kern and (one_ms > PLAIN_PROFILE_MAX_MS
                                or not kern.get("profile_plain", True)):
            # the profiler's processing of a plain call of ~10^5 small
            # kernels takes minutes: not measured
            row.update(plain_device_ms=None, plain_kernels_per_call=None)
        elif "shape" in kern:
            seen, plain_dev_ms = device_profile(kern["plain"], reps=3)
            row.update(plain_device_ms=plain_dev_ms / 3,
                       plain_kernels_per_call=seen / 3)
        row["measure_seconds"] = time.perf_counter() - measure_t0
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
        if name == "dag_round":
            out[-1].update(split_round_fields(kernels, split_calls))
        for label, (shape, call) in kern.get("more_calls", {}).items():
            # the same wrapper on recorded calls of other geometries
            out[-1].update({f"{label}_ms": time_cuda(call),
                            f"{label}_device_ms": device_burst_ms(call),
                            f"{label}_shape": shape})
    emit("profiler_check", calls=20, add_kernels_seen=control_seen,
         causal_closure_seen_after_tusk_commit_plain=after_large_seen)
    return out


def nonzero_frames(logs) -> list:
    """``source: function: frame line`` for every function whose stack
    frame or spills are not 0 in ``build.build_all``'s compiler output (a
    ``{source: log}`` dict; ptxas -v names the function, in a "Compiling
    entry function" or "Function properties for" line, before its frame
    line)."""
    out = []
    for src, log in logs.items():
        fn = "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif "Function properties for" in ln:
                fn = ln.split("Function properties for", 1)[1].strip()
            elif "stack frame" in ln:
                w = ln.split()
                if w[0] + w[4] + w[8] != "000":
                    out.append(f"{src}: {fn}: {ln.strip()}")
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
    frames = nonzero_frames(res["log"])
    emit("build", seconds=res["seconds"], nvcc=build.nvcc(),
         flags=" ".join(build.NVCC_FLAGS), ptxas=ptxas,
         nonzero_frames=frames)
    check(not [f for f in frames
               if f.startswith(("slot_union: ", "graph_apply: ",
                                "rga_apply: ", "ring_resize: ",
                                "orset_replay: ", "lww_apply: ",
                                "orset_apply: ", "block_select: ",
                                "gc_frontier: ", "safekv_submit: ",
                                "dag_round: ", "orset_compact: "))],
          "build: a slot_union.cu, graph_apply.cu, rga_apply.cu, "
          "ring_resize.cu, orset_replay.cu, lww_apply.cu, orset_apply.cu, "
          "block_select.cu, gc_frontier.cu, safekv_submit.cu, dag_round.cu "
          "or orset_compact.cu function has a stack frame or spills")

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
    safekv_calls = timed("safekv_kernels", safekv_kernel_checks, dev, kernels,
                         workloads, cases)
    fence_calls = timed("fence_kernels", fence_kernel_checks, dev, kernels,
                        workloads, cases)
    timed("ingest_kernels", ingest_kernel_checks, dev, kernels, workloads,
          cases)
    split_calls, ring_calls = {}, {}
    paths = {"fast_path": timed("fast_path", fast_path, dev, kernels, workloads),
             "consensus": timed("consensus", consensus_path, dev, kernels,
                                workloads, cases),
             "orset_store": timed("orset_store", orset_store, dev, kernels,
                                  workloads),
             "orset_consensus": timed("orset_consensus", orset_consensus, dev,
                                      kernels, workloads),
             "rga_consensus": timed("rga_consensus", rga_consensus, dev,
                                    kernels, workloads),
             "store_delta": timed("store_delta", store_delta, dev, kernels,
                                  workloads),
             "rga_replay": timed("rga_replay", rga_replay, dev, kernels,
                                 workloads),
             "harness_tensor": timed("harness_tensor", harness_tensor, dev,
                                     kernels, workloads, smi),
             "harness_adaptive": timed("harness_adaptive", harness_adaptive,
                                       dev, kernels, workloads, smi,
                                       ring_calls),
             "harness_faults": timed("harness_faults", harness_faults, dev,
                                     kernels, workloads, smi),
             "lww_consensus": timed("lww_consensus", lww_consensus, dev,
                                    kernels, workloads),
             "mvr_consensus": timed("mvr_consensus", mvr_consensus, dev,
                                    kernels, workloads),
             "typed_store": timed("typed_store", typed_store, dev, kernels,
                                  workloads),
             "tpset_consensus": timed("tpset_consensus", tpset_consensus, dev,
                                      kernels, workloads),
             "graph_consensus": timed("graph_consensus", graph_consensus, dev,
                                      kernels, workloads),
             "tp_store": timed("tp_store", tp_store, dev, kernels,
                               workloads),
             "split_consensus": timed("split_consensus", split_consensus, dev,
                                      kernels, workloads, cases, split_calls),
             "split_tcp": timed("split_tcp", split_tcp, dev, kernels,
                                workloads)}
    # after the timed paths, so that nothing it keeps (clones of the
    # recorded calls, tree scratch, the allocator's growth) is there while
    # the earlier phases are timed
    ring_calls = timed("ring_kernels", ring_kernel_checks, dev, kernels,
                       workloads, cases, ring_calls)
    typed_calls = timed("typed_kernels", typed_kernel_checks, dev, kernels,
                        workloads, cases)
    tp_calls = timed("tp_kernels", tp_kernel_checks, dev, kernels, workloads,
                     cases)
    line = timed("kernels_line", kernels_line, dev, kernels, paths, fast_ops,
                 cases, timing_calls, orset_calls, delta_calls, rga_calls,
                 safekv_calls, fence_calls, typed_calls, tp_calls, split_calls,
                 ring_calls)
    emit("timing", seconds=time.perf_counter() - started, by_phase=phase_s)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

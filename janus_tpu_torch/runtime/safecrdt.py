"""SafeCRDT dual-state runtime: prospective + stable key spaces driven by
the ring-buffered DAG (counterpart: janus_tpu/runtime/safecrdt.py).

One emulated N-node cluster in one dict of tensors:

    prospective  type-state with leading node axis [N, K, ...]
    stable       same shape
    ops_buffer   [W, N, B] op records: the op batch carried by block (r,s),
                 plus [W, N, B, width] per-op capture extras of types with
                 effect capture (``spec.op_extras``)
    prosp_applied / stable_applied  bool[N, W, N]: which blocks each node
                 has folded into which state

Per round: buffered ops ride the node's next block; blocks newly
certified in a node's view apply to its prospective state (gated by
causal closure); blocks newly committed apply to its stable state; a
quorum-based GC frontier recycles finished slots. The device part of a
round (``_step_device``) reads no tensor value on the host; its outputs
the host needs are packed into one int32 vector, fetched once per round
by ``step_absorb``. Every phase of a round is a hand kernel:

    submit           ``safekv_submit`` (accept, then board after the
                     type's capture)
    state transfer   ``state_transfer``
    DAG round        ``dag_round``
    closure          ``causal_closure``
    delta applies    ``block_select`` (selection + gather), twice
    commit           ``tusk_commit``
    GC + pack        ``gc_frontier`` (and ``gc_clear_ring``)

and the type's apply runs through its own kernels: the PN-Counter's
through ``pnc_apply``; the OR-Set's capture through ``orset_capture`` and
its applies through ``orset_replay``. Unlike JAX's pure functions, the
board, the state transfer, the delta applies' masks and the GC update the
carry's tensors in place; ``state_arrays`` copies them out. A type with a
``compact_fence`` (the OR-Set) is compacted, in plain PyTorch, whenever a
round advanced the GC frontier (``maybe_compact``, called from
``step_absorb``).

The stage histograms (``obs.stages``: seal, dag_round, commit, apply) are
recorded as in the JAX package. Not in this port yet: the split
``submit``/``tick`` path, ``resize_block``, checkpoint/restore,
``MultiKV``, and the flight recorder.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.consensus import dag as dagmod
from janus_tpu_torch.consensus import tusk
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.models import base
from janus_tpu_torch.obs import stages as obs_stages
from janus_tpu_torch.obs.metrics import get_registry

# waves each view's commit evaluates per round
COMMIT_STEPS = 2

# device tensors handed across by ``state_arrays`` / ``load_state``
DEVICE_FIELDS = ("prospective", "stable", "dag", "commit", "ops_buffer",
                 "buffer_filled", "prosp_applied", "stable_applied",
                 "force_transfer")
# host bookkeeping needed to continue a run
HOST_FIELDS = ("tick_count", "_absorb_tick", "submit_tick", "commit_tick",
               "submit_wall", "safe_host", "pending_safe_acks",
               "_host_slot_round", "commit_log", "latency_log",
               "wall_latency_log", "stats")


class SafeKV:
    """An emulated N-node Reliable-CRDT cluster for one replicated type,
    on ``device`` (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: dagmod.DagConfig, spec, ops_per_block: int,
                 seed: int = 0, apply_budget: int | None = None,
                 collect_logs: bool = True, device=None, **dims):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec
        self.B = ops_per_block
        self.seed = seed
        self.collect_logs = collect_logs
        n, w = cfg.num_nodes, cfg.num_rounds
        # blocks applied per view per tick; steady state certifies N new
        # blocks per tick, so 4N gives catch-up headroom
        self.apply_budget = apply_budget if apply_budget is not None else 4 * n

        if not (spec.replay_safe or spec.prepare_ops is not None
                or spec.prepare_ops_batch is not None):
            raise ValueError(
                f"type {spec.name!r} is not replay-safe: its apply_ops "
                "reads uncaptured local state, so replicated replay under "
                "differing certify/commit batchings would silently "
                "diverge. Give it prepare_ops effect capture or declare "
                "replay_safe=True.")

        dev = self.device
        one = spec.init(**dims, device=dev)

        def rep(x):
            return x.expand((n,) + tuple(x.shape)).clone(
                memory_format=torch.contiguous_format)

        self.prospective = {f: rep(x) for f, x in one.items()}
        self.stable = {f: rep(x) for f, x in one.items()}
        self.dag = dagmod.init(cfg, dev)
        self.commit = tusk.init_commit(cfg, dev)
        # effect-capture extras resolve their width against the type dims
        # (and the cluster size), or are literal ints
        dim_env = {**dims, "num_nodes": n}
        for target, source in spec.dim_defaults.items():
            if target not in dim_env and source in dim_env:
                dim_env[target] = dim_env[source]
        self.extra_widths = {
            name: int(dim_env[dim]) if isinstance(dim, str) else int(dim)
            for name, dim in spec.op_extras.items()}
        self.ops_buffer = {f: torch.zeros((w, n, self.B), dtype=torch.int32,
                                          device=dev)
                           for f in base.OP_FIELDS}
        for name, width in self.extra_widths.items():
            self.ops_buffer[name] = torch.zeros((w, n, self.B, width),
                                                dtype=torch.int32, device=dev)
        self.buffer_filled = torch.zeros((w, n), dtype=torch.bool, device=dev)
        self.prosp_applied = torch.zeros((n, w, n), dtype=torch.bool, device=dev)
        self.stable_applied = torch.zeros((n, w, n), dtype=torch.bool, device=dev)
        # views flagged by last tick's GC as having missed a recycled slot
        self.force_transfer = torch.zeros((n,), dtype=torch.bool, device=dev)
        # host-side bookkeeping, all survives GC
        self.submit_tick = np.full((w, n), -1, np.int64)
        self.commit_tick = np.full((w, n), -1, np.int64)
        self.submit_wall = np.full((w, n), np.nan)
        self.wall_latency_log: list[float] = []
        self.safe_host = np.zeros((w, n, self.B), bool)
        self.pending_safe_acks = np.zeros((w, n, self.B), bool)
        self.tick_count = 0
        self.max_latency_log = 200_000
        self.latency_log: list[int] = []
        self.commit_log: list[list[tuple[int, int]]] = [[] for _ in range(n)]
        self._host_slot_round = np.arange(w, dtype=np.int64)
        self.stats: Dict[str, int] = {
            "ticks": 0, "blocks_submitted": 0, "own_commits": 0,
            "slots_recycled": 0, "gc_advances": 0, "state_transfers": 0,
            "compactions": 0, "block_resizes": 0, "slots_dropped": 0,
        }
        # measured per-stage latency histograms (seal / dag_round / commit
        # / apply), scoped by type so two runtimes stay apart
        self.stage_scope = getattr(spec, "type_code",
                                   getattr(spec, "name", "kv"))
        self._stage = obs_stages.stage_histograms(self.stage_scope)
        # in-order absorb cursor for the dispatch/absorb step path
        self._absorb_tick = 0

    # -- state carried across ---------------------------------------------

    def state_arrays(self) -> dict:
        """Every device tensor (as numpy) and the host bookkeeping needed
        to continue this run elsewhere (``load_state``)."""
        out = {f: convert.tree_to_numpy(getattr(self, f)) for f in DEVICE_FIELDS}
        for f in HOST_FIELDS:
            v = getattr(self, f)
            out[f] = (v.copy() if isinstance(v, np.ndarray)
                      else [list(x) for x in v] if f == "commit_log"
                      else dict(v) if isinstance(v, dict)
                      else list(v) if isinstance(v, list) else v)
        return out

    def load_state(self, arrays) -> None:
        """Adopt a state written by ``state_arrays`` — or read off a
        ``janus_tpu`` SafeKV of the same configuration by attribute name
        (its arrays convert through numpy) — and continue from it."""
        for f in DEVICE_FIELDS:
            setattr(self, f, convert.tree_from_numpy(
                convert.tree_to_numpy(arrays[f]), self.device))
        self.tick_count = int(arrays["tick_count"])
        self._absorb_tick = int(arrays["_absorb_tick"])
        for f in ("submit_tick", "commit_tick", "submit_wall", "safe_host",
                  "pending_safe_acks", "_host_slot_round"):
            setattr(self, f, np.array(arrays[f], copy=True))
        self._host_slot_round = self._host_slot_round.astype(np.int64)
        self.commit_log = [[tuple(map(int, e)) for e in log]
                           for log in arrays["commit_log"]]
        self.latency_log = [int(x) for x in arrays["latency_log"]]
        self.wall_latency_log = [float(x) for x in arrays["wall_latency_log"]]
        self.stats = {k: int(v) for k, v in arrays["stats"].items()}

    # -- device programs ---------------------------------------------------

    def _submit_device(self, prospective, dag_state, ops_buffer, buffer_filled,
                       prosp_applied, ops: base.OpBatch,
                       active: Optional[torch.Tensor] = None):
        """Accept (``safekv_submit``), the type's capture and origin apply,
        and the ring write (``safekv_board``, in place). Returns
        ``(prospective, ops_buffer, buffer_filled, prosp_applied,
        accepted, pre_round)``; ``pre_round`` is the slot each batch
        boards, copied before later phases change ``node_round``."""
        acc_ops, accepted, pre_round = kernels.safekv_submit(
            self.cfg, dag_state, buffer_filled, ops, active)
        # origin fast-path apply: the views' batches are the leading axis
        # of the state
        new_prosp, acc_ops = base.capture_and_apply(self.spec, prospective, acc_ops)
        kernels.safekv_board(self.cfg, ops_buffer, buffer_filled, prosp_applied,
                             acc_ops, accepted, pre_round)
        return (new_prosp, ops_buffer, buffer_filled, prosp_applied, accepted,
                pre_round)

    def _round_step(self, dag_state, active, withhold, invalid):
        """One DAG protocol round for every node."""
        return dagmod.round_step(self.cfg, dag_state, active, withhold, invalid)

    def _causal_closure(self, dag_state, applied):
        """Blocks applicable in each view: certificate held, not yet
        applied, and every referenced predecessor already applied (or
        becoming applicable this tick, earlier in round order); the slot
        holding ``base_round`` has its predecessor applied by definition.
        One ``causal_closure`` kernel launch."""
        return kernels.causal_closure(self.cfg, dag_state, applied)

    def _delta_apply(self, state, ops_buffer, ready, applied, slot_round,
                     base_round, commit_seq=None):
        """Apply the op batches of the blocks ``ready & ~applied``, lowest
        key first (prospective order, or commit order given
        ``commit_seq``), bounded by apply_budget per view: one
        ``block_select`` call, which ORs the choice into ``applied`` in
        place, then the type's apply on the gathered batch. Returns
        ``(state, dropped int32[V] or None)``."""
        batch, _, _ = kernels.block_select(
            self.cfg, ops_buffer, ready, applied, self.apply_budget,
            slot_round, base_round, commit_seq)
        if self.spec.apply_ops_dropped is not None:
            # the drop count only: a dirty mask would go unused here
            return self.spec.apply_ops_dropped(state, batch)
        return self.spec.apply_ops(state, batch), None

    def _state_transfer(self, prospective, stable, dag_state, cstate,
                        prosp_applied, stable_applied, force):
        """Crash/lag recovery: a view below the GC frontier, or whose
        commit cursor lags the cluster beyond the repair window, adopts a
        snapshot from the most-advanced view (the first argmax), in place
        (one ``state_transfer`` call). Returns the states (the same
        objects) with ``need`` and ``donor``."""
        leaves = [*prospective.values(), *stable.values(),
                  *(dag_state[f] for f in ("block_seen", "cert_seen",
                                           "node_round")),
                  *(cstate[f] for f in ("committed", "commit_seq", "last_wave",
                                        "eval_wave", "commit_counter")),
                  prosp_applied, stable_applied]
        need, donor = kernels.state_transfer(
            self.cfg, leaves, dag_state["node_round"], dag_state["base_round"],
            cstate["last_wave"], force)
        return (prospective, stable, dag_state, cstate, prosp_applied,
                stable_applied, need, donor)

    def _tick_device(self, prospective, stable, dag_state, cstate, ops_buffer,
                     buffer_filled, prosp_applied, stable_applied, force,
                     active: Optional[torch.Tensor],
                     withhold: Optional[torch.Tensor],
                     invalid: Optional[torch.Tensor], pre_round, accepted):
        """One round after the submit: transfer, DAG round, both delta
        applies, commit, and the GC with the round's pack
        (``gc_frontier``). Returns the carry, ``lost`` and ``packed``."""
        (prospective, stable, dag_state, cstate, prosp_applied,
         stable_applied, transferred, donor) = self._state_transfer(
            prospective, stable, dag_state, cstate, prosp_applied,
            stable_applied, force)

        dag_state = self._round_step(dag_state, active, withhold, invalid)

        # -- prospective: delta-apply newly certified, causally-ready blocks
        prosp_ready = self._causal_closure(dag_state, prosp_applied)
        prospective, drop_p = self._delta_apply(
            prospective, ops_buffer, prosp_ready, prosp_applied,
            dag_state["slot_round"], dag_state["base_round"])

        # -- commit + stable: delta-apply newly committed blocks in order
        com_before = cstate["committed"]
        cstate = tusk.commit_view(self.cfg, dag_state, cstate, seed=self.seed,
                                  steps=COMMIT_STEPS)
        stable, drop_s = self._delta_apply(
            stable, ops_buffer, cstate["committed"], stable_applied,
            cstate["slot_round"], dag_state["base_round"], cstate["commit_seq"])

        # -- GC: advance the frontier past rounds finished by the GC
        # quorum (see the JAX package for the full argument), recycle in
        # place, and pack the host outputs
        lost, dead, packed = kernels.gc_frontier(
            self.cfg, dag_state, cstate, com_before, prosp_applied,
            stable_applied, buffer_filled, pre_round, accepted, transferred,
            donor, (drop_p, drop_s), self.collect_logs)
        kernels.gc_clear_ring(self.cfg, ops_buffer, dead)
        return (prospective, stable, dag_state, cstate, ops_buffer,
                buffer_filled, prosp_applied, stable_applied, lost, packed)

    def _step_device(self, prospective, stable, dag_state, cstate, ops_buffer,
                     buffer_filled, prosp_applied, stable_applied, force,
                     ops: base.OpBatch,
                     active: Optional[torch.Tensor],
                     withhold: Optional[torch.Tensor],
                     invalid: Optional[torch.Tensor] = None):
        """Fused submit + tick, with every host-needed output packed into
        one int32 vector (the one device-to-host fetch of a round). The
        carry's tensors are updated in place where a kernel allows it."""
        (prospective, ops_buffer, buffer_filled, prosp_applied, accepted,
         pre_round) = self._submit_device(
            prospective, dag_state, ops_buffer, buffer_filled,
            prosp_applied, ops, active)
        return self._tick_device(
            prospective, stable, dag_state, cstate, ops_buffer, buffer_filled,
            prosp_applied, stable_applied, force, active, withhold, invalid,
            pre_round, accepted)

    # -- host API ----------------------------------------------------------

    def _carry(self):
        return (self.prospective, self.stable, self.dag, self.commit,
                self.ops_buffer, self.buffer_filled, self.prosp_applied,
                self.stable_applied, self.force_transfer)

    def _set_carry(self, carry) -> None:
        (self.prospective, self.stable, self.dag, self.commit,
         self.ops_buffer, self.buffer_filled, self.prosp_applied,
         self.stable_applied, self.force_transfer) = carry

    def _on_device(self, tree, dtype):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {f: self._on_device(v, dtype) for f, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(tree), dtype=dtype, device=self.device)

    def _dispatch(self, ops, active, withhold, invalid) -> torch.Tensor:
        out = self._step_device(
            *self._carry(), self._on_device(ops, torch.int32),
            self._on_device(active, torch.bool),
            self._on_device(withhold, torch.bool),
            self._on_device(invalid, torch.bool))
        self._set_carry(out[:9])
        return out[9]

    def _rec_mask(self, record) -> np.ndarray:
        n = self.cfg.num_nodes
        if record is True:
            return np.ones((n,), bool)
        if record is False:
            return np.zeros((n,), bool)
        return np.asarray(record, bool)

    def step_k_dispatch(self, ops_k, safe_k=None, active=None, withhold=None,
                        record=True, invalid=None):
        """Dispatch K fused rounds; returns (packed_k, metas). Pass both to
        ``step_k_absorb`` in dispatch order. ``ops_k``: [K, N, B] per
        field; ``safe_k``: optional [K, N, B] bools."""
        k = int(next(iter(ops_k.values())).shape[0])
        packed = [self._dispatch({f: v[j] for f, v in ops_k.items()},
                                 active, withhold, invalid) for j in range(k)]
        return torch.stack(packed), self._k_metas(k, safe_k, record)

    def _k_metas(self, k: int, safe_k, record) -> list:
        """Host-side metas for K dispatched rounds: one (stamp, tick,
        safe, record-mask) tuple per round, advancing the tick counter."""
        rec_mask = self._rec_mask(record)
        now = time.perf_counter()
        metas = []
        for j in range(k):
            safe = None if safe_k is None else np.asarray(safe_k[j], bool)
            metas.append((now, self.tick_count, safe, rec_mask))
            self.tick_count += 1
        return metas

    def step_k_absorb(self, packed_k, metas,
                      observed_at: float | None = None) -> list:
        """Absorb K fused rounds' packed outputs (one fetch)."""
        rows = _to_numpy(packed_k)
        return [self.step_absorb(rows[j], meta, observed_at=observed_at)
                for j, meta in enumerate(metas)]

    def _absorb_commits(self, own: np.ndarray, rec: np.ndarray,
                        tick_idx: int, now: float,
                        update_rounds: bool, dropped: int = 0) -> np.ndarray:
        """Host bookkeeping for one completed tick: newly-committed
        detection, latency logs, safe acks, recycled-slot resets. ``own``
        is the [W, N] own-block commit mask; ``rec`` the [W] recycled
        mask."""
        apply_t0 = time.perf_counter_ns()
        self.stats["ticks"] += 1
        self.stats["own_commits"] += int(own.sum())
        if dropped:
            self.stats["slots_dropped"] += dropped
            get_registry().counter("slots_dropped_total").add(dropped)
        if rec.any():
            self.stats["slots_recycled"] += int(rec.sum())
            self.stats["gc_advances"] += 1
        newly = own & (self.submit_tick >= 0) & (self.commit_tick < 0)
        self.commit_tick[newly] = tick_idx + 1
        self.latency_log.extend(
            (tick_idx + 1 - self.submit_tick[newly]).tolist())
        if newly.any():
            walls = (now - self.submit_wall[newly]).tolist()
            self.wall_latency_log.extend(walls)
            h_commit = self._stage["commit"]
            for wsec in walls:
                h_commit.record_seconds(wsec)
        for log in (self.latency_log, self.wall_latency_log):
            if len(log) > self.max_latency_log:
                del log[: len(log) - self.max_latency_log]
        self.pending_safe_acks |= newly[:, :, None] & self.safe_host
        if rec.any():
            self.submit_tick[rec] = -1
            self.commit_tick[rec] = -1
            self.submit_wall[rec] = np.nan
            self.safe_host[rec] = False
            if update_rounds:
                # recycling adds exactly W to a slot's round
                self._host_slot_round[rec] += self.cfg.num_rounds
            # a GC advance is the coordination point where tombstones
            # whose ops left the window can be reclaimed
            self.maybe_compact()
        self._stage["apply"].record(time.perf_counter_ns() - apply_t0)
        return newly

    def _compact_device(self, prospective, stable, ops_buffer):
        """The type's GC-fence compaction of every view's prospective and
        stable state, guarded by the ops still in the live window."""
        w, n = self.cfg.num_rounds, self.cfg.num_nodes
        flat = {f: x.reshape((w * n * self.B,) + x.shape[3:])
                for f, x in ops_buffer.items()}
        return (self.spec.compact_fence(prospective, flat),
                self.spec.compact_fence(stable, flat))

    def maybe_compact(self) -> bool:
        """Compact at a GC fence (called when a round recycled slots; a
        no-op for types without a ``compact_fence``)."""
        if self.spec.compact_fence is None:
            return False
        self.prospective, self.stable = self._compact_device(
            self.prospective, self.stable, self.ops_buffer)
        self.stats["compactions"] += 1
        return True

    def step_dispatch(self, ops: base.OpBatch,
                      safe: Optional[np.ndarray] = None,
                      active=None, withhold=None, record=True,
                      invalid=None):
        """Fused submit + protocol round, queued on the device with no
        host synchronisation. Returns ``(packed, meta)``; pass both to
        ``step_absorb`` in dispatch order. ``record`` (bool or [N] mask)
        marks which nodes' blocks carry real client payload this round."""
        packed = self._dispatch(ops, active, withhold, invalid)
        meta = (time.perf_counter(), self.tick_count,
                None if safe is None else np.asarray(safe, bool),
                self._rec_mask(record))
        self.tick_count += 1
        return packed, meta

    def step_absorb(self, packed, meta, observed_at: float | None = None) -> dict:
        """Complete bookkeeping for one dispatched step. ``packed`` may be
        the device tensor (fetched here: the round's one device-to-host
        copy) or an already-fetched numpy copy. Returns {accepted[N],
        own[W,N], recycled[W], slot[N], round[N], slots_dropped}."""
        stamp, tick_idx, safe, rec_mask = meta
        if tick_idx != self._absorb_tick:
            raise RuntimeError(
                f"step_absorb out of order: got tick {tick_idx}, "
                f"expected {self._absorb_tick}")
        self._absorb_tick += 1
        cfg = self.cfg
        n, w = cfg.num_nodes, cfg.num_rounds
        flat = _to_numpy(packed)
        pre_round = flat[:n]
        acc = flat[n: 2 * n].astype(bool)
        own = flat[2 * n: 2 * n + n * w].reshape(n, w).T.astype(bool)  # [W,N]
        off = 2 * n + n * w
        rec = flat[off: off + w].astype(bool)
        dropped = int(flat[off + w])
        now = observed_at if observed_at is not None else time.perf_counter()

        s = pre_round % w
        vs = np.arange(n)
        st = acc & rec_mask  # only payload-bearing blocks enter the stats
        # dispatch->absorb wall = one consensus round; when payload boarded
        # this round, the same interval is the block-seal leg
        round_ns = int((now - stamp) * 1e9)
        self._stage["dag_round"].record(round_ns)
        if st.any():
            self._stage["seal"].record(round_ns)
        self.stats["blocks_submitted"] += int(st.sum())
        self.submit_tick[s[st], vs[st]] = tick_idx
        self.submit_wall[s[st], vs[st]] = stamp
        if safe is not None:
            self.safe_host[s[st], vs[st]] = safe[st]

        if self.collect_logs:
            # donor copy on transfer, then per-view ordered append using
            # the PRE-recycle slot->round map
            off += w + 1
            transferred = flat[off: off + n].astype(bool)
            donor = int(flat[off + n])
            off += n + 1
            fresh_com = flat[off: off + n * w * n].reshape(n, w, n).astype(bool)
            off += n * w * n
            seqs = flat[off: off + n * w * n].reshape(n, w, n)
            off += n * w * n
            slot_round = flat[off: off + w].astype(np.int64)
            if transferred.any():
                self.stats["state_transfers"] += int(transferred.sum())
                for v in np.nonzero(transferred)[0]:
                    self.commit_log[int(v)] = list(self.commit_log[donor])
            rounds = self._host_slot_round
            for v in range(n):
                ss, src = np.nonzero(fresh_com[v])
                if ss.size:
                    order = np.lexsort((src, rounds[ss], seqs[v, ss, src]))
                    self.commit_log[v].extend(
                        (int(rounds[ss[i]]), int(src[i])) for i in order)
            self._absorb_commits(own, rec, tick_idx, now, update_rounds=False,
                                 dropped=dropped)
            self._host_slot_round = slot_round
        else:
            self._absorb_commits(own, rec, tick_idx, now, update_rounds=True,
                                 dropped=dropped)
        return {"accepted": acc, "own": own, "recycled": rec, "slot": s,
                "round": pre_round.copy(), "slots_dropped": dropped}

    def step(self, ops: base.OpBatch, safe: Optional[np.ndarray] = None,
             active=None, withhold=None, record=True, invalid=None) -> dict:
        """Synchronous fused step: one dispatch + one fetch per round."""
        packed, meta = self.step_dispatch(ops, safe, active, withhold, record,
                                          invalid)
        return self.step_absorb(packed, meta)

    def safe_acks(self) -> np.ndarray:
        """[W, N, B] mask of safe ops acked since the last drain (the op's
        block committed in its origin's own view)."""
        return self.pending_safe_acks.copy()

    def drain_safe_acks(self) -> np.ndarray:
        """Return and clear the accumulated [W, N, B] safe-ack mask."""
        acks = self.pending_safe_acks
        self.pending_safe_acks = np.zeros_like(acks)
        return acks

    def commit_latencies(self) -> np.ndarray:
        """Ticks from submit to stable commit in the origin's own view,
        for every block that completed the full path (survives GC)."""
        return np.asarray(self.latency_log, dtype=np.int64)

    def base_round(self) -> int:
        """Current GC frontier (lowest live logical round)."""
        return int(self.dag["base_round"].cpu())

    def query_prospective(self, name: str, *args):
        return self.spec.queries[name](self.prospective, *args)

    def query_stable(self, name: str, *args):
        return self.spec.queries[name](self.stable, *args)

    def ordered_commits(self, node: int):
        """The node's full committed total order, (round, source) pairs,
        from the host-side append-only log (GC-proof)."""
        return list(self.commit_log[node])


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

"""``gc_frontier``: SafeKV's GC frontier, the recycle of the slots it
frees, the pack of a round's host outputs and the clear of the freed
ring rows, in one call (kernel source: csrc/gc_frontier.cu).

Replaces the GC of janus_tpu/runtime/safecrdt.py ``SafeKV._tick_device``
and the pack of ``_step_device``, with janus_tpu/consensus/dag.py
``recycle`` and janus_tpu/consensus/tusk.py ``recycle_commit``. The
frontier advances past the run of slots from ``base_round`` up that the GC
quorum has finished and that can gain no new commit; the DAG and commit
fields, ``buffer_filled`` and both applied masks of the dead slots are
cleared in place (JAX returns new arrays). The pack is JAX's int32
vector: ``pre_round [N]``, ``accepted [N]``, the own-block commits ``[N *
W]`` (pre-GC), ``recycled = dead [W]``, the round's slots dropped ``[1]``,
and with ``collect_logs`` the transfer mask ``[N]``, the donor ``[1]``,
the fresh commits and ``commit_seq`` ``[N * W * N]`` each (pre-GC) and
``slot_round`` ``[W]`` (post-GC).

A ``gc_frontier`` call is two CUDA launches (the GC, one block; then the
recycle, the logs and the ring clear, launched while the GC runs and
waiting for it) on the lean launch path, its outputs views of one
buffer. Each call adds one to ``gc_frontier.launches`` and reads no
value on the host. For CUDA tensors the wrapper launches its kernels (or
raises); the ``*_plain`` versions run only for tensors that lie on the
CPU: ``gc_round_plain`` is the whole call's, ``gc_frontier_plain`` then
``gc_clear_ring_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.dag_phases import slot_of

INT32_MAX = torch.iinfo(torch.int32).max
MAX_ROUNDS = 32
MAX_FIELDS = 16
_DAG_CLEAR = ("edges", "block_exists", "block_seen", "acks", "cert_exists",
              "cert_seen")


def can_gain(cfg, frozen, direct, any_unc, base_r) -> torch.Tensor:
    """bool[W]: slots whose round can still gain a new commit, scanned
    from the highest live round down (a slot can gain if it is not frozen,
    or holds uncommitted certs reachable by a future anchor at it or by
    descent from a round above that can gain)."""
    w = cfg.num_rounds
    dev = frozen.device
    desc = torch.arange(w - 1, -1, -1, device=dev, dtype=torch.int32)
    order = slot_of(cfg, base_r + desc).long()  # highest round first
    f, d, u = frozen[order], direct[order], any_unc[order]
    can_above = torch.ones((), dtype=torch.bool, device=dev)
    gains = []
    for i in range(w):
        can_above = ~f[i] | ((d[i] | can_above) & u[i])
        gains.append(can_above)
    can = torch.zeros((w,), dtype=torch.bool, device=dev)
    return can.index_put((order,), torch.stack(gains))


def pack_size(cfg, collect_logs: bool) -> int:
    n, w = cfg.num_nodes, cfg.num_rounds
    return 2 * n + n * w + w + 1 + (n + 1 + 2 * n * w * n + w
                                    if collect_logs else 0)


def gc_frontier_plain(cfg, dag_state, cstate, com_before, prosp_applied,
                      stable_applied, buffer_filled, pre_round, accepted,
                      transferred, donor, drops, collect_logs: bool):
    """Plain PyTorch version: returns ``(lost bool[N], dead bool[W],
    packed int32[P])`` and recycles the DAG and commit state, the applied
    masks and ``buffer_filled`` in place. ``drops``: the two delta
    applies' dropped counts, int32[V] each, or None."""
    n, w = cfg.num_nodes, cfg.num_rounds
    dev = buffer_filled.device
    i32 = torch.int32
    com = cstate["committed"]            # [N, W, N]
    lw = cstate["last_wave"]             # [N]
    lw_q = torch.sort(lw).values[n - cfg.quorum]
    mask_q = lw >= lw_q                  # [N] the GC quorum
    com_ref = (com & mask_q[:, None, None]).any(0)            # [W, N]
    com_ok = (com == com_ref[None]).all(-1)                   # [N, W]
    st_ok = (stable_applied == com_ref[None]).all(-1)         # [N, W]
    cert = dag_state["cert_exists"][None]
    diag = torch.eye(n, dtype=torch.bool, device=dev)[:, None, :]
    mism = prosp_applied != cert
    allowed = diag & prosp_applied & ~cert
    pr_ok = (~mism | allowed).all(-1)                         # [N, W]
    view_done = com_ok & st_ok & pr_ok                        # [N, W]
    q_done = (view_done | ~mask_q[:, None]).all(0)            # [W]
    nr_q = torch.sort(dag_state["node_round"]).values[n - cfg.quorum]
    sr = dag_state["slot_round"].clone()
    csr = cstate["slot_round"].clone()
    base_r = dag_state["base_round"].clone()
    frozen = sr + 2 <= nr_q
    any_unc = (dag_state["cert_exists"] & ~com_ref).any(-1)   # [W]
    ew_min_q = torch.where(mask_q, cstate["eval_wave"], INT32_MAX).min()
    direct = (sr % 2 == 0) & (sr // 2 > ew_min_q)             # [W]
    collectible = q_done & ~can_gain(cfg, frozen, direct, any_unc, base_r)
    in_order = collectible[slot_of(
        cfg, base_r + torch.arange(w, dtype=i32, device=dev)).long()]
    adv = torch.cumprod(in_order.to(i32), 0).sum().to(i32)
    new_base = base_r + adv
    dead = sr < new_base                 # [W]
    # straggler fence: any view not done with a dying slot must be
    # state-transferred before it acts again
    lost = (dead[None, :] & ~view_done).any(1)                # [N]

    fresh_com = com & ~com_before        # first-commit events
    vs = torch.arange(n, device=dev)
    dropped = sum((d.sum() for d in drops if d is not None),
                  torch.zeros((), dtype=torch.int64, device=dev))
    parts = [pre_round.to(i32), accepted.to(i32),
             fresh_com[vs, :, vs].reshape(-1).to(i32), dead.to(i32),
             dropped.to(i32).reshape(1)]
    if collect_logs:
        parts += [transferred.to(i32), donor.to(i32).reshape(1),
                  fresh_com.reshape(-1).to(i32),
                  cstate["commit_seq"].reshape(-1).clone()]

    # recycle: dag.recycle, tusk.recycle_commit, the round masks
    recycle_dag_plain(cfg, dag_state, sr, new_base)
    recycle_commit_plain(cfg, cstate, csr, new_base)
    buffer_filled[dead] = False
    prosp_applied[:, dead] = False
    stable_applied[:, dead] = False
    if collect_logs:
        parts.append(torch.where(dead, sr + w, sr).to(i32))
    return lost, dead, torch.cat(parts)


def recycle_dag_plain(cfg, dag_state, sr, new_base) -> None:
    """``dag.recycle`` in place: clear the DAG rows of the slots whose
    round ``sr`` (the slot rounds before the recycle) fell below
    ``new_base``, hand each to round ``sr + W`` and set ``base_round``."""
    dead = sr < new_base
    for f in _DAG_CLEAR:
        if f in ("block_seen", "cert_seen"):  # [N, W, N]
            dag_state[f][:, dead] = False
        else:                                 # [W, ...]
            dag_state[f][dead] = False
    dag_state["slot_round"].copy_(torch.where(dead, sr + cfg.num_rounds, sr))
    dag_state["base_round"].copy_(new_base)


def recycle_commit_plain(cfg, cstate, sr, new_base) -> None:
    """``tusk.recycle_commit`` in place: clear the commit rows of the slots
    whose round ``sr`` (before the recycle) fell below ``new_base`` and
    hand each to round ``sr + W``. The commit state's ``slot_round`` may
    be the DAG's tensor: both recycles write it from ``sr``."""
    dead = sr < new_base
    cstate["committed"][:, dead] = False
    cstate["commit_seq"][:, dead] = -1
    cstate["slot_round"].copy_(torch.where(dead, sr + cfg.num_rounds, sr))


def gc_clear_ring_plain(cfg, ops_buffer, dead) -> None:
    """Plain PyTorch version: zero every ring field's rows at the dead
    slots, in place."""
    for x in ops_buffer.values():
        x[dead] = 0


def gc_round_plain(cfg, dag_state, cstate, com_before, prosp_applied,
                   stable_applied, buffer_filled, pre_round, accepted,
                   transferred, donor, drops, collect_logs: bool,
                   ops_buffer):
    """The plain versions of one ``gc_frontier`` call: the frontier
    (``gc_frontier_plain``), then the clear of the ring's dead slots' rows
    (``gc_clear_ring_plain``)."""
    lost, dead, packed = gc_frontier_plain(
        cfg, dag_state, cstate, com_before, prosp_applied, stable_applied,
        buffer_filled, pre_round, accepted, transferred, donor, drops,
        collect_logs)
    gc_clear_ring_plain(cfg, ops_buffer, dead)
    return lost, dead, packed


_ptr, _int = ctypes.c_void_p, ctypes.c_int
_TABLE = ctypes.POINTER(ctypes.c_longlong)
_GC = build.LeanLaunch("gc_frontier", "gc_frontier_launch",
                       [_ptr, _TABLE] + [_int] * 7)
# the kernel's Gc pointers, refilled by each call
_POINTERS = (ctypes.c_void_p * 28)()
# (N, W) -> the operands' shapes
_SHAPES: dict = {}


def _shapes(n: int, w: int) -> tuple:
    held = _SHAPES.get((n, w))
    if held is None:
        held = _SHAPES[(n, w)] = ((w, n, n), (w, n), (n, w, n), (n,), (w,),
                                  ())
    return held


def gc_frontier(cfg, dag_state, cstate, com_before, prosp_applied,
                stable_applied, buffer_filled, pre_round, accepted,
                transferred, donor, drops, collect_logs: bool,
                ops_buffer):
    """The GC of one round: ``(lost bool[N], dead bool[W], packed
    int32[P])``, with the recycle in place and the dead slots' rows of
    ``ops_buffer`` (the ring, int32 ``[W, N, B, ...]`` fields) zeroed.
    ``dag_state``, ``cstate``: the DAG and commit state after this
    round's commit; ``com_before``: the committed masks before it;
    ``pre_round`` int32[N] and ``accepted`` bool[N] from the submit;
    ``transferred`` bool[N] and ``donor`` int32[] from the state transfer;
    ``drops``: the two delta applies' dropped counts (int32[V] each, or
    None). On the card the outputs are views of one buffer."""
    n, w = cfg.num_nodes, cfg.num_rounds
    bl, i32 = torch.bool, torch.int32
    wnn, wn, nwn, vec_n, vec_w, scalar = _shapes(n, w)
    drop_p, drop_s = drops
    ring = ops_buffer.items()
    dev = operands.lean_placement("gc_frontier", [
        ("edges", dag_state["edges"], bl, wnn),
        ("block_exists", dag_state["block_exists"], bl, wn),
        ("block_seen", dag_state["block_seen"], bl, nwn),
        ("acks", dag_state["acks"], bl, wnn),
        ("cert_exists", dag_state["cert_exists"], bl, wn),
        ("cert_seen", dag_state["cert_seen"], bl, nwn),
        ("node_round", dag_state["node_round"], i32, vec_n),
        ("slot_round", dag_state["slot_round"], i32, vec_w),
        ("base_round", dag_state["base_round"], i32, scalar),
        ("committed", cstate["committed"], bl, nwn),
        ("commit_seq", cstate["commit_seq"], i32, nwn),
        ("last_wave", cstate["last_wave"], i32, vec_n),
        ("eval_wave", cstate["eval_wave"], i32, vec_n),
        ("commit.slot_round", cstate["slot_round"], i32, vec_w),
        ("com_before", com_before, bl, nwn),
        ("prosp_applied", prosp_applied, bl, nwn),
        ("stable_applied", stable_applied, bl, nwn),
        ("buffer_filled", buffer_filled, bl, wn),
        ("pre_round", pre_round, i32, vec_n), ("accepted", accepted, bl, vec_n),
        ("transferred", transferred, bl, vec_n), ("donor", donor, i32, scalar),
        ("drop_p", drop_p, i32, None if drop_p is None else drop_p.shape),
        ("drop_s", drop_s, i32, None if drop_s is None else drop_s.shape),
        *((f"ops_buffer.{f}", x, i32, (w, n) + x.shape[2:])
          for f, x in ring)])
    if dev is None:
        return gc_round_plain(cfg, dag_state, cstate, com_before,
                              prosp_applied, stable_applied, buffer_filled,
                              pre_round, accepted, transferred, donor, drops,
                              collect_logs, ops_buffer)
    if n > operands.MAX_NODES:
        operands.check_fits("gc_frontier", n, 0)
    if w > MAX_ROUNDS:
        raise ValueError(f"gc_frontier: window {w}, at most {MAX_ROUNDS} on "
                         f"the card")
    if len(ring) > MAX_FIELDS:
        raise ValueError(f"gc_frontier: {len(ring)} ring fields, at most "
                         f"{MAX_FIELDS}")
    # one buffer: the pack, two control words (the dead masks), lost, dead
    p = pack_size(cfg, collect_logs)
    ctrl_at = operands.int32s(p)
    lost_at = 4 * (ctrl_at + 4)
    buf = torch.empty(ctrl_at + 4 + operands.int32s(
        -(-(operands.int32s(n) * 4 + w) // 4)), dtype=i32, device=dev)
    flags = buf.view(bl)
    lost = flags[lost_at:lost_at + n]
    dead_at = lost_at + 16 * -(-n // 16)
    dead = flags[dead_at:dead_at + w]
    base = buf.data_ptr()
    ptrs = _POINTERS
    ptrs[:] = (dag_state["edges"].data_ptr(),
               dag_state["block_exists"].data_ptr(),
               dag_state["block_seen"].data_ptr(), dag_state["acks"].data_ptr(),
               dag_state["cert_exists"].data_ptr(),
               dag_state["cert_seen"].data_ptr(),
               dag_state["node_round"].data_ptr(),
               dag_state["slot_round"].data_ptr(),
               dag_state["base_round"].data_ptr(),
               cstate["committed"].data_ptr(), cstate["commit_seq"].data_ptr(),
               cstate["last_wave"].data_ptr(), cstate["eval_wave"].data_ptr(),
               cstate["slot_round"].data_ptr(), com_before.data_ptr(),
               prosp_applied.data_ptr(), stable_applied.data_ptr(),
               buffer_filled.data_ptr(), pre_round.data_ptr(),
               accepted.data_ptr(), transferred.data_ptr(), donor.data_ptr(),
               None if drop_p is None else drop_p.data_ptr(),
               None if drop_s is None else drop_s.data_ptr(),
               base + lost_at, base + dead_at, base, base + 4 * ctrl_at)
    _GC(dev, ptrs, operands.ring_table(ops_buffer), len(ring),
        0 if drop_p is None else drop_p.numel(),
        0 if drop_s is None else drop_s.numel(), n, w, cfg.quorum,
        int(collect_logs))
    gc_frontier.launches += 1
    return lost, dead, buf[:p]


gc_frontier.launches = 0

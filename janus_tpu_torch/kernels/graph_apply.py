"""``graph_apply``: the 2P2P Graph's sequential apply of vertex and edge
ops, per view, in place; ``graph_capture``: its capture mode; and
``tpset_apply`` / ``tpset_capture``, the same walk over the 2P-Set, a
vertex block with no edge block (kernel source: csrc/graph_apply.cu).

Replaces the ``lax.scan`` of janus_tpu/models/graph.py ``_apply_ops_impl``
(vmapped over the views) with its gates ``_op_gates`` and
janus_tpu/ops/setops.py ``row_upsert``, uncaptured and captured (an ``ok``
flag per op), and, as ``graph_capture``, the sequential capture of
janus_tpu/models/base.py ``capture_and_apply`` with
janus_tpu/models/graph.py ``prepare_ops``. Ops apply in lane order, each
to the row of its key (gathered by JAX's gather rule, written back by its
scatter rule, so an op whose key is out of range changes nothing but may
count a drop). A lane's gate (``op_gates``) is read from its row before
the lane applies: ``rv`` needs a live vertex with no live incident edge,
``ae`` both endpoints live, ``re`` a live edge, any other code passes.
Uncaptured the gate is that; captured it is the op's ``ok``; the capture
mode records it as the lane's ``ok`` and applies as captured.

- av (a0=v): an upsert of v with a false tombstone, ungated;
- rv (a0=v), gated: uncaptured, every slot holding v is tombstoned;
  captured, an upsert of a sticky tombstone (inserted if absent);
- ae (a0=src, a1=dst), gated: an upsert of the edge with a false
  tombstone;
- re (a0=src, a1=dst), gated: as rv, on the edge block;
- an enabled upsert of an absent key into a full block counts one drop.

The 2P-Set (janus_tpu/models/tpset.py ``_apply_ops_impl`` and
``prepare_ops``) is this walk with no edge block: its add is av, its
remove rv, whose gate is then the elem's presence; only codes 1 and 2 are
live lanes there. Its state's fields (``elem``, ``removed``, ``valid``)
stand in for the vertex leaves.

The kernel groups the live lanes (codes 1-4, or 1-2 for the 2P-Set) by
(view, row) first, as 16-byte records of their op fields in a bucket of
32 a group, then walks each group with one warp, the row in registers (a
group of more than 32 lanes from the op fields themselves). One call is
two CUDA launches (and the zeroing of the groups' counts) and adds one to
its wrapper's count. The kernel holds a row's blocks in registers, so it
takes CV and CE (the 2P-Set's C) up to 256 slots. The wrappers launch the
kernel for CUDA tensors (or raise) and run the plain versions only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.kernels import build, operands
from janus_tpu_torch.kernels.lane_buckets import row_waves
from janus_tpu_torch.kernels.tp_rows import (
    GRAPH_DTYPES, GRAPH_FIELDS, TP_FIELDS, VERTEX_LEAVES, edge_view, graph_of,
    vertex_view)
from janus_tpu_torch.models.base import gather_index, scatter_index
from janus_tpu_torch.ops.setops import row_upsert

OP_ADD_VERTEX = 1
OP_REMOVE_VERTEX = 2
OP_ADD_EDGE = 3
OP_REMOVE_EDGE = 4
# the 2P-Set's ops are the vertex ops
OP_ADD, OP_REMOVE = OP_ADD_VERTEX, OP_REMOVE_VERTEX
# the op fields the apply reads, in the C entry points' order
OP_FIELDS = ("op", "key", "a0", "a1")
TP_OP_FIELDS = ("op", "key", "a0")
# the widest block a row may have (csrc/graph_apply.cu: a warp's registers
# hold the row), and the records a group's bucket holds (GROUP_RECORDS)
MAX_SLOTS = 256
GROUP_RECORDS = 32


def op_gates(rows, op, a0, a1) -> torch.Tensor:
    """The precondition gates against given rows (janus_tpu/models/graph.py
    ``_op_gates``): bool with the op fields' shape; ``rows`` the Graph's
    leaves ``[..., CV]`` / ``[..., CE]`` gathered for each op, or its
    vertex leaves alone (the 2P-Set: rv's gate is then presence, and
    ``a1`` is not read)."""
    v_live = rows["v_valid"] & ~rows["v_removed"]
    x = a0[..., None]
    has_x = (v_live & (rows["v"] == x)).any(-1)
    if "src" not in rows:
        return torch.where(op == OP_REMOVE_VERTEX, has_x, True)
    e_live = rows["e_valid"] & ~rows["e_removed"]
    y = a1[..., None]
    has_y = (v_live & (rows["v"] == y)).any(-1)
    incident = (e_live & ((rows["src"] == x) | (rows["dst"] == x))).any(-1)
    e_hit = rows["e_valid"] & (rows["src"] == x) & (rows["dst"] == y)
    re_ok = (e_hit & ~rows["e_removed"]).any(-1)
    return torch.where(
        op == OP_REMOVE_VERTEX, has_x & ~incident,
        torch.where(op == OP_ADD_EDGE, has_x & has_y,
                    torch.where(op == OP_REMOVE_EDGE, re_ok, True)))


def _keep(old, new):
    return {"removed": old["removed"]}


def _tomb(old, new):
    return {"removed": torch.ones_like(old["removed"])}


def _walk_plain(state, ops, ok_out=None) -> torch.Tensor:
    """The JAX scan in PyTorch, in place, the live lanes in waves over
    distinct rows (``kernels.lane_buckets.row_waves``), each row's lanes in
    lane order. ``ok_out`` (int32 ``[V, B, 1]``, ones) receives each live
    lane's gate and makes the lanes captured by it. ``state`` holds the
    vertex leaves alone for the 2P-Set (no edge ops are live then).
    Returns the drops per view."""
    V, K, _ = state["v"].shape
    dev = state["v"].device
    edges = "src" in state
    fields = GRAPH_FIELDS if edges else VERTEX_LEAVES
    gi = gather_index(ops["key"], K)
    wi, wok = scatter_index(ops["key"], K)
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    last = OP_REMOVE_EDGE if edges else OP_REMOVE_VERTEX
    live = (ops["op"] >= OP_ADD_VERTEX) & (ops["op"] <= last)
    captured = "ok" in ops or ok_out is not None
    for v, b in row_waves(live, gi, K):
        op, x = ops["op"][v, b], ops["a0"][v, b]
        y = ops["a1"][v, b] if edges else None
        row = {f: state[f][v, gi[v, b]] for f in fields}
        gate = op_gates(row, op, x, y)
        if ok_out is not None:
            ok_out[v, b, 0] = gate.to(torch.int32)
        elif "ok" in ops:
            gate = ops["ok"][v, b, 0] != 0
        stats = {"slots_dropped": torch.zeros_like(x)}
        false = torch.zeros_like(gate)
        vrow = vertex_view(row)
        v_done = row_upsert(vrow, ("elem",), (x,), {"removed": false}, _keep,
                            enabled=op == OP_ADD_VERTEX, stats=stats)
        rv_ok = (op == OP_REMOVE_VERTEX) & gate
        if captured:
            v_done = row_upsert(v_done, ("elem",), (x,),
                                {"removed": ~false}, _tomb, enabled=rv_ok,
                                stats=stats)
        else:
            hit = vrow["valid"] & (vrow["elem"] == x[:, None])
            v_done["removed"] = v_done["removed"] | (hit & rv_ok[:, None])
        if edges:
            e_done = _edge_step(edge_view(row), op, x, y, gate, captured,
                                stats)
            out = graph_of(v_done, e_done)
        else:
            out = _vertices(v_done)
        dropped.index_add_(0, v, stats["slots_dropped"])
        ok = wok[v, b]
        for f in fields:
            state[f][v[ok], wi[v, b][ok]] = out[f][ok]
    return dropped


def _edge_step(erow, op, x, y, gate, captured, stats):
    """The edge block's half of one wave: ae's upsert and re."""
    false = torch.zeros_like(gate)
    e_done = row_upsert(erow, ("src", "dst"), (x, y), {"removed": false},
                        _keep, enabled=(op == OP_ADD_EDGE) & gate,
                        stats=stats)
    re_ok = (op == OP_REMOVE_EDGE) & gate
    if captured:
        return row_upsert(e_done, ("src", "dst"), (x, y),
                          {"removed": ~false}, _tomb, enabled=re_ok,
                          stats=stats)
    hit = (erow["valid"] & (erow["src"] == x[:, None])
           & (erow["dst"] == y[:, None]))
    e_done["removed"] = e_done["removed"] | (hit & re_ok[:, None])
    return e_done


def _vertices(state):
    """A 2P-Set's state under the Graph's vertex leaf names, sharing
    storage."""
    return dict(zip(VERTEX_LEAVES, (state[f] for f in TP_FIELDS)))


def graph_apply_plain(state, ops) -> torch.Tensor:
    """Plain PyTorch version of ``graph_apply``."""
    return _walk_plain(state, ops)


def graph_capture_plain(state, ops):
    """Plain PyTorch version of ``graph_capture``: returns ``(ok int32[V,
    B, 1], dropped int32[V])``."""
    V, B = ops["op"].shape
    ok = torch.ones((V, B, 1), dtype=torch.int32, device=ops["op"].device)
    fields = OP_FIELDS if "src" in state else TP_OP_FIELDS
    dropped = _walk_plain(state, {f: ops[f] for f in fields}, ok)
    return ok, dropped


def tpset_apply_plain(state, ops) -> torch.Tensor:
    """Plain PyTorch version of ``tpset_apply``."""
    return _walk_plain(_vertices(state), ops)


def tpset_capture_plain(state, ops):
    """Plain PyTorch version of ``tpset_capture``."""
    return graph_capture_plain(_vertices(state), ops)


def _lib():
    lib = build.load("graph_apply")
    if lib.graph_apply_launch.argtypes is None:
        ptr, arr, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.c_int
        lib.graph_apply_launch.argtypes = [arr, arr, ptr, arr, i32, i32, i32,
                                           i32, i32, ptr]
        lib.graph_apply_launch.restype = ctypes.c_int
        lib.graph_capture_launch.argtypes = [arr, arr, ptr, ptr, arr, i32,
                                             i32, i32, i32, i32, ptr]
        lib.graph_capture_launch.restype = ctypes.c_int
        lib.tpset_apply_launch.argtypes = [arr, arr, ptr, arr, i32, i32, i32,
                                           i32, ptr]
        lib.tpset_apply_launch.restype = ctypes.c_int
        lib.tpset_capture_launch.argtypes = [arr, arr, ptr, ptr, arr, i32,
                                             i32, i32, i32, ptr]
        lib.tpset_capture_launch.restype = ctypes.c_int
    return lib


def walk_occupancy(edges: bool, cv: int, ce: int):
    """``(blocks, threads)``: the walk's blocks resident on one SM of the
    current card (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) for
    the uncaptured apply of rows of ``cv`` vertex and ``ce`` edge slots
    (the 2P-Set's C = ``cv`` without edges), and its threads a block."""
    i32, out = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn = _lib().graph_walk_occupancy
    fn.argtypes, fn.restype = [i32, i32, i32, out, out], i32
    blocks, threads = i32(0), i32(0)
    rc = fn(int(edges), cv, ce, ctypes.byref(blocks), ctypes.byref(threads))
    build.check_launch("walk_occupancy", rc)
    return blocks.value, threads.value


def _launch(name, wrapper, state, ops, ok_out):
    """Check the operands, then one launch of the walk (the capture mode
    when ``ok_out`` is given; the 2P-Set's entry points when ``state``
    holds the vertex leaves alone). Returns the drops per view, or None
    when the tensors lie on the CPU."""
    if state["v"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError(f"{name}: state must be [V, K, C] and op fields "
                         "[V, B]")
    edges = "src" in state
    fields = GRAPH_FIELDS if edges else VERTEX_LEAVES
    op_fields = OP_FIELDS if edges else TP_OP_FIELDS
    V, K, CV = state["v"].shape
    CE = state["src"].shape[-1] if edges else 0
    B = ops["op"].shape[1]
    ok = ops.get("ok") if ok_out is None else None
    dev = operands.placement(name, [
        *[(f"state.{f}", state[f], GRAPH_DTYPES[f],
           (V, K, CV if f.startswith("v") else CE)) for f in fields],
        *[(f"op field {f!r}", ops[f], torch.int32, (V, B)) for f in op_fields],
        ("op field 'ok'", ok, torch.int32, (V, B, 1))])
    if dev is None:
        return None
    if CV > MAX_SLOTS or CE > MAX_SLOTS:
        raise ValueError(f"{name}: rows of {CV} + {CE} slots, the kernel "
                         f"takes blocks of at most {MAX_SLOTS}")
    if V * K >= 1 << 31 or V > 65535:
        raise ValueError(f"{name}: {V} views x {K} rows, the kernel takes "
                         f"at most 65,535 views and fewer than 2^31 rows")
    if (K == 0 or CV + CE == 0) and V * B > 0:
        raise ValueError(f"{name}: no slot rows to gather from")
    dropped = torch.zeros((V,), dtype=torch.int32, device=dev)
    if V * B == 0:
        return dropped
    # each group's live lanes, and its bucket of records (16 bytes a lane)
    scratch = (torch.zeros((V * K,), dtype=torch.int32, device=dev),
               torch.empty((V * K, GROUP_RECORDS, 4), dtype=torch.int32,
                           device=dev))
    st = (ctypes.c_void_p * len(fields))(*(state[f].data_ptr()
                                           for f in fields))
    op = (ctypes.c_void_p * (len(op_fields) + 1))(
        *(ops[f].data_ptr() for f in op_fields),
        None if ok is None else ok.data_ptr())
    sc = (ctypes.c_void_p * 2)(*(t.data_ptr() for t in scratch))
    lib = _lib()
    geo = (V, K, CV, CE, B) if edges else (V, K, CV, B)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ok_out is None:
            entry = lib.graph_apply_launch if edges else lib.tpset_apply_launch
            rc = entry(st, op, dropped.data_ptr(), sc, *geo, stream)
        else:
            entry = (lib.graph_capture_launch if edges
                     else lib.tpset_capture_launch)
            rc = entry(st, op, ok_out.data_ptr(), dropped.data_ptr(), sc,
                       *geo, stream)
    build.check_launch(name, rc)
    wrapper.launches += 1
    return dropped


def _capture(name, wrapper, state, ops):
    if state["v"].dim() != 3 or ops["op"].dim() != 2:
        raise ValueError(f"{name}: state must be [V, K, C] and op fields "
                         "[V, B]")
    V, B = ops["op"].shape
    ok = torch.ones((V, B, 1), dtype=torch.int32, device=ops["op"].device)
    fields = OP_FIELDS if "src" in state else TP_OP_FIELDS
    dropped = _launch(name, wrapper, state, {f: ops[f] for f in fields}, ok)
    if dropped is None:
        return graph_capture_plain(state, ops)
    return ok, dropped


def graph_apply(state, ops) -> torch.Tensor:
    """Apply op lanes in order to every view's rows, in place. ``state``:
    the Graph's seven leaves (``tp_rows.GRAPH_FIELDS``), ``[V, K, CV]``
    and ``[V, K, CE]``; op fields int32 ``[V, B]``, with ``ok`` int32
    ``[V, B, 1]`` for captured ops. Returns the drop count per view, int32
    ``[V]``."""
    dropped = _launch("graph_apply", graph_apply, state, ops, None)
    return graph_apply_plain(state, ops) if dropped is None else dropped


graph_apply.launches = 0


def graph_capture(state, ops):
    """Capture and apply uncaptured op lanes in order, in place: each live
    lane's ``ok`` is its gate against the row the earlier lanes left (1
    for every other lane), and the lane applies as captured. ``state`` as
    for ``graph_apply``; op fields int32 ``[V, B]`` (an ``ok`` field is
    ignored). Returns ``(ok int32[V, B, 1], dropped int32[V])``."""
    return _capture("graph_capture", graph_capture, state, ops)


graph_capture.launches = 0


def tpset_apply(state, ops) -> torch.Tensor:
    """``graph_apply`` for the 2P-Set: ``state`` its three slot fields
    ``[V, K, C]`` (``tp_rows.TP_FIELDS``); op fields ``op``, ``key``,
    ``a0`` int32 ``[V, B]``, with ``ok`` int32 ``[V, B, 1]`` for captured
    ops. An add inserts an absent elem (a present one keeps its
    tombstone); an uncaptured remove tombstones a present elem, a captured
    one upserts a sticky tombstone where ``ok`` is set. Returns the drop
    count per view, int32 ``[V]``."""
    dropped = _launch("tpset_apply", tpset_apply, _vertices(state), ops, None)
    return tpset_apply_plain(state, ops) if dropped is None else dropped


tpset_apply.launches = 0


def tpset_capture(state, ops):
    """``graph_capture`` for the 2P-Set: each remove's ``ok`` is its
    elem's presence in the row the earlier lanes left (1 for every other
    lane). Returns ``(ok int32[V, B, 1], dropped int32[V])``."""
    return _capture("tpset_capture", tpset_capture, _vertices(state), ops)


tpset_capture.launches = 0

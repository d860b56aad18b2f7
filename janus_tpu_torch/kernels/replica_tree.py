"""The converge's halving tree over the leading replica axis of a state,
driven through a type's join wrapper: janus_tpu/runtime/store.py
``join_all`` (overlapping halves) for the full converge and its
row-list form for ``converge_delta``. The OR-Set's, RGA's, LWW-Set's and
the two tombstone layouts' instantiations of csrc/slot_union.cu and the
MVRegister's csrc/mvr_merge.cu run it; each type names the fields its join
reads. The 2P2P Graph runs it twice a join, once per block, over views of
its leaves under the layouts' field names.
"""
from __future__ import annotations

from typing import Dict

import torch

_SCRATCH: Dict[tuple, dict] = {}


def tree_scratch(fields: tuple, state, half: int) -> dict:
    """The scratch of one level of the tree for these fields, geometry and
    device, made at the first call: per field ``[half, ...]`` with the
    field's trailing shape and dtype (``[half, K, C]`` for a slot field;
    the MVRegister's ``clock`` is ``[half, K, V, W]``). A level reads its
    input scratch before it writes its output, and the levels of one tree
    have distinct sizes, so calls on one stream may share it (the full and
    the row-list tree included)."""
    dev = state["valid"].device
    geo = tuple((f, tuple(state[f].shape[1:]), state[f].dtype)
                for f in fields)
    key = (dev, half, geo)
    if key not in _SCRATCH:
        _SCRATCH[key] = {f: torch.empty((half,) + shape, dtype=dt, device=dev)
                         for f, shape, dt in geo}
    return _SCRATCH[key]


def join_tree(fields: tuple, union_fn, state) -> None:
    """Set every row of the leading replica axis of ``state``'s ``fields``
    to the join of all rows, in place: the halving tree of
    janus_tpu/runtime/store.py ``join_all`` (the middle row joins both
    halves when the count is odd), one ``union_fn`` launch per level into
    ``tree_scratch``, the last level writing its row into all R rows.
    ``union_fn`` is the type's join wrapper (``slot_union``,
    ``rga_union``, ``lww_union``, ``tp_union``, ``edge_union``,
    ``mvr_merge``)."""
    cap = state["valid"].shape[-1]
    cur = {f: state[f] for f in fields}
    n = state["valid"].shape[0]
    while n > 2:
        half = (n + 1) // 2
        nxt = tree_scratch(fields, state, half)
        union_fn({f: x[:half] for f, x in cur.items()},
                 {f: x[n - half:n] for f, x in cur.items()}, cap,
                 out={f: x.unsqueeze(0) for f, x in nxt.items()})
        cur, n = nxt, half
    if n == 2:
        union_fn({f: x[:1] for f, x in cur.items()},
                 {f: x[1:2] for f, x in cur.items()}, cap,
                 out={f: state[f].unsqueeze(1) for f in fields})


def join_tree_rows(fields: tuple, union_rows_fn, state, rows,
                   n_rows) -> None:
    """``join_tree`` over key rows ``rows[:n_rows]`` only, in place, one
    ``union_rows_fn`` launch per level (the type's row-list wrapper):
    level 1 reads the listed rows from the state, the middle levels work
    in ``tree_scratch`` (only the listed rows of it are written and read),
    and the last writes each joined row into all R replicas at its key.
    Leaves outside ``fields`` are never indexed."""
    cur = {f: state[f] for f in fields}
    listed = True
    n = state["valid"].shape[0]
    while n > 2:
        half = (n + 1) // 2
        nxt = tree_scratch(fields, state, half)
        union_rows_fn({f: x[:half] for f, x in cur.items()},
                      {f: x[n - half:n] for f, x in cur.items()},
                      nxt, rows, n_rows, gather=listed)
        cur, listed, n = nxt, False, half
    if n == 2:
        union_rows_fn({f: x[:1] for f, x in cur.items()},
                      {f: x[1:2] for f, x in cur.items()},
                      {f: state[f] for f in fields}, rows, n_rows,
                      gather=listed, scatter=True)

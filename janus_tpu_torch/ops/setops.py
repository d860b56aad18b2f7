"""Fixed-capacity slot-set tensors and their sorted-union join
(counterpart: janus_tpu/ops/setops.py).

A set lives in a *slot tensor*: ``[..., C]`` tensors of int32 key fields
plus payload fields, with a bool ``valid`` mask. Union is

    concat -> lexicographic stable sort on the key fields -> fold adjacent
    duplicates with a payload combine -> stable compaction sort.

Everything batches over arbitrary leading axes (replicas, keys).
``slot_union`` here is the plain PyTorch version for any key fields and
combine; the OR-Set's join runs through the ``slot_union`` hand kernel
(``janus_tpu_torch.kernels.slot_union``), whose plain version calls it.

Invariants
----------
- Within one slot set, each valid slot has a unique key tuple (so after
  concatenating two sets a key appears at most twice, making the
  single-neighbour duplicate fold exact).
- Key fields are int32 and < SENTINEL; invalid slots are canonicalised to
  SENTINEL so they sort to the tail.

torch sorts on one key; every multi-key sort here is ``lex_order``, an
LSD chain of stable single-key sorts, which orders ties beyond the keys
by position exactly as JAX's stable ``lax.sort(num_keys>1)`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.ops.lattice import SENTINEL

Slots = Dict[str, torch.Tensor]  # field -> [..., C]; must contain "valid"


def lex_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation along the last axis that sorts by ``keys[0]``,
    then ``keys[1]``, ..., ties in position order (a stable sort)."""
    idx = None
    for k in reversed(keys):
        if k.dtype == torch.bool:
            k = k.to(torch.int32)
        kk = k if idx is None else k.gather(-1, idx)
        o = torch.sort(kk, dim=-1, stable=True).indices
        idx = o if idx is None else idx.gather(-1, o)
    return idx


def make_slots(capacity: int, fields: Dict[str, torch.dtype],
               batch: Tuple[int, ...] = (), key_fields: Sequence[str] = (),
               device=None) -> Slots:
    """Allocate an empty slot set: all slots invalid, key fields SENTINEL,
    payload fields 0 (the canonical fill ``slot_union`` re-establishes).
    If ``key_fields`` is empty every int32 field is a key."""
    dev = resolve_device(device)
    keys = set(key_fields)
    out: Slots = {"valid": torch.zeros(batch + (capacity,), dtype=torch.bool,
                                       device=dev)}
    for name, dt in fields.items():
        is_key = name in keys if keys else dt == torch.int32
        out[name] = torch.full(batch + (capacity,), SENTINEL if is_key else 0,
                               dtype=dt, device=dev)
    return out


def _canon_keys(s: Slots, key_fields: Sequence[str]):
    return [torch.where(s["valid"], s[f], SENTINEL) for f in key_fields]


def slot_union(a: Slots, b: Slots, key_fields: Sequence[str],
               combine: Callable[[Dict, Dict], Dict],
               capacity: int | None = None):
    """Join two slot sets by key-union; duplicate keys fold payloads.

    ``combine(p, q) -> dict`` merges the payload fields of two slots with
    equal keys. Returns ``(out_slots, overflow)`` where ``overflow[...]``
    (int32) counts kept slots that did not fit in ``capacity``."""
    nk = len(key_fields)
    cap = capacity if capacity is not None else max(
        a[key_fields[0]].shape[-1], b[key_fields[0]].shape[-1])
    payload_fields = [f for f in a if f != "valid" and f not in key_fields]

    cat_keys = [torch.cat([ka, kb], -1) for ka, kb in
                zip(_canon_keys(a, key_fields), _canon_keys(b, key_fields))]
    cat_valid = torch.cat([a["valid"], b["valid"]], -1)
    cat_pay = {f: torch.cat([a[f], b[f]], -1) for f in payload_fields}

    order = lex_order(cat_keys)
    skeys = [k.gather(-1, order) for k in cat_keys]
    svalid = cat_valid.gather(-1, order)
    spay = {f: v.gather(-1, order) for f, v in cat_pay.items()}

    # dup[i]: slot i carries the same key as slot i-1 (both valid)
    same = svalid & torch.roll(svalid, 1, dims=-1)
    for k in skeys:
        same = same & (k == torch.roll(k, 1, dims=-1))
    same[..., :1] = False
    dup = same

    # fold the payload of a duplicate into its predecessor (the kept copy)
    nxt_dup = torch.cat([dup[..., 1:], torch.zeros_like(dup[..., :1])], -1)
    nxt_pay = {f: torch.roll(v, -1, dims=-1) for f, v in spay.items()}
    folded = combine(spay, nxt_pay)
    pay = {f: torch.where(nxt_dup, folded[f], spay[f]) for f in payload_fields}
    keep = svalid & ~dup

    # stable compaction: kept slots to the front, preserving key order
    comp = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices
    out_keys = [torch.where(keep, k, SENTINEL).gather(-1, comp) for k in skeys]
    out_valid = keep.gather(-1, comp)
    out_pays = {f: v.gather(-1, comp) for f, v in pay.items()}

    def fit(arr, fill):
        """Slice or pad the trailing axis to exactly ``cap``."""
        n = arr.shape[-1]
        if n >= cap:
            return arr[..., :cap]
        pad = torch.full(arr.shape[:-1] + (cap - n,), fill, dtype=arr.dtype,
                         device=arr.device)
        return torch.cat([arr, pad], -1)

    # canonical fill: SENTINEL keys and zero payloads in invalid slots
    valid = fit(out_valid, False)
    out: Slots = {"valid": valid}
    for f, arr in zip(key_fields, out_keys):
        out[f] = torch.where(valid, fit(arr, SENTINEL), SENTINEL)
    for f in payload_fields:
        fitted = fit(out_pays[f], 0)
        out[f] = torch.where(valid, fitted, torch.zeros_like(fitted))
    overflow = (keep.sum(-1) - valid.sum(-1)).to(torch.int32)
    return out, overflow


# ---------------------------------------------------------------------------
# Row lookup for op application. A row is a [..., C] slot set; key values
# carry the leading axes of the row (a scalar for one row), so the lookup
# batches over rows as the JAX one does under vmap.
# ---------------------------------------------------------------------------

def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """int32 index of the first True along the last axis (0 if none), as
    JAX's argmax over bool."""
    return torch.argmax(mask.to(torch.int8), dim=-1).to(torch.int32)


def row_find(row: Slots, key_fields: Sequence[str], key_vals):
    """Locate a key in a row -> (found: bool, idx: int32). idx is 0 when
    not found."""
    hit = row["valid"]
    for f, v in zip(key_fields, key_vals):
        hit = hit & (row[f] == torch.as_tensor(v, device=hit.device)[..., None])
    return hit.any(-1), _first_true(hit)



def row_first_free(row: Slots):
    """First invalid slot -> (has_free: bool, idx: int32); idx is 0 when
    the row is full."""
    free = ~row["valid"]
    return free.any(-1), _first_true(free)


def _put(x: torch.Tensor, idx: torch.Tensor, v, do: torch.Tensor):
    """``x`` with ``x[..., idx] = v`` where ``do`` holds (a new tensor;
    ``idx``, ``v`` and ``do`` carry the row's leading axes)."""
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device).expand(do.shape)
    put = x.scatter(-1, idx.long()[..., None], v[..., None])
    return torch.where(do[..., None], put, x)


def _add_drops(stats, dropped: torch.Tensor) -> None:
    """Add an op's drop (bool ``[...]``) into ``stats["slots_dropped"]``."""
    if stats is not None:
        stats["slots_dropped"] = (
            stats.get("slots_dropped", dropped.new_zeros((), dtype=torch.int32))
            + dropped.to(torch.int32))


def row_insert(row: Slots, values: Dict[str, torch.Tensor], enabled=True,
               stats: Dict[str, torch.Tensor] | None = None):
    """Insert a slot into the first free position; drops when the row is
    full. With a ``stats`` dict an enabled insert into a full row adds one
    to ``stats["slots_dropped"]`` (int32 with the row's leading axes).
    Returns the new row (a new dict; the input is not modified)."""
    has_free, idx = row_first_free(row)
    en = torch.as_tensor(enabled, device=idx.device).expand(has_free.shape)
    do = en & has_free
    _add_drops(stats, en & ~has_free)
    out = dict(row)
    for f, v in values.items():
        out[f] = _put(row[f], idx, v, do)
    out["valid"] = _put(row["valid"], idx, True, do)
    return out


def row_upsert(row: Slots, key_fields: Sequence[str], key_vals,
               values: Dict[str, torch.Tensor],
               combine_existing: Callable[[Dict, Dict], Dict], enabled=True,
               stats: Dict[str, torch.Tensor] | None = None):
    """Insert a key, or fold ``values`` into its existing slot (the first
    valid one holding it) by ``combine_existing(old_payload, new_payload)
    -> payload``. With ``stats``, an enabled upsert of an absent key into a
    full row adds one to ``stats["slots_dropped"]`` (folding never drops).
    Key values, values and ``enabled`` carry the row's leading axes.
    Returns the new row."""
    found, idx = row_find(row, key_fields, key_vals)
    en = torch.as_tensor(enabled, device=idx.device).expand(found.shape)
    if stats is not None:
        has_free, _ = row_first_free(row)
        _add_drops(stats, en & ~found & ~has_free)
    old = {f: row[f].gather(-1, idx.long()[..., None])[..., 0]
           for f in row if f != "valid" and f not in key_fields}
    new = combine_existing(old, values)
    fold = en & found
    ins_vals = dict(values)
    ins_vals.update(zip(key_fields, key_vals))
    out = row_insert(row, ins_vals, enabled=en & ~found)
    for f, v in new.items():
        out[f] = _put(out[f], idx, v, fold)
    return out


def pack_pair(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """A two-part int32 key as one int64, equal iff both parts are."""
    return (k1.to(torch.int64) << 32) | (k2.to(torch.int64) & 0xFFFFFFFF)


def mark_members(a_keys: Sequence[torch.Tensor], b_keys: Sequence[torch.Tensor],
                 b_valid: torch.Tensor) -> torch.Tensor:
    """bool, A's shape: does A record i's two-part int32 key equal some B
    key whose ``b_valid`` is set (counterpart: janus_tpu/ops/setops.py
    ``mark_members``, a sort-merge over M + T records; here the valid B
    keys are sorted once and every A key is searched among them). The
    membership is exact: a masked B key matches nothing, duplicates and
    keys at SENTINEL are ordinary keys. Plain PyTorch; the
    ``mark_members`` hand kernel (``janus_tpu_torch.kernels``) runs it for
    CPU tensors."""
    a = pack_pair(*a_keys)
    b = pack_pair(*b_keys)[b_valid]
    if a.numel() == 0 or b.numel() == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    sb = torch.sort(b).values
    pos = torch.searchsorted(sb, a.reshape(-1)).clamp(max=sb.numel() - 1)
    return (sb[pos] == a.reshape(-1)).reshape(a.shape)

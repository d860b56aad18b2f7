"""Parity of the port's slot sets (janus_tpu_torch, on the CPU) with the JAX
package's ``ops/setops.py``: ``make_slots``, ``slot_union`` (through the
``slot_union`` wrapper, which runs its plain version on the CPU, and the
generic function), ``row_find``, ``row_first_free``, ``row_insert`` and
``row_upsert``. Every comparison is bit-equal
(tolerance exactly 0) on seeded numpy inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import orset as jax_orset
from janus_tpu.ops import setops as jax_setops

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.kernels.orset_rows import KEY_FIELDS, fold_duplicate
from janus_tpu_torch.ops import setops

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

SLOT_FIELDS = ("valid", "tag_rep", "tag_ctr", "elem", "removed")


def _jax(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return convert.tree_from_numpy(tree, "cpu")


def _assert_equal(got, want, where=""):
    got = convert.tree_to_numpy(got)
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


def test_make_slots_matches_jax():
    fields = {"tag_rep": (jnp.int32, torch.int32), "elem": (jnp.int32, torch.int32),
              "removed": (jnp.bool_, torch.bool)}
    want = jax_setops.make_slots(5, {f: d[0] for f, d in fields.items()},
                                 batch=(3,), key_fields=("tag_rep",))
    got = setops.make_slots(5, {f: d[1] for f, d in fields.items()},
                            batch=(3,), key_fields=("tag_rep",), device="cpu")
    _assert_equal(got, want)
    # no key fields named: every int32 field is a key
    want = jax_setops.make_slots(4, {"a": jnp.int32, "b": jnp.bool_})
    got = setops.make_slots(4, {"a": torch.int32, "b": torch.bool},
                            device="cpu")
    _assert_equal(got, want)


@pytest.mark.parametrize("lead,ca,cb,cap,canonical", [
    ((3, 5), 6, 6, 6, False),     # non-canonical rows, junk in invalid slots
    ((7,), 8, 8, 8, True),        # canonical rows, some full: overflow
    ((2, 4), 5, 3, 4, False),     # unequal widths, cut below both
    ((4,), 3, 2, 8, True),        # padded beyond both widths
])
def test_slot_union_matches_jax(lead, ca, cb, cap, canonical):
    """Random rows, full rows, duplicate tags inside one input (the
    single-neighbour fold), junk payloads in invalid slots."""
    rng = np.random.default_rng(ca * 10 + cb)
    a = workloads.orset_slots(rng, lead, ca, canonical=canonical, dup_rows=0.3)
    b = workloads.orset_slots(rng, lead, cb, canonical=canonical, dup_rows=0.3)
    # a share of b's tags copied from a, so unions meet duplicates
    take = rng.random(lead + (min(ca, cb),)) < 0.4
    for f in ("tag_rep", "tag_ctr", "valid"):
        b[f][..., :min(ca, cb)] = np.where(take, a[f][..., :min(ca, cb)],
                                           b[f][..., :min(ca, cb)])
    want, want_ovf = jax_setops.slot_union(
        _jax(a), _jax(b), jax_orset.KEY_FIELDS, jax_orset._combine, cap)
    got, ovf = kernels.slot_union(_torch(a), _torch(b), cap)
    _assert_equal(got, {f: want[f] for f in SLOT_FIELDS}, "slot_union")
    _assert_equal(ovf, want_ovf, "overflow")
    assert np.asarray(want_ovf).any() or cap > ca or cap > cb
    # the generic function with the same fold, and the in-place form
    got2, ovf2 = setops.slot_union(
        {f: _torch(a)[f] for f in SLOT_FIELDS}, _torch(b), KEY_FIELDS,
        fold_duplicate, cap)
    _assert_equal(got2, want)
    _assert_equal(ovf2, want_ovf)
    out = {f: torch.zeros((2,) + lead + (cap,), dtype=got[f].dtype)
           for f in SLOT_FIELDS}
    kernels.slot_union(_torch(a), _torch(b), cap, out=out)
    for f in SLOT_FIELDS:
        _assert_equal(out[f], np.broadcast_to(np.asarray(want[f]),
                                              (2,) + lead + (cap,)), f)


def test_slot_union_in_place_may_alias_its_input():
    rng = np.random.default_rng(5)
    st = workloads.orset_slots(rng, (2, 3), 4)
    want, _ = jax_setops.slot_union(
        _jax({f: v[:1] for f, v in st.items()}),
        _jax({f: v[1:] for f, v in st.items()}),
        jax_orset.KEY_FIELDS, jax_orset._combine, 4)
    t = _torch(st)
    kernels.slot_union({f: v[:1] for f, v in t.items()},
                       {f: v[1:] for f, v in t.items()}, 4,
                       out={f: v.unsqueeze(1) for f, v in t.items()})
    for f in SLOT_FIELDS:
        _assert_equal(t[f], np.broadcast_to(np.asarray(want[f])[0], (2, 3, 4)), f)


@pytest.mark.parametrize("n,c,seed", [(12, 5, 9), (9, 8, 3), (16, 1, 4)])
def test_row_find_matches_jax(n, c, seed):
    """row_find on present tags, absent tags and invalid-slot junk, over
    non-canonical rows (full ones among them): batched in the port,
    vmapped in JAX."""
    rng = np.random.default_rng(seed)
    rows = workloads.orset_slots(rng, (n,), c, canonical=False, full_rows=0.3)
    pick = rng.integers(0, c, n)
    keys = [np.where(rng.random(n) < 0.6, rows[f][np.arange(n), pick],
                     rng.integers(-2, 20, n)).astype(np.int32)
            for f in ("tag_rep", "tag_ctr")]
    want = jax.vmap(lambda r, a, b: jax_setops.row_find(r, KEY_FIELDS, (a, b)))(
        _jax(rows), *(jnp.asarray(k) for k in keys))
    got = setops.row_find(_torch(rows), KEY_FIELDS,
                          [torch.from_numpy(k) for k in keys])
    assert np.asarray(want[0]).any() and not np.asarray(want[0]).all()
    for g, w in zip(got, want):
        _assert_equal(g, w)


def _fold_max(old, new):
    return {"elem": jnp.maximum(old["elem"], new["elem"]),
            "removed": old["removed"] | new["removed"]}


def _fold_max_torch(old, new):
    return {"elem": torch.maximum(old["elem"], new["elem"]),
            "removed": old["removed"] | new["removed"]}


@pytest.mark.parametrize("n,c,seed,upsert", [
    (12, 5, 7, True), (9, 8, 8, True), (16, 1, 9, True),
    (12, 5, 10, False), (8, 3, 11, False)])
def test_row_insert_and_upsert_match_jax(n, c, seed, upsert):
    """row_upsert (present keys fold, absent keys insert into the first
    free slot, full rows drop) and row_insert, over non-canonical rows with
    junk in invalid slots, enabled and disabled lanes, with the drop count
    of the ``stats`` dict: batched in the port, vmapped in JAX."""
    rng = np.random.default_rng(seed)
    rows = workloads.orset_slots(rng, (n,), c, canonical=False,
                                 full_rows=0.6)
    pick = rng.integers(0, c, n)
    keys = [np.where(rng.random(n) < 0.5, rows[f][np.arange(n), pick],
                     rng.integers(-2, 20, n)).astype(np.int32)
            for f in ("tag_rep", "tag_ctr")]
    vals = {"elem": rng.integers(-3, 9, n).astype(np.int32),
            "removed": rng.random(n) < 0.5}
    en = rng.random(n) < 0.8

    def jax_one(row, k1, k2, elem, removed, e):
        stats = {"slots_dropped": jnp.int32(0)}
        values = {"elem": elem, "removed": removed}
        if upsert:
            out = jax_setops.row_upsert(row, KEY_FIELDS, (k1, k2), values,
                                        _fold_max, enabled=e, stats=stats)
        else:
            out = jax_setops.row_insert(
                row, {**values, "tag_rep": k1, "tag_ctr": k2}, enabled=e,
                stats=stats)
        return out, stats["slots_dropped"]

    want, want_drop = jax.vmap(jax_one)(
        _jax(rows), *(jnp.asarray(k) for k in keys), jnp.asarray(vals["elem"]),
        jnp.asarray(vals["removed"]), jnp.asarray(en))
    stats = {}
    tv = {f: torch.from_numpy(v) for f, v in vals.items()}
    tk = [torch.from_numpy(k) for k in keys]
    if upsert:
        got = setops.row_upsert(_torch(rows), KEY_FIELDS, tk, tv,
                                _fold_max_torch, enabled=torch.from_numpy(en),
                                stats=stats)
    else:
        got = setops.row_insert(_torch(rows),
                                {**tv, "tag_rep": tk[0], "tag_ctr": tk[1]},
                                enabled=torch.from_numpy(en), stats=stats)
    _assert_equal(got, want)
    _assert_equal(stats["slots_dropped"], want_drop, "slots_dropped")
    assert np.asarray(want_drop).any()
    has_free, idx = setops.row_first_free(_torch(rows))
    w_free, w_idx = jax.vmap(jax_setops.row_first_free)(_jax(rows))
    _assert_equal(has_free, w_free)
    _assert_equal(idx, w_idx)

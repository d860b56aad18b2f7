"""Parity of the port's delta anti-entropy (janus_tpu_torch, on the CPU)
with the JAX package: the dirty-row marking and slab selection
(``dirty_rows`` and ``delta_select``, through their wrappers, which run
the plain versions on the CPU), ``converge_delta`` with the row-list
joins of both types, ``make_delta_tick``, and the ``Store``: ``apply``,
``sync``, ``sync_delta``, ``sync_all``, ``fused_tick`` in both modes,
``flush_metrics`` and a store continued from the JAX ``Store``'s arrays.

It mirrors tests/test_delta.py at its size (R=4 replicas, K=32 keys, B=8
ops). Inputs are seeded numpy draws handed to both packages; the hazard
stream puts keys in [-K, 2K). Every comparison is bit-equal (int32 and
bool state, int counts; tolerance exactly 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import orset as jax_orset
from janus_tpu.models import pncounter as jax_pnc
from janus_tpu.obs.metrics import get_registry as jax_registry
from janus_tpu.runtime import engine as jax_engine
from janus_tpu.runtime import store as jax_store

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.models import orset, pncounter
from janus_tpu_torch.obs.metrics import get_registry
from janus_tpu_torch.runtime import engine, store
from janus_tpu_torch.utils.ids import TagMinter

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

R, B, K = 4, 8, 32
SPECS = {"pnc": (jax_pnc.SPEC, pncounter.SPEC),
         "orset": (jax_orset.SPEC, orset.SPEC)}
DIMS = {"pnc": dict(num_keys=K, num_writers=R),
        "orset": dict(num_keys=K, capacity=64, rm_capacity=4)}


def _keys(rng, hazard):
    return rng.integers(-K, 2 * K, (R, B)) if hazard else rng.integers(0, K, (R, B))


def _op_batch(**fields):
    return {f: np.ascontiguousarray(np.broadcast_to(fields.get(f, 0), (R, B)),
                                    np.int32)
            for f in ("op", "key", "a0", "a1", "a2", "writer")}


def _pnc_stream(rng, ticks, hazard=False, noop_frac=0.2):
    out = []
    for _ in range(ticks):
        op = rng.integers(pncounter.OP_INC, pncounter.OP_DEC + 1, (R, B))
        op = np.where(rng.random((R, B)) < noop_frac, 0, op)
        out.append(_op_batch(op=op, key=_keys(rng, hazard),
                             a0=rng.integers(1, 10, (R, B)),
                             writer=np.arange(R)[:, None]))
    return out


def _orset_stream(rng, ticks, minters, hazard=False, noop_frac=0.2):
    out = []
    for _ in range(ticks):
        is_add = rng.random((R, B)) < 0.6
        tags = np.zeros((R, B, 2), np.int32)
        for v in range(R):
            lanes = np.nonzero(is_add[v])[0]
            if lanes.size:
                tags[v, lanes] = minters[v].mint_many(lanes.size)
        op = np.where(is_add, orset.OP_ADD, orset.OP_REMOVE)
        op = np.where(rng.random((R, B)) < noop_frac, 0, op)
        out.append(_op_batch(op=op, key=_keys(rng, hazard),
                             a0=rng.integers(0, 16, (R, B)),
                             a1=tags[..., 0], a2=tags[..., 1]))
    return out


def _streams(seed, ticks=6, hazard=False):
    rng = np.random.default_rng(seed)
    minters = [TagMinter(v) for v in range(R)]
    return {"pnc": _pnc_stream(rng, ticks, hazard),
            "orset": _orset_stream(rng, ticks, minters, hazard)}


def _jnp(tree):
    return {f: jnp.asarray(v) for f, v in tree.items()}


def _torch(tree):
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _init(tc):
    jspec, spec = SPECS[tc]
    return (jax_store.replicated_init(jspec, R, **DIMS[tc]),
            store.replicated_init(spec, R, device="cpu", **DIMS[tc]))


def _assert_equal(got, want, where=""):
    got, want = convert.tree_to_numpy(got), convert.tree_to_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (
        where, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


# jitted per (type, budget) once for the module, as tests/test_delta.py does
_JIT = {}


def _jax_delta_tick(tc, budget):
    if (tc, budget) not in _JIT:
        spec = SPECS[tc][0]

        def tick(s, o):
            st, dirty, _ = jax_store.apply_replica_ops_delta(spec, s, o)
            st, ovf, count = jax_store.converge_delta(spec, st, dirty, budget)
            return st, dirty, ovf, count
        _JIT[(tc, budget)] = jax.jit(tick)
    return _JIT[(tc, budget)]


@pytest.mark.parametrize("tc", ["pnc", "orset"])
@pytest.mark.parametrize("seed,hazard", [(0, False), (1, True)])
@pytest.mark.parametrize("budget", [2, K])
def test_converge_delta_matches_jax(tc, seed, hazard, budget):
    """Six ticks of delta apply + ``converge_delta``: the dirty mask, the
    selection (order cut to D, count, overflow) and the state equal
    JAX's every tick. Budget 2 overflows every tick (the full-converge
    fallback), budget K never does."""
    spec = SPECS[tc][1]
    ref, st = _init(tc)
    overflows = 0
    for t, ops in enumerate(_streams(seed, hazard=hazard)[tc]):
        ref, ref_dirty, ref_ovf, ref_count = _jax_delta_tick(tc, budget)(
            ref, _jnp(ops))
        st, dirty, _ = store.apply_replica_ops_delta(spec, st, _torch(ops))
        _assert_equal(dirty, ref_dirty, f"{tc} dirty, tick {t}")
        union = np.asarray(ref_dirty).any(0)
        sel = kernels.delta_select(dirty.clone(), budget)
        want_idx = np.argsort(~union, kind="stable")[:budget]
        np.testing.assert_array_equal(sel.order[:budget].numpy(), want_idx)
        assert int(sel.n_join) == (K if int(ref_count) > budget else int(ref_count))
        st, ovf, count = store.converge_delta(spec, st, dirty, budget)
        assert bool(ovf) == bool(ref_ovf) and int(count) == int(ref_count)
        _assert_equal(st, ref, f"{tc} state, tick {t}")
        overflows += bool(ovf)
    assert overflows == (6 if budget == 2 else 0)


def test_delta_select_clears_and_accumulates():
    """``clear`` consumes the mask; the running sums add count and
    overflow; ``n_join`` is the count, or K on overflow."""
    rng = np.random.default_rng(5)
    dirty = torch.from_numpy(rng.random((R, K)) < 0.1)
    union = dirty.numpy().any(0)
    acc_c = torch.tensor(7, dtype=torch.int32)
    acc_o = torch.tensor(1, dtype=torch.int32)
    n = int(union.sum())
    for budget, over in ((n, False), (n - 1, True)):
        d = dirty.clone()
        sel = kernels.delta_select(d, budget, clear=True, acc_count=acc_c,
                                   acc_overflow=acc_o)
        assert not d.any()
        assert int(sel.count) == n and bool(sel.overflowed) == over
        assert int(sel.n_join) == (K if over else n)
        np.testing.assert_array_equal(sel.order.numpy(),
                                      np.argsort(~union, kind="stable"))
    assert int(acc_c) == 7 + 2 * n and int(acc_o) == 2


@pytest.mark.parametrize("tc", ["pnc", "orset"])
def test_converge_delta_zero_dirty_is_noop(tc):
    """An all-clean mask joins nothing and leaves the state untouched."""
    jspec, spec = SPECS[tc]
    ref, st = _init(tc)
    ops = _streams(23)[tc][0]
    ref = jax.jit(jax_engine.make_tick(jspec))(ref, _jnp(ops))
    st = store.converge(spec, store.apply_replica_ops(spec, st, _torch(ops)))
    out, ovf, count = store.converge_delta(spec, st, torch.zeros((R, K), dtype=torch.bool), 4)
    assert not bool(ovf) and int(count) == 0
    _assert_equal(out, ref, f"{tc} clean converge_delta")


@pytest.mark.parametrize("tc", ["pnc", "orset"])
def test_make_delta_tick_matches_jax(tc):
    """``engine.make_delta_tick`` against the JAX tick at budget K/2 over
    a hazard stream: state, overflow, count and drops every tick."""
    jspec, spec = SPECS[tc]
    ref, st = _init(tc)
    jtick = jax.jit(jax_engine.make_delta_tick(jspec, K // 2))
    tick = engine.make_delta_tick(spec, K // 2, device="cpu")
    for t, ops in enumerate(_streams(3, hazard=True)[tc]):
        ref, r_ovf, r_count, r_drop = jtick(ref, _jnp(ops))
        st, ovf, count, drop = tick(st, _torch(ops))
        assert (bool(ovf), int(count), int(drop)) == (
            bool(r_ovf), int(r_count), int(r_drop)), t
        _assert_equal(st, ref, f"{tc} make_delta_tick, tick {t}")


def _stores(budget=None, ticks=6, seed=11):
    streams = _streams(seed, ticks)
    batches = [{tc: streams[tc][t] for tc in streams} for t in range(ticks)]
    return (jax_store.Store(R, DIMS, dirty_budget=budget),
            store.Store(R, DIMS, dirty_budget=budget, device="cpu"), batches)


def _apply_all(st, batch, conv):
    for tc, ops in batch.items():
        st.apply(tc, conv(ops))


def test_store_sync_delta_and_sync_match_jax():
    """``apply`` + ``sync_delta`` (budget K/2) and ``apply`` + ``sync``
    against the JAX Store, with the registry's dirty fraction."""
    ref, mine, batches = _stores(K // 2)
    ref_full, mine_full, _ = _stores()
    for t, batch in enumerate(batches):
        for a, b in ((ref, mine), (ref_full, mine_full)):
            _apply_all(a, batch, _jnp)
            _apply_all(b, batch, _torch)
            _assert_equal(b.dirty, a.dirty, f"dirty after apply, tick {t}")
        for tc in DIMS:
            ref.sync_delta(tc)
            mine.sync_delta(tc)
            assert (get_registry().gauge(f"store_{tc}_dirty_fraction").value
                    == jax_registry().gauge(f"store_{tc}_dirty_fraction").value)
            ref_full.sync(tc)
            mine_full.sync(tc)
        for a, b in ((ref, mine), (ref_full, mine_full)):
            _assert_equal(b.states, a.states, f"states, tick {t}")
            _assert_equal(b.dirty, a.dirty, f"dirty after sync, tick {t}")
    _assert_equal(mine.states, mine_full.states, "delta vs full")
    for tc in DIMS:
        q = mine.query(tc, "get" if tc == "pnc" else "live_count")
        _assert_equal(q, ref.query(tc, "get" if tc == "pnc" else "live_count"))


def test_store_sync_all_matches_jax():
    """``apply``, one ``gossip`` exchange per type, then ``sync_all``."""
    ref, mine, batches = _stores()
    for t, batch in enumerate(batches):
        _apply_all(ref, batch, _jnp)
        _apply_all(mine, batch, _torch)
        for tc, distance in (("pnc", 1), ("orset", 2)):
            ref.gossip(tc, distance)
            mine.gossip(tc, distance)
        _assert_equal(mine.states, ref.states, f"gossip, tick {t}")
        ref.sync_all()
        mine.sync_all()
        _assert_equal(mine.states, ref.states, f"sync_all, tick {t}")
        _assert_equal(mine.dirty, ref.dirty, f"dirty, tick {t}")
    assert mine.rounds_to_converge() == ref.rounds_to_converge()


def _counters(reg):
    return {tc: reg.counter(f"store_{tc}_delta_overflow_total").value
            for tc in DIMS}


@pytest.mark.parametrize("budget,delta", [(K, True), (2, True), (K, False)])
def test_store_fused_tick_matches_jax(budget, delta):
    """Four fused two-type ticks against the JAX Store: states every tick,
    one plan build (the JAX Store's one trace), one dispatch per tick, the
    device accumulators, and ``flush_metrics``' dirty fractions and
    overflow counters against the JAX registry's."""
    ticks = 4
    ref, mine, batches = _stores(budget, ticks, seed=17)
    before = (_counters(jax_registry()), _counters(get_registry()))
    for t, batch in enumerate(batches):
        ref.fused_tick({tc: _jnp(o) for tc, o in batch.items()}, delta=delta)
        mine.fused_tick({tc: _torch(o) for tc, o in batch.items()}, delta=delta)
        _assert_equal(mine.states, ref.states, f"fused_tick {t}")
        _assert_equal(mine.dirty, ref.dirty, f"fused_tick {t} dirty")
    assert mine.fused_trace_count == ref.fused_trace_count == 1
    assert mine.fused_dispatch_count == ref.fused_dispatch_count == ticks
    _assert_equal({k: v for k, v in mine._fused_acc.items()},
                  {k: np.asarray(v) for k, v in ref._fused_acc.items()},
                  "accumulators")
    if delta:
        want = ticks if budget == 2 else 0
        assert all(int(mine._fused_acc[f"overflow_{tc}"]) == want for tc in DIMS)
    fracs = mine.flush_metrics()
    assert fracs == ref.flush_metrics()
    assert set(fracs) == (set(DIMS) if delta else set())
    after = (_counters(jax_registry()), _counters(get_registry()))
    for tc in DIMS:
        assert (after[1][tc] - before[1][tc]) == (after[0][tc] - before[0][tc])
        assert (get_registry().gauge(f"store_{tc}_dirty_fraction").value
                == jax_registry().gauge(f"store_{tc}_dirty_fraction").value)


def test_store_loaded_mid_run_continues_like_jax():
    """A port Store loaded from a JAX Store after three applied but not
    yet converged ticks (dirty rows pending) goes on bit-equal to it:
    delta fused ticks, then a sync_delta."""
    ref, mine, batches = _stores(K // 2, ticks=6, seed=29)
    for batch in batches[:3]:
        _apply_all(ref, batch, _jnp)
    convert.load_store(mine, ref.states, ref.dirty)
    _assert_equal(mine.dirty, ref.dirty, "loaded dirty")
    for t, batch in enumerate(batches[3:5]):
        ref.fused_tick({tc: _jnp(o) for tc, o in batch.items()})
        mine.fused_tick({tc: _torch(o) for tc, o in batch.items()})
        _assert_equal(mine.states, ref.states, f"continued tick {t}")
    _apply_all(ref, batches[5], _jnp)
    _apply_all(mine, batches[5], _torch)
    for tc in DIMS:
        ref.sync_delta(tc)
        mine.sync_delta(tc)
    _assert_equal(mine.states, ref.states, "after sync_delta")

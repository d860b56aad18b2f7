"""Parity of the port's wire ingest (``consensus.dag.ingest_batch`` and its
single-message helpers, the ``dag_ingest`` kernel's plain version, on the
CPU) and of ``dag_round``'s split mode with the JAX package.

Inputs are made with numpy from a seed and fed to both. Every comparison
is bit-equal (bool and int32 state; tolerance exactly 0). The port's
ingest updates its state in place, so each call gets a clone.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from janus_tpu.consensus import dag as jax_dag
from janus_tpu.net import splitnode as jax_splitnode
from janus_tpu.obs.metrics import Registry as JaxRegistry

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import dag
from janus_tpu_torch.obs.metrics import Registry, get_registry

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

SHAPES = ((4, 8), (7, 6))


def _assert_state_equal(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = convert.tree_to_numpy(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: {k}")


def _state(rng, n, w, density=0.35):
    """A random DAG state whose blocks and certificates are sparse enough
    that many ingested blocks are fresh."""
    st, _, _ = workloads.consensus_state(rng, n, w)
    for f in ("block_exists", "cert_exists", "edges", "acks"):
        st[f] = st[f] & (rng.random(st[f].shape) < density)
    return st


def _index(rng, n, size):
    """Node ids mostly in range, some in [-N, 0) (JAX counts them from the
    end), some below -N or at N and above (dropped, or clamped by the
    gather)."""
    return np.where(rng.random(size) < 0.8, rng.integers(0, n, size),
                    rng.integers(-n - 3, n + 4, size)).astype(np.int64)


def _batch(rng, n, w, st):
    """Blocks (stale, live and ahead-of-window rounds; duplicate (r, src)
    copies with different edges; out-of-range sources), signatures and
    certificates (out-of-range sources and signers)."""
    live = st["slot_round"]
    m, s, c = (int(x) for x in rng.integers(1, 3 * n, 3))

    def rounds(k):
        pick = rng.random(k)
        return np.where(pick < 0.6, rng.choice(live, k),
                        np.where(pick < 0.8, live.min() - rng.integers(1, w + 3, k),
                                 live.max() + rng.integers(1, w + 3, k)))

    rs, srcs = rounds(m), _index(rng, n, m)
    blocks = [(int(r), int(v), rng.random(n) < 0.5) for r, v in zip(rs, srcs)]
    for i in range(min(3, m)):  # a re-send with other edges, a later copy
        r, v, _ = blocks[i]
        blocks.append((r, v, rng.random(n) < 0.5))
    order = rng.permutation(len(blocks))
    blocks = [blocks[i] for i in order]
    sigs = [(int(r), int(v), int(t)) for r, v, t in
            zip(rounds(s), _index(rng, n, s), _index(rng, n, s))]
    certs = [(int(r), int(v)) for r, v in zip(rounds(c), _index(rng, n, c))]
    return blocks, sigs, certs


def _seen_by(rng, n, case):
    if case == 0:
        return np.zeros(0, np.int32)  # nobody observes
    if case == 1:
        return np.nonzero(rng.random(n) < 0.5)[0].astype(np.int32)
    return _index(rng, n, 3).astype(np.int32)


@pytest.mark.parametrize("n,w", SHAPES)
def test_ingest_batch_matches_jax_on_random_batches(n, w):
    rng = np.random.default_rng(n * 100 + w)
    cfg, jcfg = dag.DagConfig(n, w), jax_dag.DagConfig(n, w)
    fresh_edges = landed = 0
    for i in range(6):
        st = _state(rng, n, w)
        blocks, sigs, certs = _batch(rng, n, w, st)
        seen = _seen_by(rng, n, i % 3)
        ref = jax_dag.ingest_batch(
            jcfg, {k: jnp.asarray(v) for k, v in st.items()}, seen,
            blocks=blocks, sigs=sigs, certs=certs)
        mine = convert.tree_from_numpy(st, "cpu")
        before = {k: v.clone() for k, v in mine.items()}
        out = dag.ingest_batch(cfg, mine, seen, blocks=blocks, sigs=sigs,
                               certs=certs)
        assert out is mine  # in place
        assert mine["slot_round"].data_ptr() == out["slot_round"].data_ptr()
        _assert_state_equal(mine, ref, f"N{n} W{w} batch {i}")
        fresh_edges += int((mine["edges"] & ~before["edges"]).sum())
        landed += int((mine["acks"] & ~before["acks"]).sum())
    assert fresh_edges > 0 and landed > 0  # the batches did land


def test_single_message_helpers_match_jax():
    n, w = 4, 8
    rng = np.random.default_rng(5)
    cfg, jcfg = dag.DagConfig(n, w), jax_dag.DagConfig(n, w)
    st = _state(rng, n, w, density=0.0)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    mine = convert.tree_from_numpy(st, "cpu")
    r = int(st["slot_round"][3])
    edges = rng.random(n) < 0.6
    calls = [
        ("ingest_block", (r, 1, edges, [0, 2])),
        ("ingest_block", (r, 1, ~edges, [3])),  # first write wins
        ("ingest_signature", (r, 1, 2)),
        ("ingest_signature", (r, 1, n + 2)),    # signer out of range
        ("ingest_certificate", (r, 1, [0, 1])),
        ("ingest_certificate", (r + w, 2, [0])),  # ahead of the window
        ("ingest_block", (r - w, 0, edges, [1])),  # stale
    ]
    for name, args in calls:
        js = getattr(jax_dag, name)(jcfg, js, *args)
        getattr(dag, name)(cfg, mine, *args)
        _assert_state_equal(mine, js, f"{name}{args[:2]}")
    assert mine["edges"][3, 1].tolist() == edges.tolist()


def test_node_round_learns_from_out_of_window_block():
    n, w = 4, 8
    cfg, jcfg = dag.DagConfig(n, w), jax_dag.DagConfig(n, w)
    mine, js = dag.init(cfg, "cpu"), jax_dag.init(jcfg)
    blocks = [(w + 5, 2, np.ones(n, bool)), (3, 2, np.ones(n, bool)),
              (2 * w, n + 1, np.ones(n, bool))]
    js = jax_dag.ingest_batch(jcfg, js, [0, 1], blocks=blocks)
    dag.ingest_batch(cfg, mine, [0, 1], blocks=blocks)
    _assert_state_equal(mine, js, "out-of-window")
    assert int(mine["node_round"][2]) == w + 5
    assert not bool(mine["block_exists"][(w + 5) % w, 2])


@pytest.mark.parametrize("extras", [False, True])
def test_payload_write_matches_splitnode_ring_write(extras):
    """The payload rows land at [r % W, src] of every ring field, with
    buffer_filled set, as JAX's SplitNode._ingest writes them after its
    ingest (pnc's fields, and an OR-Set-like extra lane of width 3)."""
    n, w, b = 4, 8, 5
    rng = np.random.default_rng(11 + extras)
    cfg = dag.DagConfig(n, w)
    widths = {"op": 0, "key": 0, "a0": 0, "a1": 0, "a2": 0, "writer": 0}
    if extras:
        widths["rm_tags"] = 3
    ring = {f: rng.integers(-9, 9, (w, n, b) + ((k,) if k else ()))
            .astype(np.int32) for f, k in widths.items()}
    filled = rng.random((w, n)) < 0.3
    st = _state(rng, n, w)
    live = st["slot_round"]
    blocks, pays = [], []
    # distinct (slot, source) cells: JAX's .at[].set leaves the winner of
    # a duplicate unspecified
    cells = rng.choice(w * n, 5, replace=False)
    for j, cell in enumerate(cells):
        r, v = int(live[cell // n]), int(cell % n)
        rows = {f: rng.integers(-2**31, 2**31 - 1, x.shape[2:])
                .astype(np.int32) for f, x in ring.items()}
        flat = np.concatenate([rows[f].reshape(-1) for f in widths])
        pay = j % 2 == 0
        blocks.append((r, v, rng.random(n) < 0.5, flat if pay else None))
        if pay:
            pays.append((r % w, v, rows))
    want = {f: jnp.asarray(x) for f, x in ring.items()}
    want_filled = jnp.asarray(filled)
    ss = np.asarray([s for s, _, _ in pays], np.int32)
    vv = np.asarray([v for _, v, _ in pays], np.int32)
    for f in widths:
        want[f] = want[f].at[ss, vv].set(np.stack([rw[f] for _, _, rw in pays]))
    want_filled = want_filled.at[ss, vv].set(True)
    mine = convert.tree_from_numpy(st, "cpu")
    t_ring = {f: torch.from_numpy(x.copy()) for f, x in ring.items()}
    t_filled = torch.from_numpy(filled.copy())
    dag.ingest_batch(cfg, mine, [0], blocks=blocks,
                     ring=(tuple(t_ring[f] for f in widths), t_filled))
    for f in widths:
        np.testing.assert_array_equal(t_ring[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    np.testing.assert_array_equal(t_filled.numpy(), np.asarray(want_filled))
    ref = jax_dag.ingest_batch(jax_dag.DagConfig(n, w),
                               {k: jnp.asarray(v) for k, v in st.items()}, [0],
                               blocks=[b_[:3] for b_ in blocks])
    _assert_state_equal(mine, ref, "with payloads")


def test_empty_batch_and_wire_counters():
    cfg = dag.DagConfig(4, 8)
    st = dag.init(cfg, "cpu")
    reg = get_registry()
    before = {k: reg.counter(f"dag_wire_{k}_total").value
              for k in ("blocks", "sigs", "certs")}
    assert dag.ingest_batch(cfg, st, [0]) is st
    dag.ingest_batch(cfg, st, [0], blocks=[(0, 1, np.ones(4, bool))] * 2,
                     sigs=[(0, 1, 2)], certs=[(0, 1), (0, 2), (0, 3)])
    got = {k: reg.counter(f"dag_wire_{k}_total").value - before[k]
           for k in before}
    assert got == {"blocks": 2, "sigs": 1, "certs": 3}
    with pytest.raises(ValueError, match="edges row"):
        dag.ingest_batch(cfg, st, [0], blocks=[(0, 1, np.ones(3, bool))])


def test_observe_dag_gauges_match_jax():
    n, w = 7, 6
    rng = np.random.default_rng(8)
    st = _state(rng, n, w, density=0.5)
    mine, ref = Registry(), JaxRegistry()
    dag.observe_dag(dag.DagConfig(n, w), convert.tree_from_numpy(st, "cpu"),
                    registry=mine, scope="split")
    jax_dag.observe_dag(jax_dag.DagConfig(n, w),
                        {k: jnp.asarray(v) for k, v in st.items()},
                        registry=ref, scope="split")
    names = [f"split_{g}" for g in ("base_round", "node_round_min",
                                    "node_round_max", "blocks_live",
                                    "certs_live")]
    assert [mine.gauge(g).value for g in names] == [ref.gauge(g).value
                                                    for g in names]


@functools.lru_cache(maxsize=None)
def _jax_split_round(n, w):
    """JAX's SplitSafeKV._round_step as a function of (state, owned,
    active, withhold, invalid), jitted once per shape."""
    def step(state, owned, active, withhold, invalid):
        kv = types.SimpleNamespace(cfg=jax_dag.DagConfig(n, w), _owned=owned)
        return jax_splitnode.SplitSafeKV._round_step(kv, state, active,
                                                     withhold, invalid)
    return jax.jit(step)


@pytest.mark.parametrize("n,w", SHAPES)
def test_split_round_matches_jax_splitsafekv_round_step(n, w):
    rng = np.random.default_rng(n + 31 * w)
    cfg = dag.DagConfig(n, w)
    step = _jax_split_round(n, w)
    for i in range(4):
        st, _, _ = workloads.consensus_state(rng, n, w)
        owned = rng.random(n) < 0.5
        owned[rng.integers(0, n)] = True
        masks = workloads.round_masks(rng, n, w)
        for keep in ((0, 0, 0), (1, 1, 1), (1, 0, 0), (0, 1, 1)):
            sel = [m if k else None for m, k in zip(masks, keep)]
            ref = step({k: jnp.asarray(v) for k, v in st.items()},
                       jnp.asarray(owned),
                       *(None if m is None else jnp.asarray(m) for m in sel))
            mine = kernels.dag_round(
                cfg, convert.tree_from_numpy(st, "cpu"),
                *(None if m is None else torch.from_numpy(m) for m in sel),
                owned=torch.from_numpy(owned))
            _assert_state_equal(mine, ref, f"N{n} W{w} state {i} {keep}")
            nr = mine["node_round"].numpy()
            np.testing.assert_array_equal(nr[~owned], st["node_round"][~owned])

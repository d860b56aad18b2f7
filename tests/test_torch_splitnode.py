"""The port's split-cluster deployment (janus_tpu_torch.net.splitnode, on
the CPU): the cases of tests/test_splitnode.py with ``device="cpu"``, plus
a lockstep run against the JAX ``SplitNode``s for the PN-Counter and the
OR-Set: the same bytes on the wire at every step, and the same DAG state,
ring (the OR-Set's captured payloads included) and stable state after
every step.

Endpoints exchange real serialized frames over in-memory pipes
(deterministic) and loopback TCP. The lockstep runs sign with the keyed
hash on both sides (``ecdsa_available`` patched to False), so keys and
signatures are the same bytes.
"""
import threading
import time

import numpy as np
import pytest

from janus_tpu.consensus.dag import DagConfig as JaxDagConfig
from janus_tpu.models import orset as jax_orset
from janus_tpu.models import pncounter as jax_pncounter
from janus_tpu.net import binding as jax_binding
from janus_tpu.net import splitnode as jax_splitnode

from janus_tpu_torch import convert
from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.models import orset, pncounter
from janus_tpu_torch.net import binding
from janus_tpu_torch.net.dagplane import TcpPeer
from janus_tpu_torch.net.splitnode import SplitNode

N, W, B = 4, 8, 2
K = 4
FIELDS = ("op", "key", "a0", "a1", "a2", "writer")


def _batch(op, a0, a2=None):
    return {"op": np.asarray(op, np.int32),
            "key": np.zeros((N, B), np.int32),
            "a0": np.broadcast_to(np.asarray(a0, np.int32), (N, B)).copy(),
            "a1": np.zeros((N, B), np.int32),
            "a2": (np.zeros((N, B), np.int32) if a2 is None
                   else np.asarray(a2, np.int32)),
            "writer": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None],
                                      (N, B)).copy()}


def _pnc_ops(nodes, amount=5):
    op = np.zeros((N, B), np.int32)
    for v in nodes:
        op[v, :] = pncounter.OP_INC
    return _batch(op, amount)


class _Pipes:
    """In-memory broadcast fabric between endpoints, with an optional
    per-sender corruption hook."""

    def __init__(self, count, corrupt=None):
        self.boxes = [[] for _ in range(count)]
        self.corrupt = corrupt or {}

    def sender(self, idx):
        def send(data: bytes):
            fn = self.corrupt.get(idx)
            payload = fn(data) if fn else data
            for j, box in enumerate(self.boxes):
                if j != idx:
                    box.append(payload)
        return send

    def pump(self, nodes):
        moved = True
        while moved:
            moved = False
            for j, node in enumerate(nodes):
                if self.boxes[j]:
                    moved = True
                    for d in self.boxes[j]:
                        node.receive(d)
                    self.boxes[j].clear()


def _mk(owned, send, spec=pncounter.SPEC, **dims):
    if not dims:
        dims = {"num_keys": K, "num_writers": N}
    return SplitNode(DagConfig(N, W), spec, B, owned, send=send,
                     device="cpu", **dims)


def test_two_process_payload_replication():
    """An op submitted at process A reads back from process B's stable
    state: blocks carry their payloads."""
    pipes = _Pipes(2)
    a = _mk([1, 1, 0, 0], pipes.sender(0))
    b = _mk([0, 0, 1, 1], pipes.sender(1))
    nodes = [a, b]
    a.start(); b.start(); pipes.pump(nodes)

    safe = np.zeros((N, B), bool)
    safe[0] = True
    a.step(); pipes.pump(nodes)
    b.step(); pipes.pump(nodes)
    assert a.ready and b.ready

    acked = boarded = False
    for _ in range(30):
        info = a.step(None if boarded else _pnc_ops([0, 1]),
                      safe=None if boarded else safe)
        boarded = boarded or (info is not None
                              and bool(info["accepted"][:2].all()))
        pipes.pump(nodes)
        b.step()
        pipes.pump(nodes)
        acked = acked or a.kv.safe_acks()[:, 0, :].any()
    assert boarded
    expect = 2 * B * 5
    np.testing.assert_array_equal(np.asarray(a.query_stable("get"))[:2, 0], expect)
    np.testing.assert_array_equal(np.asarray(b.query_stable("get"))[2:, 0], expect)
    assert acked
    for n_ in nodes:
        assert n_.stats["verified_bad"] == 0
        assert n_.kv.base_round() > 2
    oa, ob = a.kv.ordered_commits(0), b.kv.ordered_commits(2)
    common = min(len(oa), len(ob))
    assert common > 10
    assert oa[:common] == ob[:common]


def _orset_nodes(pipes):
    dims = {"num_keys": 2, "capacity": 16, "rm_capacity": 4}
    a = _mk([1, 1, 0, 0], pipes.sender(0), orset.SPEC, **dims)
    b = _mk([0, 0, 1, 1], pipes.sender(1), orset.SPEC, **dims)
    return a, b


def _orset_ops(code, tag=None):
    op = np.zeros((N, B), np.int32)
    op[0, 0] = code
    a2 = None
    if tag is not None:
        a2 = np.zeros((N, B), np.int32)
        a2[0, 0] = tag
    return _batch(op, 42, a2)


def test_orset_capture_payload_across_processes():
    """Effect-captured ops (OR-Set removes carry observed tags) survive
    serialization: an add+remove at A leaves B's stable empty."""
    pipes = _Pipes(2)
    a, b = _orset_nodes(pipes)
    nodes = [a, b]
    a.start(); b.start(); pipes.pump(nodes)

    def drive(ops=None):
        info = a.step(ops)
        pipes.pump(nodes)
        b.step()
        pipes.pump(nodes)
        return info

    def drive_until_boarded(ops):
        for _ in range(10):
            info = drive(ops)
            if info is not None and info["accepted"][0]:
                return
        raise AssertionError("ops never boarded a block")

    drive_until_boarded(_orset_ops(orset.OP_ADD, tag=1))
    for _ in range(14):
        drive()
    assert bool(np.asarray(b.query_stable("contains", 0, 42))[2])
    drive_until_boarded(_orset_ops(orset.OP_REMOVE))
    for _ in range(14):
        drive()
    got = np.asarray(b.query_stable("contains", 0, 42))[2:]
    assert not got.any(), "captured remove did not replicate"


def test_tampered_blocks_dropped_liveness_holds():
    """A peer whose frames are corrupted in transit is detected (signature
    verification) and excluded; the honest 2f+1 keep committing."""

    def flip(data: bytes) -> bytes:
        mut = bytearray(data)
        if len(mut) > 24:
            mut[20] ^= 0xFF
        return bytes(mut)

    pipes = _Pipes(4, corrupt={3: flip})
    nodes = [_mk([i == j for j in range(N)], pipes.sender(i))
             for i in range(N)]
    for n_ in nodes:
        n_.start()
    pipes.pump(nodes)
    boarded = [False] * N
    for _ in range(60):
        for i, n_ in enumerate(nodes):
            info = n_.step(None if boarded[i] else _pnc_ops([i]))
            if not boarded[i] and info is not None:
                boarded[i] = bool(info["accepted"][i])
        pipes.pump(nodes)
    assert all(boarded)
    honest = nodes[:3]
    assert any(n_.stats["verified_bad"] > 0 for n_ in honest)
    for n_ in honest:
        assert int(n_.kv.dag["node_round"][n_.owned_idx[0]]) > 10
        v = int(n_.owned_idx[0])
        assert all(src != 3 for _r, src in n_.kv.ordered_commits(v))
        vals = np.asarray(n_.query_stable("get"))[v, 0]
        assert int(vals) == 3 * B * 5  # nodes 0..2 each +5 per lane


def test_split_over_loopback_tcp():
    """The two-process exchange over real sockets (TcpPeer)."""
    import socket

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    peers = {}
    a = _mk([1, 1, 0, 0], lambda d: peers["a"].send(d))
    b = _mk([0, 0, 1, 1], lambda d: peers["b"].send(d))
    accepted = {}

    def accept():
        conn, _ = srv.accept()
        accepted["sock"] = conn

    th = threading.Thread(target=accept)
    th.start()
    peers["b"] = TcpPeer.connect("127.0.0.1", port, b.receive)
    th.join()
    peers["a"] = TcpPeer(accepted["sock"], a.receive)
    try:
        a.start(); b.start()
        deadline = time.monotonic() + 60
        while not (a.ready and b.ready):
            a.step(); b.step()
            if time.monotonic() > deadline:
                pytest.fail("key exchange did not complete")
            time.sleep(0.01)
        boarded = False
        for _ in range(40):
            info = a.step(None if boarded else _pnc_ops([0, 1]))
            boarded = boarded or (info is not None
                                  and bool(info["accepted"][:2].all()))
            time.sleep(0.002)
            b.step()
            time.sleep(0.002)
        assert boarded
        np.testing.assert_array_equal(np.asarray(b.query_stable("get"))[2:, 0],
                                      2 * B * 5)
        assert b.stats["verified_bad"] == 0
    finally:
        peers["a"].close()
        peers["b"].close()
        srv.close()


def test_key_exchange_budget_degrades_then_recovers():
    a = _mk([1, 1, 0, 0], lambda data: None)
    a.key_retry_budget = 5
    a.start()
    for _ in range(4):
        assert a.step() is None      # not ready: parked, under budget
    assert a.degraded_reason is None
    assert a.step() is None          # 5th not-ready step blows the budget
    assert "key exchange" in a.degraded_reason
    assert "missing nodes" in a.degraded_reason
    assert "2" in a.degraded_reason and "3" in a.degraded_reason
    b = _mk([0, 0, 1, 1], a.receive)
    b.start()
    a.step()
    assert a.ready
    assert a.degraded_reason is None


def test_parked_block_dropped_after_retry_budget():
    pipes = _Pipes(2)
    a = _mk([1, 1, 0, 0], pipes.sender(0))
    a.key_retry_budget = 3
    b = _mk([0, 0, 1, 1], pipes.sender(1))
    nodes = [a, b]
    a.start(); b.start(); pipes.pump(nodes)
    a.step(); pipes.pump(nodes)
    b.step(); pipes.pump(nodes)
    assert a.ready
    a._pending_blocks.append([2, 9, b"\x00", 0])
    for _ in range(2):
        a.step()
        pipes.pump(nodes)
        b.step()
        pipes.pump(nodes)
    assert a._pending_blocks, "parked block dropped before its budget"
    assert a.stats["parked_dropped"] == 0
    a.step()
    assert a._pending_blocks == []
    assert a.stats["parked_dropped"] == 1
    assert a.degraded_reason is None


class _Recorder:
    """Per-endpoint outboxes: what each endpoint sent since the last take,
    message by message."""

    def __init__(self, count):
        self.out = [[] for _ in range(count)]

    def sender(self, idx):
        return self.out[idx].append

    def take(self, idx):
        sent = list(self.out[idx])
        self.out[idx].clear()
        return sent


def _lockstep(monkeypatch, jax_spec, spec, dims, schedule):
    """Two JAX SplitNodes and two of the port's, driven by one schedule
    (``schedule(t) -> ops for endpoint 0 or None``) over recorded links;
    asserts equal sends and states after every step."""
    monkeypatch.setattr(jax_binding, "ecdsa_available", lambda: False)
    monkeypatch.setattr(binding, "ecdsa_available", lambda: False)
    owned = ([1, 1, 0, 0], [0, 0, 1, 1])
    recs = {"jax": _Recorder(2), "port": _Recorder(2)}
    nodes = {
        "jax": [jax_splitnode.SplitNode(JaxDagConfig(N, W), jax_spec, B, o,
                                        send=recs["jax"].sender(i), **dims)
                for i, o in enumerate(owned)],
        "port": [SplitNode(DagConfig(N, W), spec, B, o,
                           send=recs["port"].sender(i), device="cpu", **dims)
                 for i, o in enumerate(owned)],
    }

    def exchange(i, where):
        sent = {side: recs[side].take(i) for side in recs}
        assert sent["port"] == sent["jax"], where
        for side in nodes:
            for data in sent[side]:
                nodes[side][1 - i].receive(data)
        return sum(len(x) for x in sent["port"])

    for i in (0, 1):
        for side in nodes:
            nodes[side][i].start()
        exchange(i, f"start {i}")
    wire_bytes = 0
    for t in range(len(schedule)):
        for i in (0, 1):
            ops = schedule[t] if i == 0 else None
            infos = {side: nodes[side][i].step(ops) for side in nodes}
            assert (infos["jax"] is None) == (infos["port"] is None)
            if infos["port"] is not None:
                np.testing.assert_array_equal(infos["port"]["accepted"],
                                              infos["jax"]["accepted"])
            wire_bytes += exchange(i, f"step {t} endpoint {i}")
            for j in (0, 1):
                jkv, kv = nodes["jax"][j].kv, nodes["port"][j].kv
                for name in ("dag", "stable", "prospective", "ops_buffer"):
                    mine = convert.tree_to_numpy(getattr(kv, name))
                    ref = getattr(jkv, name)
                    for f, x in mine.items():
                        np.testing.assert_array_equal(
                            x, np.asarray(ref[f]),
                            err_msg=f"step {t} endpoint {j}: {name}.{f}")
                np.testing.assert_array_equal(
                    kv.buffer_filled.numpy(), np.asarray(jkv.buffer_filled))
                assert nodes["port"][j].stats == nodes["jax"][j].stats
    return nodes["port"], wire_bytes


def test_lockstep_pncounter_matches_jax(monkeypatch):
    ops = _pnc_ops([0, 1])
    schedule = [ops if t % 3 == 0 else None for t in range(20)]
    port, wire_bytes = _lockstep(
        monkeypatch, jax_pncounter.SPEC, pncounter.SPEC,
        {"num_keys": K, "num_writers": N}, schedule)
    assert wire_bytes > 0 and port[0].kv.base_round() > 2
    assert int(np.asarray(port[1].query_stable("get"))[2, 0]) > 0


def test_lockstep_orset_captured_payloads_match_jax(monkeypatch):
    add = _orset_ops(orset.OP_ADD, tag=1)
    rm = _orset_ops(orset.OP_REMOVE)
    schedule = [add if t in (1, 2) else rm if t in (9, 10) else None
                for t in range(18)]
    port, _ = _lockstep(
        monkeypatch, jax_orset.SPEC, orset.SPEC,
        {"num_keys": 2, "capacity": 16, "rm_capacity": 4}, schedule)
    captured = [f for f in port[0].kv.ops_buffer if f not in FIELDS]
    assert captured  # the OR-Set's capture lanes rode the ring

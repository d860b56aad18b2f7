"""The port's DAG message plane and split-cluster transport
(janus_tpu_torch.net.dagplane, on the CPU), the cases of
tests/test_dagplane.py, plus a lockstep run against the JAX endpoints (the
same bytes on the wire and the same DAG state after every step), the wire
helpers against the JAX client's, and the port's crypto binding."""
import hashlib
import socket
import time

import numpy as np
import pytest

from janus_tpu.net import client as jax_client
from janus_tpu.net import dagplane as jax_dagplane
from janus_tpu.consensus import dag as jax_dag

from janus_tpu_torch import convert
from janus_tpu_torch.consensus import DagConfig, commit_view, init_commit, ordered_blocks
from janus_tpu_torch.net import binding, wire
from janus_tpu_torch.net.dagplane import (
    MSG_BLOCK,
    MSG_CERT,
    MSG_SIG,
    SplitClusterEndpoint,
    TcpPeer,
    decode_messages,
    encode_block,
    encode_certificate,
    encode_signature,
)

N, W = 4, 8


def test_message_roundtrip_and_demux():
    edges = np.asarray([True, False, True, True])
    buf = bytearray()
    buf += encode_block(12, 3, edges)
    buf += encode_signature(12, 3, 1)
    buf += encode_certificate(12, 3)
    msgs = decode_messages(buf)
    assert [m for m, _ in msgs] == [MSG_BLOCK, MSG_SIG, MSG_CERT]
    assert msgs[0][1]["round"] == 12 and msgs[0][1]["source"] == 3
    np.testing.assert_array_equal(msgs[0][1]["edges"], edges)
    assert msgs[1][1]["signer"] == 1
    assert len(buf) == 0  # fully drained


def test_partial_frame_waits_for_more_bytes():
    whole = encode_block(2, 0, np.ones(N, bool))
    buf = bytearray(whole[: len(whole) // 2])
    assert decode_messages(buf) == []
    buf += whole[len(whole) // 2:]
    assert len(decode_messages(buf)) == 1


def test_codec_bytes_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        r, src, signer = (int(x) for x in rng.integers(0, 2**40, 3))
        edges = rng.random(int(rng.integers(1, 70))) < 0.5
        assert encode_block(r, src, edges) == jax_dagplane.encode_block(r, src, edges)
        assert (encode_signature(r, src, signer)
                == jax_dagplane.encode_signature(r, src, signer))
        assert (encode_certificate(r, src)
                == jax_dagplane.encode_certificate(r, src))
    # a malformed frame (a block claiming more bits than it carries) and
    # an unknown type are dropped the same way
    junk = bytearray(wire.frame(wire._varint(1) + wire._varint(2)
                                + wire._varint(99), MSG_BLOCK)
                     + wire.frame(wire._varint(5) + wire._varint(1), 9)
                     + encode_certificate(7, 1))
    mine, ref = decode_messages(bytearray(junk)), jax_dagplane.decode_messages(junk)
    assert [m for m, _ in mine] == [m for m, _ in ref] == [9, MSG_CERT]


def test_wire_helpers_match_the_jax_client():
    rng = np.random.default_rng(2)
    values = [0, 1, 127, 128, 300, 2**31 - 1, 2**32, 2**63 - 1, 2**64 - 1,
              *(int(x) for x in rng.integers(0, 2**62, 30))]
    for v in values:
        enc = wire._varint(v)
        assert enc == jax_client._varint(v)
        assert wire._read_varint(enc + b"\x07", 0) == (v, len(enc))
        assert wire._read_varint(enc[:-1], 0) == jax_client._read_varint(enc[:-1], 0)
    for field in (1, 2, 6, 7, 31):
        payload = rng.bytes(int(rng.integers(0, 300)))
        assert wire.frame(payload, field) == jax_client.frame(payload, field)
    long = bytes([0x80] * 10) + b"\x01"
    for fn in (wire._read_varint, jax_client._read_varint):
        with pytest.raises(ValueError, match="malformed varint"):
            fn(long, 0)


def test_crypto_binding_sha256_and_ecdsa():
    rng = np.random.default_rng(3)
    for size in (0, 1, 55, 56, 63, 64, 65, 119, 120, 1000, 4097):
        data = rng.bytes(size)
        assert binding.sha256(data) == hashlib.sha256(data).digest()
    lib = binding.load()
    assert binding.LIB_PATH.parent.name == "build"
    assert binding.LIB_PATH.exists() and lib is binding.load()
    if not binding.ecdsa_available():
        pytest.skip("libcrypto.so.3 is absent: the keyed-hash mode runs")
    priv, pub = binding.ecdsa_keygen()
    digest = binding.sha256(b"block")
    sig = binding.ecdsa_sign(priv, digest)
    assert binding.ecdsa_verify(pub, digest, sig)
    assert not binding.ecdsa_verify(pub, binding.sha256(b"other"), sig)
    _, pub2 = binding.ecdsa_keygen()
    assert not binding.ecdsa_verify(pub2, digest, sig)


def _pair(cfg, send_a, send_b):
    a = SplitClusterEndpoint(cfg, np.asarray([True, True, False, False]),
                             send=send_a, device="cpu")
    b = SplitClusterEndpoint(cfg, np.asarray([False, False, True, True]),
                             send=send_b, device="cpu")
    return a, b


def _assert_agree(cfg, a, b):
    assert a.node_rounds().min() >= W - 2
    assert b.node_rounds().min() >= W - 2
    ca = commit_view(cfg, a.state, init_commit(cfg, "cpu"))
    cb = commit_view(cfg, b.state, init_commit(cfg, "cpu"))
    oa = ordered_blocks(cfg, ca, 0)
    ob = ordered_blocks(cfg, cb, 2)
    shortest = min(len(oa), len(ob))
    assert shortest > 0
    assert oa[:shortest] == ob[:shortest]


def test_split_cluster_converges_in_memory():
    """Two endpoints, each owning half the nodes, exchange DAG messages and
    advance in lockstep; both sides commit the same total-order prefix."""
    cfg = DagConfig(N, W)
    inbox_a, inbox_b = [], []
    a, b = _pair(cfg, inbox_b.append, inbox_a.append)
    for _ in range(5 * W):
        a.step()
        b.step()
        for data in inbox_a:
            a.receive(data)
        for data in inbox_b:
            b.receive(data)
        inbox_a.clear()
        inbox_b.clear()
    a.step()
    b.step()
    _assert_agree(cfg, a, b)


def test_split_cluster_over_loopback_tcp():
    cfg = DagConfig(N, W)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    a, b = _pair(cfg, None, None)
    client = socket.create_connection(("127.0.0.1", port), timeout=10)
    server_side, _ = lsock.accept()
    peer_a = TcpPeer(client, a.receive)
    peer_b = TcpPeer(server_side, b.receive)
    a.send = peer_a.send
    b.send = peer_b.send
    try:
        # an endpoint sends at the end of its step, so each side waits for
        # the other's messages before stepping
        for _ in range(2 * W + 1):
            for end in (a, b):
                end.step()
                time.sleep(0.02)  # let the receive threads drain
        _assert_agree(cfg, a, b)
    finally:
        peer_a.close()
        peer_b.close()
        lsock.close()


def test_lockstep_bytes_and_state_match_jax_endpoints():
    """The JAX endpoints and the port's, driven side by side over the same
    in-memory links: every step sends the same bytes, message by message,
    and leaves the same DAG state."""
    cfg, jcfg = DagConfig(N, W), jax_dag.DagConfig(N, W)
    owned = (np.asarray([True, True, False, False]),
             np.asarray([False, False, True, True]))
    sent = {side: ([], []) for side in ("jax", "port")}
    ends = {
        "jax": [jax_dagplane.SplitClusterEndpoint(jcfg, o, send=sent["jax"][i].append)
                for i, o in enumerate(owned)],
        "port": [SplitClusterEndpoint(cfg, o, send=sent["port"][i].append,
                                      device="cpu")
                 for i, o in enumerate(owned)],
    }
    messages = 0
    for t in range(3 * W):
        for i in (0, 1):
            for side in ends:
                ends[side][i].step()
            assert sent["port"][i] == sent["jax"][i], f"step {t} endpoint {i}"
            messages += len(sent["port"][i])
            for side in ends:
                for data in sent[side][i]:
                    ends[side][1 - i].receive(data)
                sent[side][i].clear()
            for j in (0, 1):
                js = ends["jax"][j].state
                for f, x in ends["port"][j].state.items():
                    np.testing.assert_array_equal(
                        convert.tree_to_numpy(x), np.asarray(js[f]),
                        err_msg=f"step {t} endpoint {j}: {f}")
    assert messages > 50
    assert ends["port"][0].node_rounds().min() >= W - 2

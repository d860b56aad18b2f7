"""Serialized DAG message plane + split-cluster transport: the
replica-to-replica wire for deployments where the emulated cluster spans
more than one process or host (counterpart: janus_tpu/net/dagplane.py).

Reference: DAG messages are a protobuf class hierarchy with subtype
framing: the length-prefix frame's field number names the message type,
and the receive loop demuxes on it (DAGConsensus/DAGMessage.cs:13-64
MessageTypeResolver; CMNode.cs:81; ManagerServer.cs:86-138). Field 2 is a
block, 3 a certificate, 4 a signature, over the Base128 framing of
``net/wire``.

Each endpoint owns a subset of the emulated nodes: its owned nodes create,
sign and certify locally, and the endpoint serializes its new blocks,
signatures and certificates to its peers and ingests theirs through
``dag.ingest_batch``, the reference's message economy (broadcast blocks,
unicast signatures to the creator, broadcast certificates). On the card a
step is one ``dag_ingest`` launch for the inbox and one ``dag_round``
launch for the round. TCP transport is thread-per-peer with
length-prefixed frames (CMNode's channel + sender-thread shape)."""
from __future__ import annotations

import socket
import threading
from typing import List, Tuple

import numpy as np
import torch

from janus_tpu_torch.consensus import dag as dagmod
from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.net.wire import _read_varint, _varint, frame
from janus_tpu_torch.utils.log import get_logger

MSG_BLOCK = 2
MSG_CERT = 3
MSG_SIG = 4

# the fields a round's outbound messages are diffed from
_DIFFED = ("block_exists", "acks", "cert_exists")


def encode_block(r: int, source: int, edges_row: np.ndarray) -> bytes:
    body = bytearray()
    body += _varint(int(r))
    body += _varint(int(source))
    bits = np.asarray(edges_row, bool)
    body += _varint(len(bits))
    body += bytes(np.packbits(bits).tobytes())
    return frame(bytes(body), MSG_BLOCK)


def encode_certificate(r: int, source: int) -> bytes:
    return frame(_varint(int(r)) + _varint(int(source)), MSG_CERT)


def encode_signature(r: int, source: int, signer: int) -> bytes:
    return frame(_varint(int(r)) + _varint(int(source))
                 + _varint(int(signer)), MSG_SIG)


def decode_messages(buf: bytearray) -> List[Tuple[int, dict]]:
    """Drain complete frames from ``buf``; returns (msg_type, fields)
    pairs (the MessageTypeResolver demux). A malformed frame is dropped,
    never fatal to the step loop."""
    out = []
    while True:
        tag, off = _read_varint(buf, 0)
        if tag is None:
            break
        n, off = _read_varint(buf, off)
        if n is None or off + n > len(buf):
            break
        payload = bytes(buf[off: off + n])
        del buf[: off + n]
        mtype = tag >> 3
        try:
            r, p = _read_varint(payload, 0)
            src, p = _read_varint(payload, p)
            if r is None or src is None:
                continue
            fields = {"round": r, "source": src}
            if mtype == MSG_BLOCK:
                nbits, p = _read_varint(payload, p)
                if nbits is None or nbits > 8 * (len(payload) - p):
                    continue
                bits = np.unpackbits(
                    np.frombuffer(payload[p:], np.uint8), count=nbits
                ).astype(bool)
                fields["edges"] = bits
            elif mtype == MSG_SIG:
                fields["signer"], p = _read_varint(payload, p)
                if fields["signer"] is None:
                    continue
            out.append((mtype, fields))
        except (ValueError, TypeError):
            continue
    return out


class SplitClusterEndpoint:
    """One process's share of an emulated cluster, on ``device`` (CUDA
    unless the caller passes ``device="cpu"``): owned nodes act through
    the DAG round, everything else arrives as DAG messages.

    ``send(bytes)`` is pluggable (TCP, in-memory queue, ...); feed
    received bytes to ``receive``. Call ``step()`` once per protocol
    round."""

    def __init__(self, cfg: DagConfig, owned: np.ndarray, send=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.owned = np.asarray(owned, bool)
        self.owned_idx = np.nonzero(self.owned)[0]
        self.state = dagmod.init(cfg, self.device)
        self.send = send or (lambda data: None)
        self._rxbuf = bytearray()
        self._rxlock = threading.Lock()
        self._act = torch.as_tensor(self.owned, device=self.device)

    # -- wire ------------------------------------------------------------

    def receive(self, data: bytes) -> None:
        with self._rxlock:
            self._rxbuf.extend(data)

    def _drain_inbox(self) -> None:
        with self._rxlock:
            msgs = decode_messages(self._rxbuf)
        if not msgs:
            return
        blocks, sigs, certs = [], [], []
        for mtype, f in msgs:
            if mtype == MSG_BLOCK:
                blocks.append((f["round"], f["source"], f["edges"]))
            elif mtype == MSG_SIG:
                sigs.append((f["round"], f["source"], f["signer"]))
            elif mtype == MSG_CERT:
                certs.append((f["round"], f["source"]))
        dagmod.ingest_batch(self.cfg, self.state, self.owned_idx,
                            blocks=blocks, sigs=sigs, certs=certs)

    # -- protocol --------------------------------------------------------

    def step(self) -> None:
        """One protocol round for the owned nodes + message exchange:
        create (owned) -> sign (owned signers) -> certify (owned creators)
        -> deliver to the owned nodes -> advance, as one ``round_step``
        with ``active = owned``; then this round's new blocks are
        broadcast, the new signatures of remote creators' blocks unicast
        and the new certificates broadcast, in that order. No phase after
        creation changes the edges, and none after signing the acks, so
        diffing the round's output against its input gives the messages
        the phase-by-phase round would send."""
        cfg = self.cfg
        self._drain_inbox()
        st = self.state
        before = torch.cat([st[f].reshape(-1) for f in _DIFFED])
        st = dagmod.round_step(cfg, st, active=self._act)
        self.state = st
        # one copy to the host: the three fields before and after, the
        # edges, and slot_round's bytes
        host = torch.cat([before, *(st[f].reshape(-1)
                                    for f in _DIFFED + ("edges",)),
                          st["slot_round"].view(torch.bool)]).cpu().numpy()
        n, w = cfg.num_nodes, cfg.num_rounds
        sizes = (w * n, w * n * n, w * n)
        cuts = np.cumsum(sizes * 2 + (w * n * n,))
        old_be, old_acks, old_ce, be, acks, ce, edges, sr = np.split(host, cuts)
        sr = sr.view(np.int32)
        new_blocks = (be & ~old_be).reshape(w, n)
        edges = edges.reshape(w, n, n)
        for s, src in zip(*np.nonzero(new_blocks)):
            self.send(encode_block(int(sr[s]), int(src), edges[s, src]))
        new_acks = (acks & ~old_acks).reshape(w, n, n)
        for s, src, signer in zip(*np.nonzero(new_acks)):
            if not self.owned[src]:  # unicast to the remote creator
                self.send(encode_signature(int(sr[s]), int(src), int(signer)))
        new_certs = (ce & ~old_ce).reshape(w, n)
        for s, src in zip(*np.nonzero(new_certs)):
            self.send(encode_certificate(int(sr[s]), int(src)))

    def node_rounds(self) -> np.ndarray:
        return self.state["node_round"].cpu().numpy()[self.owned]


class TcpPeer:
    """Bidirectional framed byte pipe to one peer (CMNode + ManagerServer
    in one: dedicated sender path, receive thread feeding a callback)."""

    def __init__(self, sock: socket.socket, on_receive, start: bool = True,
                 name: str = "?"):
        self.sock = sock
        self.name = name
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # a connect timeout must not survive as a receive timeout: an idle
        # peer would otherwise end the receive thread and drop every later
        # message
        self.sock.settimeout(None)
        self._lock = threading.Lock()
        self._on_receive = on_receive
        self._closed = False
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        # start=False lets a caller finish registering this peer before
        # reception begins (on loopback the first frame is often already
        # buffered)
        if start:
            self._rx.start()

    def start(self) -> None:
        if not self._rx.is_alive():
            self._rx.start()

    @classmethod
    def connect(cls, host: str, port: int, on_receive) -> "TcpPeer":
        return cls(socket.create_connection((host, port), timeout=30),
                   on_receive)

    def send(self, data: bytes) -> None:
        with self._lock:
            self.sock.sendall(data)

    def _recv_loop(self):
        log = get_logger("peer", self.name)
        while not self._closed:
            try:
                chunk = self.sock.recv(65536)
            except OSError as e:
                if not self._closed:
                    log.warning("receive from %s failed: %s", self.name, e)
                break
            if not chunk:
                log.debug("peer %s closed its end", self.name)
                break
            try:
                self._on_receive(chunk)
            except Exception:  # noqa: BLE001 - logged, then the link closes
                # dropping a mid-stream chunk would desync the
                # length-prefixed framing, so the connection is closed
                # rather than resumed
                log.exception("receive callback failed for peer %s; "
                              "closing the connection", self.name)
                self.close()
                break

    def close(self):
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

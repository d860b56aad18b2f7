"""Split-cluster node: one process's share of an emulated cluster, with
payload-carrying, signed blocks over the serialized DAG plane: the
multi-process deployment the reference runs as one OS process per
replica (start_servers.py:115-133, Cluster.cs:38-59). Counterpart:
janus_tpu/net/splitnode.py.

Reference mapping:
- A VertexBlockMessage carries its update batches as block content
  (DAGMessage.cs:68-114, DAGUpdateMessage.cs:32-55): a block frame carries
  its edge row and its [B]-lane op payload, so committing a block anywhere
  delivers the data.
- Every received block, signature and certificate is verified before it
  touches protocol state (ReceivedBlock DAG.cs:413-472;
  Certificate.CheckSignatures Block.cs:110-120): blocks are ECDSA-signed
  over a SHA-256 digest of round, source, edges and ops; signature
  messages carry the signer's signature over that digest; certificate
  messages carry >= 2f+1 signer signatures. Public keys travel in an
  InitMessage broadcast before round 1 (DAG.cs:142-145, 382-406). Without
  libcrypto the signature is a keyed SHA-256 hash (the reference's
  keyed-hash mode).
- Missing blocks are repaired by query (BlockQueryMessage, DAG.cs:612-621):
  a certificate or signature arriving before its block parks, and after a
  few steps the node queries its peers, who replay the stored block frame.

Device split: the owned nodes' protocol phases run inside the same SafeKV
round the in-emulation path uses, through ``dag_round``'s split mode;
mirrors of remote nodes advance only through verified wire ingest (one
``dag_ingest`` launch a step, which also writes the fresh blocks' op
payloads into the ring), and the GC frontier follows real remote progress
through the node rounds that ingest learns from blocks. Outbound messages
are diffed on the host from one copy of the DAG fields a step and sent as
one batched byte string.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.consensus import dag as dagmod
from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.models import base
from janus_tpu_torch.net import binding
from janus_tpu_torch.net.wire import _read_varint, _varint, frame
from janus_tpu_torch.obs import stages as obs_stages
from janus_tpu_torch.obs.metrics import get_registry
from janus_tpu_torch.runtime.safecrdt import SafeKV
from janus_tpu_torch.utils.log import get_logger

# wire-plane telemetry (process-wide): DAG-message bytes in/out and the
# measured drain->verify->ingest leg of each step
_C_RX_BYTES = get_registry().counter("split_rx_bytes_total")
_C_TX_BYTES = get_registry().counter("split_tx_bytes_total")
_H_WIRE_INGEST = obs_stages.stage_histograms("split")["ingest"]

# DAG-plane subtype framing (field number = message type; CMNode.cs:81)
MSG_CERT = 3        # round, source, [(signer, sig)] x >= quorum
MSG_SIG = 4         # round, source, signer, sig over the block digest
MSG_QUERY = 5       # round, source: "replay that block frame"
MSG_BLOCK_OPS = 6   # round, source, edges, op payload lanes, creator sig
MSG_INIT = 7        # node_id, public key

# the DAG fields _emit reads, fetched in one copy
_EMITTED = ("block_exists", "acks", "cert_exists", "edges")


def _put_bytes(body: bytearray, b: bytes) -> None:
    body += _varint(len(b))
    body += b


def _get_bytes(payload: bytes, off: int):
    n, off = _read_varint(payload, off)
    if n is None or off + n > len(payload):
        return None, off
    return payload[off: off + n], off + n


class SplitSafeKV(SafeKV):
    """SafeKV where only ``owned`` nodes act; the rest are mirrors fed by
    wire ingest. Mirrors receive local deliveries but never create, sign,
    certify, accept submissions, or advance node_round on their own: a
    mirror's node_round is evidence of remote progress (learned from its
    blocks), which keeps the GC frontier from freezing out, or running
    over, a remote process."""

    def __init__(self, cfg: DagConfig, spec, ops_per_block: int,
                 owned: np.ndarray, **kw):
        super().__init__(cfg, spec, ops_per_block, **kw)
        self._owned = torch.as_tensor(np.asarray(owned, bool),
                                      device=self.device)
        self._submit_mask = self._owned

    def _round_step(self, dag_state, active, withhold, invalid):
        """One DAG round for the owned nodes: ``dag_round``'s split mode."""
        return kernels.dag_round(self.cfg, dag_state, active, withhold,
                                 invalid, owned=self._owned)


class SplitNode:
    """One process's endpoint: a SplitSafeKV plus the signed wire.

    ``send(bytes)`` broadcasts to every peer (plug a TcpPeer fan-out or
    an in-memory pipe); feed received bytes to ``receive``. Call
    ``start()`` once (broadcasts key material), then ``step()`` per
    protocol round; it returns the SafeKV step info, or None while the
    key exchange is incomplete. ``device``: CUDA unless the caller passes
    ``device="cpu"``."""

    QUERY_AFTER = 3  # steps a pending sig/cert waits before block query

    def __init__(self, cfg: DagConfig, spec, ops_per_block: int,
                 owned, send: Optional[Callable[[bytes], None]] = None,
                 key_retry_budget: int = 512, device=None, **dims):
        self.cfg = cfg
        self.spec = spec
        self.owned = np.asarray(owned, bool)
        self.owned_idx = np.nonzero(self.owned)[0]
        self.kv = SplitSafeKV(cfg, spec, ops_per_block, self.owned,
                              device=device, **dims)
        self.B = ops_per_block
        self.log = get_logger("splitnode", spec.type_code)
        self.send = send or (lambda data: None)
        self.use_ecdsa = binding.ecdsa_available()
        rng = np.random.default_rng(int(self.owned_idx[0]) + 1)
        self._priv: Dict[int, bytes] = {}
        self.keys: Dict[int, bytes] = {}
        for v in self.owned_idx:
            if self.use_ecdsa:
                priv, pub = binding.ecdsa_keygen()
            else:
                priv = rng.bytes(32)
                pub = priv  # keyed-hash mode: the verifier recomputes the MAC
            self._priv[int(v)] = priv
            self.keys[int(v)] = pub
        # op payload lanes travel in this fixed order
        self._field_order = list(base.OP_FIELDS) + sorted(
            self.kv.extra_widths)
        self._idle = base.make_op_batch(
            op=np.zeros((cfg.num_nodes, self.B), np.int32),
            device=self.kv.device)
        self._rxbuf = bytearray()
        self._rxlock = threading.Lock()
        # (round, source) -> block digest / signer sigs / sent frame
        self._digests: Dict[Tuple[int, int], bytes] = {}
        self._sig_store: Dict[Tuple[int, int], Dict[int, bytes]] = {}
        self._frames: Dict[Tuple[int, int], bytes] = {}
        # messages parked until their block (digest) arrives and their
        # logical round enters the live ring window
        self._pending_sigs: List[list] = []   # [r, src, signer, sig, age]
        self._pending_certs: List[list] = []  # [r, src, entries, age]
        self._pending_blocks: List[list] = []  # parsed, awaiting src key
        # verified blocks whose round is ahead of the window (a remote
        # process can run up to W rounds ahead); retried every step
        self._parked_blocks: Dict[Tuple[int, int], tuple] = {}
        n, w = cfg.num_nodes, cfg.num_rounds
        self._prev_be = np.zeros((w, n), bool)
        self._prev_acks = np.zeros((w, n, n), bool)
        self._prev_ce = np.zeros((w, n), bool)
        self.stats = {"verified_ok": 0, "verified_bad": 0, "queries": 0,
                      "stale_dropped": 0, "parked_dropped": 0}
        # bounded key-exchange wait: after this many not-ready steps (or a
        # parked block re-parking this many times) the node stops parking
        # forever and reports a degraded state in ``degraded_reason``
        self.key_retry_budget = int(key_retry_budget)
        self._key_wait_steps = 0
        self.degraded_reason: Optional[str] = None

    # -- crypto ----------------------------------------------------------

    def _sign(self, node: int, digest: bytes) -> bytes:
        priv = self._priv[node]
        if self.use_ecdsa:
            return binding.ecdsa_sign(priv, digest)
        return binding.sha256(priv + digest)

    def _verify(self, node: int, digest: bytes, sig: bytes) -> bool:
        pub = self.keys.get(node)
        if pub is None:
            return False
        if self.use_ecdsa:
            return binding.ecdsa_verify(pub, digest, sig)
        return binding.sha256(pub + digest) == sig

    @property
    def ready(self) -> bool:
        return len(self.keys) == self.cfg.num_nodes

    # -- codec -----------------------------------------------------------

    def _digest_block(self, r: int, src: int, edge_bytes: bytes,
                      ops_bytes: bytes) -> bytes:
        return binding.sha256(
            int(r).to_bytes(8, "little") + int(src).to_bytes(4, "little")
            + edge_bytes + ops_bytes)

    def _ops_bytes(self, rows: Dict[str, np.ndarray]) -> bytes:
        return b"".join(
            np.ascontiguousarray(rows[f], dtype="<i4").tobytes()
            for f in self._field_order)

    def _encode_block(self, r: int, src: int, edges_row: np.ndarray,
                      ops: bytes, sig: bytes) -> bytes:
        body = bytearray()
        body += _varint(int(r))
        body += _varint(int(src))
        bits = np.asarray(edges_row, bool)
        body += _varint(len(bits))
        body += np.packbits(bits).tobytes()
        _put_bytes(body, ops)
        _put_bytes(body, sig)
        return frame(bytes(body), MSG_BLOCK_OPS)

    def _decode_ops(self, ops: bytes) -> Optional[Dict[str, np.ndarray]]:
        rows = {}
        off = 0
        for f in self._field_order:
            w = self.kv.extra_widths.get(f)
            count = self.B * (w if w else 1)
            end = off + 4 * count
            if end > len(ops):
                return None
            arr = np.frombuffer(ops[off:end], "<i4")
            rows[f] = arr.reshape((self.B, w)) if w else arr
            off = end
        return rows if off == len(ops) else None

    def _init_frames(self) -> bytes:
        out = bytearray()
        for v in self.owned_idx:
            body = bytearray(_varint(int(v)))
            _put_bytes(body, self.keys[int(v)])
            out += frame(bytes(body), MSG_INIT)
        return bytes(out)

    # -- inbound ---------------------------------------------------------

    def receive(self, data: bytes) -> None:
        _C_RX_BYTES.add(len(data))
        with self._rxlock:
            self._rxbuf.extend(data)

    def _parse_frames(self) -> List[Tuple[int, bytes]]:
        out = []
        with self._rxlock:
            buf = self._rxbuf
            while True:
                try:
                    tag, off = _read_varint(buf, 0)
                    if tag is None:
                        break
                    n, off = _read_varint(buf, off)
                except ValueError:
                    # unterminated varint: framing is lost for good on this
                    # buffer; drop it rather than wedge every later step
                    buf.clear()
                    self.stats["verified_bad"] += 1
                    break
                if n is None or off + n > len(buf):
                    break
                out.append((tag >> 3, bytes(buf[off: off + n])))
                del buf[: off + n]
        return out

    def _handle_block(self, payload: bytes, acc) -> None:
        r, p = _read_varint(payload, 0)
        src, p = _read_varint(payload, p)
        if r is None or src is None:
            return
        nbits, p = _read_varint(payload, p)
        if nbits is None or nbits != self.cfg.num_nodes:
            return
        nb = (nbits + 7) // 8
        edge_bytes = payload[p: p + nb]
        edges = np.unpackbits(np.frombuffer(edge_bytes, np.uint8),
                              count=nbits).astype(bool)
        p += nb
        ops, p = _get_bytes(payload, p)
        sig, p = _get_bytes(payload, p)
        if ops is None or sig is None:
            return
        if src not in self.keys:
            # key exchange not finished for this peer: park and retry
            # (bounded: _drain_inbox ages the park and drops it past the
            # retry budget)
            self._pending_blocks.append([int(r), int(src), payload, 0])
            return
        digest = self._digest_block(r, src, edge_bytes, ops)
        if not self._verify(int(src), digest, sig):
            self.stats["verified_bad"] += 1  # tampered/forged: drop
            self.log.warning("dropping tampered/forged block (round %d, "
                             "source %d)", r, src)
            return
        rows = self._decode_ops(ops)
        if rows is None:
            self.stats["verified_bad"] += 1
            return
        key = (int(r), int(src))
        prev = self._digests.get(key)
        if prev is not None:
            # the first block for (round, source) wins everywhere: a
            # second, differently signed copy is equivocation by the
            # creator; an identical re-send (query replay) carries nothing
            if prev != digest:
                self.stats["verified_bad"] += 1
                self.log.warning("equivocation: second distinct signed "
                                 "block for (round %d, source %d) dropped",
                                 r, src)
            return
        self.stats["verified_ok"] += 1  # counted once per admitted block
        self._digests[key] = digest
        # keep the frame for peer repair (block query replay)
        self._frames[key] = frame(payload, MSG_BLOCK_OPS)
        acc["blocks"].append((int(r), int(src), edges, rows))

    def _handle_sig(self, payload: bytes) -> None:
        r, p = _read_varint(payload, 0)
        src, p = _read_varint(payload, p)
        signer, p = _read_varint(payload, p)
        if r is None or src is None or signer is None:
            return
        sig, p = _get_bytes(payload, p)
        if sig is None:
            return
        self._pending_sigs.append([int(r), int(src), int(signer), sig, 0])

    def _handle_cert(self, payload: bytes) -> None:
        r, p = _read_varint(payload, 0)
        src, p = _read_varint(payload, p)
        cnt, p = _read_varint(payload, p)
        if r is None or src is None or cnt is None or cnt > self.cfg.num_nodes:
            return
        entries = []
        for _ in range(cnt):
            signer, p = _read_varint(payload, p)
            if signer is None:
                return
            sig, p = _get_bytes(payload, p)
            if sig is None:
                return
            entries.append((int(signer), sig))
        self._pending_certs.append([int(r), int(src), entries, 0])

    def _drain_inbox(self, acc) -> None:
        for mtype, payload in self._parse_frames():
            if mtype == MSG_INIT:
                v, p = _read_varint(payload, 0)
                pub, p = _get_bytes(payload, p)
                if v is not None and pub is not None and v not in self.keys:
                    self.keys[int(v)] = bytes(pub)
                    # answer so a later-starting peer still learns us
                    self.send(self._init_frames())
            elif mtype == MSG_BLOCK_OPS:
                self._handle_block(payload, acc)
            elif mtype == MSG_SIG:
                self._handle_sig(payload)
            elif mtype == MSG_CERT:
                self._handle_cert(payload)
            elif mtype == MSG_QUERY:
                r, p = _read_varint(payload, 0)
                src, p = _read_varint(payload, p)
                if r is not None and src is not None:
                    f = self._frames.get((int(r), int(src)))
                    if f:
                        self.send(f)
        # blocks parked for a creator key: retried each step, dropped once
        # their age blows the retry budget (the query-repair path can
        # refetch the block if the key ever arrives)
        if self._pending_blocks:
            parked, self._pending_blocks = self._pending_blocks, []
            for item in parked:
                r, src, payload, age = item
                if src in self.keys:
                    self._handle_block(payload, acc)
                elif age + 1 >= self.key_retry_budget:
                    self.stats["parked_dropped"] += 1
                    self.log.warning(
                        "dropping block parked for missing key (round "
                        "%d, source %d) after %d retries", r, src,
                        age + 1)
                else:
                    item[3] = age + 1
                    self._pending_blocks.append(item)

    def _settle_pending(self, acc) -> None:
        """Verify parked sigs/certs whose block digest is now known; query
        peers for blocks that stay missing (BlockQueryMessage repair,
        DAG.cs:612-621)."""
        base_round = self.kv.base_round()
        still: List[list] = []
        for item in self._pending_sigs:
            r, src, signer, sig, age = item
            if r < base_round:
                self.stats["stale_dropped"] += 1
                continue
            digest = self._digests.get((r, src))
            if digest is None:
                item[4] += 1
                if item[4] == self.QUERY_AFTER:
                    self.send(frame(_varint(r) + _varint(src), MSG_QUERY))
                    self.stats["queries"] += 1
                still.append(item)
                continue
            if not self._slot_ready(r):
                still.append(item)  # round ahead of the window: wait
                continue
            if self._verify(signer, digest, sig):
                self.stats["verified_ok"] += 1
                self._sig_store.setdefault((r, src), {})[signer] = sig
                acc["sigs"].append((r, src, signer))
            else:
                self.stats["verified_bad"] += 1
        self._pending_sigs = still

        still = []
        for item in self._pending_certs:
            r, src, entries, age = item
            if r < base_round:
                self.stats["stale_dropped"] += 1
                continue
            digest = self._digests.get((r, src))
            if digest is None:
                item[3] += 1
                if item[3] == self.QUERY_AFTER:
                    self.send(frame(_varint(r) + _varint(src), MSG_QUERY))
                    self.stats["queries"] += 1
                still.append(item)
                continue
            if not self._slot_ready(r):
                still.append(item)  # round ahead of the window: wait
                continue
            # quorum counts distinct verified signers: one key can mint
            # many distinct valid ECDSA signatures over one digest
            good = len({signer for signer, sig in set(entries)
                        if self._verify(signer, digest, sig)})
            if good >= self.cfg.quorum:
                self.stats["verified_ok"] += 1
                acc["certs"].append((r, src))
            else:
                self.stats["verified_bad"] += 1  # forged certificate
        self._pending_certs = still

    def _slot_ready(self, r: int) -> bool:
        """Does the live ring currently own logical round r?"""
        return self.kv._host_slot_round[r % self.cfg.num_rounds] == r

    def _ingest(self, acc) -> None:
        # park verified blocks whose round is ahead of the window (the slot
        # guard would drop them; they become ingestable once the frontier
        # advances) and revive previously parked ones
        base_round = self.kv.base_round()
        ready_blocks = []
        for r, s, e, rows in acc["blocks"]:
            if self._slot_ready(r):
                ready_blocks.append((r, s, e, rows))
            elif r >= base_round:
                self._parked_blocks.setdefault((r, s), (e, rows))
            else:
                self.stats["stale_dropped"] += 1
        for (r, s), (e, rows) in list(self._parked_blocks.items()):
            if r < base_round:
                del self._parked_blocks[(r, s)]
                self.stats["stale_dropped"] += 1
            elif self._slot_ready(r):
                del self._parked_blocks[(r, s)]
                ready_blocks.append((r, s, e, rows))
        acc["blocks"] = ready_blocks
        if not (ready_blocks or acc["sigs"] or acc["certs"]):
            return
        # a fresh block's op payload (the UpdateMessage content,
        # DAGUpdateMessage.cs:32-55) rides the same launch into the ring
        # row [r % W, src]
        w = self.cfg.num_rounds
        blocks = [(r, s, e, self._payload(rows)
                   if not self._prev_be[r % w, s] else None)
                  for r, s, e, rows in ready_blocks]
        dagmod.ingest_batch(self.cfg, self.kv.dag, self.owned_idx,
                            blocks=blocks, sigs=acc["sigs"],
                            certs=acc["certs"],
                            ring=(tuple(self.kv.ops_buffer[f]
                                        for f in self._field_order),
                                  self.kv.buffer_filled))

    def _payload(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """A block's op rows flattened in ring order."""
        return np.concatenate([np.asarray(rows[f], np.int32).reshape(-1)
                               for f in self._field_order])

    # -- outbound --------------------------------------------------------

    def _emit(self) -> None:
        dag = self.kv.dag
        n, w = self.cfg.num_nodes, self.cfg.num_rounds
        host = torch.cat([dag[f].reshape(-1) for f in _EMITTED]).cpu().numpy()
        cur_be, cur_acks, cur_ce, edges = (
            x.reshape(shape) for x, shape in zip(
                np.split(host, np.cumsum((w * n, w * n * n, w * n))),
                ((w, n), (w, n, n), (w, n), (w, n, n))))
        slot_round = self.kv._host_slot_round
        out = bytearray()

        new_own = [(int(s), int(v))
                   for s, v in zip(*np.nonzero(cur_be & ~self._prev_be))
                   if self.owned[v]]
        if new_own:
            # the payload is the device ring's row, not the host-passed
            # batch: effect capture (OR-Set remove tags, RGA counters)
            # mints the extra lanes during the submit on the device, and
            # replicas must replay exactly those. One gather per field and
            # one copy to the host.
            cells = torch.as_tensor([s * n + v for s, v in new_own],
                                    device=self.kv.device)
            flat = [self.kv.ops_buffer[f].reshape(w * n, -1)
                    .index_select(0, cells) for f in self._field_order]
            fetched = torch.cat(flat, 1).cpu().numpy()
            for i, (s, v) in enumerate(new_own):
                r = int(slot_round[s])
                ops_bytes = np.ascontiguousarray(fetched[i],
                                                 dtype="<i4").tobytes()
                edge_bytes = np.packbits(edges[s, v]).tobytes()
                digest = self._digest_block(r, v, edge_bytes, ops_bytes)
                key = (r, v)
                self._digests[key] = digest
                sig = self._sign(v, digest)
                # the creator's block signature doubles as its self-ack
                # (CreateBlock self-signature, DAG.cs:896-906)
                self._sig_store.setdefault(key, {})[v] = sig
                fr = self._encode_block(r, v, edges[s, v], ops_bytes, sig)
                self._frames[key] = fr
                out += fr

        for s, src, signer in zip(*np.nonzero(cur_acks & ~self._prev_acks)):
            if not self.owned[signer]:
                continue
            r = int(slot_round[s])
            digest = self._digests.get((r, int(src)))
            if digest is None:
                continue  # self-ack handled at creation
            sig = self._sign(int(signer), digest)
            self._sig_store.setdefault((r, int(src)), {})[int(signer)] = sig
            if not self.owned[src]:
                body = bytearray(_varint(r) + _varint(int(src))
                                 + _varint(int(signer)))
                _put_bytes(body, sig)
                out += frame(bytes(body), MSG_SIG)

        # certs we cannot yet prove (sig store lacking quorum at the
        # instant cert_exists flips) stay out of the prev snapshot, so
        # they are retried and peers do not miss them for good
        prev_ce_next = np.array(cur_ce, copy=True)
        for s, v in zip(*np.nonzero(cur_ce & ~self._prev_ce)):
            if not self.owned[v]:
                continue
            r = int(slot_round[s])
            sigs = self._sig_store.get((r, int(v)), {})
            signers = [int(t) for t in np.nonzero(cur_acks[s, v])[0]
                       if int(t) in sigs]
            if len(signers) < self.cfg.quorum:
                prev_ce_next[s, v] = False  # retry on a later step
                continue
            body = bytearray(_varint(r) + _varint(int(v))
                             + _varint(len(signers)))
            for t in signers:
                body += _varint(t)
                _put_bytes(body, sigs[t])
            out += frame(bytes(body), MSG_CERT)

        self._prev_be = cur_be
        self._prev_acks = cur_acks
        self._prev_ce = prev_ce_next
        if out:
            _C_TX_BYTES.add(len(out))
            self.send(bytes(out))

    def _gc_stores(self) -> None:
        base_round = self.kv.base_round()
        for store in (self._digests, self._sig_store, self._frames):
            for key in [k for k in store if k[0] < base_round]:
                del store[key]

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Broadcast this process's public keys (InitMessage barrier,
        DAGConnectionManager.StartDAG, :79-98)."""
        self.send(self._init_frames())

    def step(self, ops: Optional[base.OpBatch] = None,
             safe: Optional[np.ndarray] = None,
             record=None) -> Optional[dict]:
        """Drain + verify inbound, run one protocol round for the owned
        nodes, emit this step's new blocks/sigs/certs as one batched send.
        Returns SafeKV step info (accepted/own/recycled), or None while
        the key exchange is incomplete. ``record`` narrows which nodes'
        blocks enter latency stats (default: all owned)."""
        acc = {"blocks": [], "sigs": [], "certs": []}
        t_ing = _time.perf_counter_ns()
        self._drain_inbox(acc)
        if not self.ready:
            # a peer that is already ready may be sending real blocks; park
            # them (they verified): blocks are never re-broadcast, and the
            # query repair only fires for blocks whose digest is unknown
            for r, s, e, rows in acc["blocks"]:
                self._parked_blocks.setdefault((r, s), (e, rows))
            # bounded wait: keep retrying the init broadcast, and once the
            # budget blows report a degraded state
            self._key_wait_steps += 1
            if self._key_wait_steps >= self.key_retry_budget:
                missing = sorted(set(range(self.cfg.num_nodes))
                                 - set(self.keys))
                self.degraded_reason = (
                    f"key exchange incomplete after "
                    f"{self._key_wait_steps} steps "
                    f"(missing nodes {missing})")
            self.send(self._init_frames())
            return None
        if self.degraded_reason is not None or self._key_wait_steps:
            # exchange completed: clear the verdict and re-arm
            self.degraded_reason = None
            self._key_wait_steps = 0
        self._settle_pending(acc)
        self._ingest(acc)
        # measured wire-ingest leg: frame parse + signature verify +
        # batched DAG ingest for everything this step drained
        if acc["blocks"] or acc["sigs"] or acc["certs"]:
            _H_WIRE_INGEST.record(_time.perf_counter_ns() - t_ing)
        if ops is None:
            ops = self._idle
        if record is None:
            rec = self.owned
        elif record is False:
            rec = np.zeros_like(self.owned)
        else:
            rec = np.asarray(record, bool) & self.owned
        info = self.kv.step(ops, safe=safe, record=rec)
        self._emit()
        if info["recycled"].any():
            self._gc_stores()
        return info

    # -- owned-view API --------------------------------------------------

    def query_stable(self, name: str, *args):
        return self.kv.query_stable(name, *args)

    def query_prospective(self, name: str, *args):
        return self.kv.query_prospective(name, *args)

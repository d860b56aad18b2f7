"""Host-side block integrity plane: digests, signatures, verification
and invalid-block pruning for the emulated DAG (counterpart:
janus_tpu/consensus/integrity.py).

Every block carries a SHA-256 digest over round, source, its
previous-certificate set and its payload digest, signed by its creator
(ECDSA P-256); honest receivers verify before acking, and a block that
fails is pruned. Byzantine injection: a faulty node signs a tampered
digest at a configurable rate (the reference's invalid-certificate
experiment, paper Fig 11).

Crypto stays on the host (``net/binding.py``: the port's ``sha256.cc`` and
``ecdsa.cc``); the device round only takes the ``invalid[W, N]`` gate that
``dag.sign_blocks`` applies, so an invalid block is never acked by honest
nodes, never certifies or commits, and dies in its slot until GC recycles
it (``pruned_blocks`` reports them). Without libcrypto the plane signs
with a keyed SHA-256 hash (sig = SHA-256(key || digest)); the protocol
seam is the same.

``SecureCluster`` drives a SafeKV through the plane in two modes: a host
mirror of the DAG under full delivery (no fetch beyond the round's own),
or, for crash and withhold runs, reads of the DAG tensors before each
step. The port's round updates those tensors in place, so the reads are
copies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from janus_tpu_torch import convert
from janus_tpu_torch.consensus.dag import DagConfig
from janus_tpu_torch.net import binding


@dataclasses.dataclass
class Replica:
    """Per-node identity (Replica.cs:34-42). ``priv`` is DER for ECDSA
    or a 32-byte secret for the keyed-hash fallback."""

    node_id: int
    priv: bytes
    pub: bytes


class Committee:
    """Membership + verified public-key table (Committee.cs:11-57). In
    the reference keys arrive via InitMessage broadcast at startup
    (DAG.cs:142-145, 382-406); here the table is built at construction —
    the same trust model (keys exchanged before round 1)."""

    def __init__(self, replicas: List[Replica]):
        self.replicas = replicas
        self.keys: Dict[int, bytes] = {r.node_id: r.pub for r in replicas}

    def __len__(self) -> int:
        return len(self.replicas)


def generate_committee(n: int, seed: int = 0) -> Committee:
    """ECDSA P-256 keypair per replica (GenerateReplicas analog,
    Replica.cs:44-65); keyed-hash fallback without libcrypto."""
    rng = np.random.default_rng(seed)
    reps = []
    use_ecdsa = binding.ecdsa_available()
    for v in range(n):
        if use_ecdsa:
            priv, pub = binding.ecdsa_keygen()
        else:
            priv = rng.bytes(32)
            pub = priv  # symmetric fallback: verifier recomputes the MAC
        reps.append(Replica(v, priv, pub))
    return Committee(reps)


def _sign(priv: bytes, digest: bytes, use_ecdsa: bool) -> bytes:
    if use_ecdsa:
        return binding.ecdsa_sign(priv, digest)
    return binding.sha256(priv + digest)


def _verify(pub: bytes, digest: bytes, sig: bytes, use_ecdsa: bool) -> bool:
    if use_ecdsa:
        return binding.ecdsa_verify(pub, digest, sig)
    return binding.sha256(pub + digest) == sig


class IntegrityPlane:
    """Mirrors device-side block creation with real digests/signatures.

    Call ``round_created(dag_state_pre, ops_digests)`` right after
    observing which blocks the device created this round (in the
    synchronous emulation: every active node creates at its node_round),
    then feed ``invalid_mask()`` into the next ``tick``/``step`` so
    honest nodes never sign bad blocks.

    Byzantine injection: nodes in ``byzantine`` sign a *tampered* digest
    with probability ``invalid_rate`` — the signature does not match the
    block content, verification fails everywhere honest (the 50%%-invalid
    -certificate experiment, Tests/DAGTests.cs:1357; paper §6.2 Fig 11).
    """

    def __init__(self, cfg: DagConfig, committee: Optional[Committee] = None,
                 byzantine: Optional[np.ndarray] = None,
                 invalid_rate: float = 0.0, seed: int = 0):
        self.cfg = cfg
        self.committee = committee or generate_committee(cfg.num_nodes, seed)
        self.use_ecdsa = binding.ecdsa_available()
        self.byzantine = (np.zeros(cfg.num_nodes, bool)
                          if byzantine is None else np.asarray(byzantine, bool))
        self.invalid_rate = invalid_rate
        self._rng = np.random.default_rng(seed + 1)
        w, n = cfg.num_rounds, cfg.num_nodes
        # slot-indexed mirrors of the live window. The gate is
        # FAIL-CLOSED: a block the host never mirrored (e.g. created
        # right after a device-side state transfer moved its creator's
        # round, so the host prediction missed it) must not be acked —
        # verification-by-default-open would let tampered content certify
        # before the host catches up. An unmirrored honest block costs
        # one dropped block per recovery event, never safety.
        self._digest: Dict[Tuple[int, int], bytes] = {}   # (round, src)
        self._sig: Dict[Tuple[int, int], bytes] = {}
        self._invalid = np.zeros((w, n), bool)
        self._mirrored = np.zeros((w, n), bool)
        self._slot_round = np.arange(w, dtype=np.int64)
        self.pruned: List[Tuple[int, int]] = []  # invalid (round, src) log
        self.verified_ok = 0
        self.verified_bad = 0

    def block_digest(self, round_: int, source: int, prev_mask: np.ndarray,
                     ops_digest: bytes) -> bytes:
        """SHA-256 over round‖source‖prev-certificate-set‖payload digest
        (ComputeDigest, Block.cs:45-73). ``prev_mask`` is the block's
        edge row — in the tensor model the prev-cert *set* is the content
        the hash must cover; the referenced certificates' own digests are
        recoverable from it because (round-1, t) names a unique block."""
        prev_digests = b"".join(
            self._digest.get((round_ - 1, int(t)), b"\0" * 32)
            for t in np.nonzero(prev_mask)[0]
        )
        body = (int(round_).to_bytes(8, "little")
                + int(source).to_bytes(4, "little")
                + np.asarray(prev_mask, np.uint8).tobytes()
                + prev_digests + ops_digest)
        return binding.sha256(body)

    def round_created(self, rounds: np.ndarray, sources: np.ndarray,
                      edges: np.ndarray,
                      ops_digests: Optional[List[bytes]] = None) -> None:
        """Digest + sign the blocks created this round. ``rounds``/
        ``sources`` list the new blocks; ``edges[i]`` is block i's
        prev-cert mask; ``ops_digests[i]`` its payload digest."""
        cfg = self.cfg
        for i in range(len(sources)):
            r, s = int(rounds[i]), int(sources[i])
            slot = r % cfg.num_rounds
            if self._slot_round[slot] > r:
                continue  # stale phantom: never clobber a newer round's flags
            if self._slot_round[slot] < r:
                # slot rolls forward to a new round: previous round's
                # per-source flags are dead
                self._invalid[slot] = False
                self._mirrored[slot] = False
                self._slot_round[slot] = r
            if self._mirrored[slot, s]:
                continue  # already mirrored (signatures are immutable)
            od = ops_digests[i] if ops_digests is not None else b""
            digest = self.block_digest(r, s, edges[i], od)
            self._digest[(r, s)] = digest
            signed = digest
            if self.byzantine[s] and self._rng.random() < self.invalid_rate:
                # tampered content: signature over something else
                signed = binding.sha256(b"tampered" + digest)
            sig = _sign(self.committee.replicas[s].priv, signed, self.use_ecdsa)
            self._sig[(r, s)] = sig
            # honest receivers verify sig against the block they received
            ok = _verify(self.committee.keys[s], digest, sig, self.use_ecdsa)
            self._mirrored[slot, s] = True
            self._invalid[slot, s] = not ok
            if ok:
                self.verified_ok += 1
            else:
                self.verified_bad += 1
                self.pruned.append((r, s))

    def invalid_mask(self) -> np.ndarray:
        """bool[W, N] gate for dag.sign_blocks: proven-invalid OR
        never-mirrored blocks (fail-closed; irrelevant for slots with no
        block, since signing is gated on block_seen anyway)."""
        return self._invalid | ~self._mirrored

    def recycle(self, recycled: np.ndarray) -> None:
        """Drop mirrors for collected slots (pairs with dag.recycle)."""
        rec = np.asarray(recycled, bool)
        if not rec.any():
            return
        for slot in np.nonzero(rec)[0]:
            r = int(self._slot_round[slot])
            for s in range(self.cfg.num_nodes):
                self._digest.pop((r, s), None)
                self._sig.pop((r, s), None)
            self._invalid[slot] = False
            self._mirrored[slot] = False
            self._slot_round[slot] = r + self.cfg.num_rounds

    def pruned_blocks(self) -> List[Tuple[int, int]]:
        """All blocks whose verification failed, (round, source) — the
        PruneInvalidBlocks return (DAG.cs:258-297)."""
        return list(self.pruned)

    def equivocation_counts(self) -> Dict[int, int]:
        """Pruned-block count per source node — the health watchdog's
        per-node equivocation signal. A node whose signatures keep
        failing verification is either equivocating (signing content it
        didn't send) or compromised; either way liveness degrades as its
        blocks die unacked in their slots."""
        counts: Dict[int, int] = {}
        for _r, s in self.pruned:
            counts[s] = counts.get(s, 0) + 1
        return counts


class SecureCluster:
    """SafeKV + IntegrityPlane glue: drives the emulated cluster with
    real per-block digests/signatures and the honest-refusal gate.

    Two prediction modes for "which blocks does this tick create":

    - ``no_fetch=True`` (default): a host-side numpy mirror of the DAG's
      full-delivery evolution. Under full delivery with no crash or
      withhold masks, creation/certification/round-advance are exact
      functions of the invalid mask (which this plane itself generates)
      plus the GC feedback already present in every step's packed
      output — so the secure path adds ZERO device fetches and runs at
      the insecure path's dispatch rate.
    - ``no_fetch=False``: read the device tensors each step (4 fetches,
      copied: the step updates them in place) — required when callers
      inject ``active``/``withhold`` masks, whose delivery gating the
      lockstep mirror does not model.
    """

    def __init__(self, kv, plane: IntegrityPlane, no_fetch: bool = True):
        self.kv = kv
        self.plane = plane
        self.no_fetch = no_fetch
        cfg = kv.cfg
        w, n = cfg.num_rounds, cfg.num_nodes
        # lockstep mirror state (valid while no crash/withhold masks)
        self._m_base = 0
        self._m_round = np.zeros(n, np.int64)
        self._m_exists = np.zeros((w, n), bool)
        self._m_cert = np.zeros((w, n), bool)

    def _predict_no_fetch(self):
        """Predict this tick's creations from the mirror (and pre-apply
        the tick's cert/advance transitions, which under full delivery
        depend only on the invalid mask)."""
        cfg = self.kv.cfg
        w, n = cfg.num_rounds, cfg.num_nodes
        creating, rounds, edges = [], [], []
        for v in range(n):
            r = int(self._m_round[v])
            s = r % w
            if (self._m_base <= r < self._m_base + w
                    and not self._m_exists[s, v]):
                creating.append(v)
                rounds.append(r)
                edges.append(self._m_cert[(r - 1) % w].copy()
                             if r > 0 else np.zeros(n, bool))
        return (np.asarray(rounds), np.asarray(creating),
                np.stack(edges) if edges else np.zeros((0, n), bool))

    def _advance_mirror(self, rounds, creating, invalid, recycled):
        """Apply the tick's transitions: creations exist; valid blocks
        certify the same tick (every honest node signs under full
        delivery); rounds advance on cert quorum; GC recycle comes from
        the step's own packed output (no extra fetch)."""
        cfg = self.kv.cfg
        w, n = cfg.num_rounds, cfg.num_nodes
        for r, v in zip(rounds, creating):
            s = int(r) % w
            self._m_exists[s, v] = True
            self._m_cert[s, v] = not invalid[s, v]
        # round advance: quorum of certificates at the node's round
        for v in range(n):
            r = int(self._m_round[v])
            if (self._m_cert[r % w].sum() >= cfg.quorum
                    and r + 1 < self._m_base + w):
                self._m_round[v] = r + 1
        rec = np.asarray(recycled, bool)
        if rec.any():
            self._m_base += int(rec.sum())
            self._m_exists[rec] = False
            self._m_cert[rec] = False
            self._m_round = np.maximum(self._m_round, self._m_base)

    def step(self, ops, safe=None, active=None, withhold=None, **kw):
        kv, plane = self.kv, self.plane
        cfg = kv.cfg
        n = cfg.num_nodes
        if self.no_fetch:
            if active is not None or withhold is not None:
                raise ValueError(
                    "no_fetch mirror models full delivery only; build "
                    "SecureCluster(no_fetch=False) for crash/withhold runs")
            rounds, creating, edges = self._predict_no_fetch()
            plane.round_created(rounds, creating, edges)
            invalid = plane.invalid_mask()
            info = kv.step(ops, safe=safe, invalid=invalid, **kw)
            self._advance_mirror(rounds, creating, np.asarray(invalid),
                                 info["recycled"])
            plane.recycle(info["recycled"])
            return info
        act = (np.ones(n, bool) if active is None
               else convert.tree_to_numpy(active).astype(bool))
        # copies, not views: the step below updates these tensors in place
        pre_round = convert.tree_to_numpy(kv.dag["node_round"])
        base = int(convert.tree_to_numpy(kv.dag["base_round"]))
        exists = convert.tree_to_numpy(kv.dag["block_exists"])
        prev_certs = convert.tree_to_numpy(kv.dag["cert_seen"])
        # mirror exactly create_blocks' gate (dag.py in_window): skip
        # stale stragglers below the frontier and back-pressured rounds —
        # a phantom mirror at a wrong round must never touch live flags
        creating = [
            v for v in range(n)
            if act[v]
            and base <= pre_round[v] < base + cfg.num_rounds
            and not exists[pre_round[v] % cfg.num_rounds, v]
        ]
        rounds = pre_round[creating]
        edges = np.stack([
            prev_certs[v, (pre_round[v] - 1) % cfg.num_rounds]
            if pre_round[v] > 0 else np.zeros(n, bool)
            for v in creating
        ]) if creating else np.zeros((0, n), bool)
        plane.round_created(rounds, np.asarray(creating), edges)
        info = kv.step(ops, safe=safe, active=active, withhold=withhold,
                       invalid=plane.invalid_mask(), **kw)
        plane.recycle(info["recycled"])
        return info

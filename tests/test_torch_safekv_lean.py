"""The SafeKV round's two lean wrappers on the CPU: ``safekv_submit`` /
``safekv_board`` and ``gc_frontier`` (with the ring clear).

On CPU tensors each wrapper runs its plain version and counts no launch;
``gc_frontier`` gives exactly what ``gc_frontier_plain`` then
``gc_clear_ring_plain`` give (bit-equal, tolerance exactly 0). The
refusals of the card path (a wrong shape, dtype or layout, named by its
operand; more than 64 nodes, a window over 32, more than 16 ring fields)
are checked with stand-ins for card tensors: the operand checks
(``operands.lean_placement``, then ``operands.placement``) read only a
tensor's device, dtype, shape and contiguity, and every refusal comes
before a kernel is built or an address read.
"""
import numpy as np
import pytest
import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.consensus import DagConfig
from janus_tpu_torch.models.base import OP_FIELDS

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

N, W, B = 4, 8, 37


class CardStandIn:
    """A CPU tensor that the operand checks take for one on the card."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, x, contiguous=True):
        self.x, self.contiguous = x, contiguous
        self.dtype, self.shape = x.dtype, x.shape

    def is_contiguous(self):
        return self.contiguous

    def dim(self):
        return self.x.dim()

    def data_ptr(self):
        raise AssertionError("an address was read before the refusal")


def _rand(rng, shape, lo=-(2**31), hi=2**31 - 1):
    return torch.as_tensor(
        rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32))


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return torch.as_tensor(x)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def _equal(a, b, where="out"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _ring(rng, n=N, w=W, b=B, extras=4):
    ring = {f: _rand(rng, (w, n, b), -5, 50) for f in OP_FIELDS}
    ring.update({f: _rand(rng, (w, n, b, extras))
                 for f in ("rm_rep", "rm_ctr", "rm_elem")})
    return ring


def _submit_args(rng, n=N, w=W, b=B):
    d, _, _ = workloads.consensus_state(rng, n, w, wrap=True)
    dag = _tree(d)
    filled = torch.as_tensor(rng.random((w, n)) < 0.3)
    active = torch.as_tensor(rng.random(n) < 0.8)
    ops = {f: _rand(rng, (n, b)) for f in OP_FIELDS}
    return DagConfig(n, w), dag, filled, ops, active


def _gc_args(rng, n=N, w=W, logs=True):
    dag, com, before, pa, sa, bf = (_tree(x) for x in workloads.gc_state(
        rng, n, w, wrap=True))
    return (DagConfig(n, w), dag, com, before, pa, sa, bf,
            _rand(rng, (n,), -9, 99), torch.as_tensor(rng.random(n) < 0.7),
            torch.as_tensor(rng.random(n) < 0.2),
            torch.as_tensor(np.int32(rng.integers(0, n))),
            (_rand(rng, (n,)), None), logs)


def test_submit_and_board_on_cpu_run_plain():
    rng = np.random.default_rng(0)
    before = kernels.safekv_submit.launches
    args = _submit_args(rng)
    got = kernels.safekv_submit(*_clone(args))
    want = kernels.safekv_submit_plain(*_clone(args))
    _equal(got, want)
    acc_ops, accepted, pre = want
    ring = _ring(rng)
    captured = {f: acc_ops[f] if f in acc_ops else _rand(rng, x.shape[1:])
                for f, x in ring.items()}
    applied = torch.as_tensor(rng.random((N, W, N)) < 0.3)
    b_args = (args[0], ring, args[2], applied, captured, accepted, pre)
    mine, ref = _clone(b_args), _clone(b_args)
    assert kernels.safekv_board(*mine) is None
    kernels.safekv_board_plain(*ref)
    _equal(mine, ref)
    assert kernels.safekv_submit.launches == before


@pytest.mark.parametrize("logs", [True, False])
def test_gc_with_ring_on_cpu_is_frontier_then_clear(logs):
    """The GC with its ring clear against the two plain versions in
    turn, and against ``gc_round_plain``, on rounds whose frontier frees
    slots."""
    rng = np.random.default_rng(1 + logs)
    before = kernels.gc_frontier.launches
    freed = 0
    for _ in range(6):
        args = _gc_args(rng, logs=logs)
        ring = _ring(rng)
        mine, ref = _clone((args, ring)), _clone((args, ring))
        got = kernels.gc_frontier(*mine[0], ops_buffer=mine[1])
        want = kernels.gc_frontier_plain(*ref[0])
        kernels.gc_clear_ring_plain(args[0], ref[1], want[1])
        _equal(got, want)
        _equal(mine, ref, "in place")
        freed += int(want[1].sum())
        # the whole call's plain version
        whole = _clone((args, ring))
        _equal(kernels.gc_round_plain(*whole[0], whole[1]), want)
        _equal(whole, ref, "gc_round_plain in place")
    assert freed > 0
    assert kernels.gc_frontier.launches == before


def test_gc_without_ring_is_the_plain_frontier():
    """A ring of no fields: the frontier, the recycle and the pack
    alone."""
    rng = np.random.default_rng(3)
    args = _gc_args(rng, n=7, w=6, logs=False)
    mine, ref = _clone(args), _clone(args)
    _equal(kernels.gc_frontier(*mine, {}), kernels.gc_frontier_plain(*ref))
    _equal(mine, ref, "in place")


def _card(tree, wrong=None, how=None):
    """Stand-ins of a nest of tensors; the one named ``wrong`` made
    int64 (``how`` "dtype") or strided (``how`` "layout")."""
    def one(path, x):
        if isinstance(x, dict):
            return {k: one(f"{path}.{k}" if path else k, v)
                    for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(one(path, v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        if path == wrong and how == "dtype":
            return CardStandIn(x.to(torch.int64))
        return CardStandIn(x, contiguous=not (path == wrong
                                              and how == "layout"))
    return one("", tree)


@pytest.mark.parametrize("how", ["dtype", "layout"])
def test_submit_refusals_name_the_operand(how):
    rng = np.random.default_rng(4)
    cfg, dag, filled, ops, active = _submit_args(rng)
    for wrong, label in (("ops.key", "ops.key"),
                         ("node_round", "node_round")):
        fake = _card({"ops": ops, "node_round": dag["node_round"]}, wrong, how)
        dag_f = {**_card(dag), "node_round": fake["node_round"]}
        with pytest.raises(ValueError, match=f"safekv_submit: {label} must "
                                             f"be a contiguous"):
            kernels.safekv_submit(cfg, dag_f, _card(filled), fake["ops"],
                                  _card(active))
    acc_ops, accepted, pre = kernels.safekv_submit_plain(cfg, dag, filled,
                                                         ops, active)
    ring = _ring(rng)
    captured = {f: acc_ops[f] if f in acc_ops else _rand(rng, x.shape[1:])
                for f, x in ring.items()}
    fake = _card({"ops_buffer": ring, "acc_ops": captured}, "acc_ops.rm_ctr",
                 how)
    with pytest.raises(ValueError, match="safekv_board: acc_ops.rm_ctr must "
                                         "be a contiguous"):
        kernels.safekv_board(cfg, fake["ops_buffer"], _card(filled),
                             _card(torch.zeros((N, W, N), dtype=torch.bool)),
                             fake["acc_ops"], _card(accepted), _card(pre))


@pytest.mark.parametrize("how", ["dtype", "layout"])
def test_gc_refusals_name_the_operand(how):
    rng = np.random.default_rng(5)
    args = _gc_args(rng)
    cfg = args[0]
    ring = _ring(rng)
    fake = _card({"dag": args[1], "ring": ring}, "dag.cert_seen", how)
    with pytest.raises(ValueError, match="gc_frontier: cert_seen must be a "
                                         "contiguous"):
        kernels.gc_frontier(cfg, fake["dag"], *_card(args[2:]),
                            ops_buffer=_card(ring))
    fake = _card({"ring": ring}, "ring.a1", how)
    with pytest.raises(ValueError, match="gc_frontier: ops_buffer.a1 must "
                                         "be a contiguous"):
        kernels.gc_frontier(cfg, *_card(args[1:]), ops_buffer=fake["ring"])


def test_wrong_shapes_name_the_operand():
    rng = np.random.default_rng(6)
    cfg, dag, filled, ops, active = _submit_args(rng)
    with pytest.raises(ValueError, match=r"safekv_submit: buffer_filled has "
                                         r"shape \(4, 8\)"):
        kernels.safekv_submit(cfg, dag, filled.T.contiguous(), ops, active)
    args = _gc_args(rng)
    short = {**args[2], "commit_seq": args[2]["commit_seq"][:, :3]}
    with pytest.raises(ValueError, match="gc_frontier: commit_seq has shape"):
        kernels.gc_frontier(args[0], args[1], short, *args[3:],
                            _ring(rng))
    for fake in (False, True):  # the card path and the CPU path alike
        wrap = _card if fake else (lambda x: x)
        ring = _ring(rng)
        ring["a2"] = ring["a2"][:, :3]
        with pytest.raises(ValueError, match="ops_buffer.a2 has shape"):
            kernels.gc_frontier(*wrap(args), ops_buffer=wrap(ring))


def test_card_limits_are_refused():
    """More than 64 nodes, a window over 32, more than 16 ring fields."""
    rng = np.random.default_rng(7)
    with pytest.raises(ValueError, match="gc_frontier: 65 nodes"):
        kernels.gc_frontier(*_card(_gc_args(rng, n=65, w=4)), {})
    with pytest.raises(ValueError, match="gc_frontier: window 33, at most 32"):
        kernels.gc_frontier(*_card(_gc_args(rng, n=4, w=33)), {})
    args = _gc_args(rng)
    many = {f"f{i}": _rand(rng, (W, N, 2)) for i in range(17)}
    with pytest.raises(ValueError, match="gc_frontier: 17 ring fields, at "
                                         "most 16"):
        kernels.gc_frontier(*_card(args), ops_buffer=_card(many))
    with pytest.raises(ValueError, match="safekv_board: 17 ring fields"):
        kernels.safekv_board(args[0], many, None, None, None, None, None)


def test_ring_table_follows_a_replaced_ring():
    """The ring's cached table (``operands.ring_table``): the fields'
    addresses, then their slot rows' int32; the same table while the
    ring is the same tensors, a new one for a ring that replaced it (as
    ``SafeKV.resize_block`` replaces it)."""
    from janus_tpu_torch.kernels import operands

    rng = np.random.default_rng(8)
    ring = _ring(rng)
    table = operands.ring_table(ring)
    assert operands.ring_table(dict(ring)) is table
    xs = list(ring.values())
    assert list(table) == ([x.data_ptr() for x in xs]
                           + [x[0].numel() for x in xs])
    grown = {f: torch.zeros((W, N, B + 3) + x.shape[3:], dtype=torch.int32)
             for f, x in ring.items()}
    other = operands.ring_table(grown)
    assert other is not table
    assert list(other) == ([x.data_ptr() for x in grown.values()]
                           + [x[0].numel() for x in grown.values()])
    assert operands.ring_table(ring) is table

"""The Graph's and the 2P-Set's walk edge cases on the CPU: the port's
``kernels.graph_apply`` (captured and uncaptured) and
``kernels.graph_capture``, and ``tpset_apply`` / ``tpset_capture`` (their
plain versions, which run for CPU tensors) against JAX's
``graph._apply_ops_impl`` (with ``_op_gates``), ``tpset._apply_ops_impl``
and ``base.capture_and_apply`` with each type's ``prepare_ops``, vmapped
over the views, bit-equal (tolerance exactly 0): the state, the drops per
view and the captured ``ok``.

The cases come from ``workloads.graph_walk_case``: rows gathered by 1, 31,
32 and 33 lanes, one row gathered by more than a window of 2,048 lane
indices, rows only adds touch, self-loops and ids at INT32_MAX, full
blocks that drop, and keys in [-2K, 2K) with every op code from -1 to 5.
(A row without a vertex block, CV = 0, has no reference: JAX's
``row_upsert`` takes the argmax of an empty block there and raises, and so
does the plain version.) The card tests (``tests/test_torch_cuda.py``)
and ``chip_smoke.py`` reuse the generator to hold the kernel's walk
against the plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from janus_tpu.models import base as jax_base
from janus_tpu.models import graph as jax_graph
from janus_tpu.models import tpset as jax_tpset

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.kernels.graph_apply import OP_FIELDS, TP_OP_FIELDS

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.GRAPH_WALK_CASES
V, K, CV, CE, NV, B = 2, 64, 8, 24, 8, 2200

# the JAX functions, jitted so that each shape compiles once
J_APPLY = {"graph": jax.jit(jax.vmap(jax_graph._apply_ops_impl)),
           "tpset": jax.jit(jax.vmap(jax_tpset._apply_ops_impl))}
J_CAPTURE = {kind: jax.jit(jax.vmap(
    lambda st, o, s=spec: jax_base.capture_and_apply(s, st, o)))
    for kind, spec in (("graph", jax_graph.SPEC), ("tpset", jax_tpset.SPEC))}
PORT = {"graph": (kernels.graph_apply, kernels.graph_capture, OP_FIELDS),
        "tpset": (kernels.tpset_apply, kernels.tpset_capture, TP_OP_FIELDS)}


def _torch(tree):
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _assert_equal(got, want, where=""):
    got, want = convert.tree_to_numpy(got), convert.tree_to_numpy(want)
    if isinstance(want, dict):
        for f in want:
            _assert_equal(got[f], want[f], f"{where}.{f}")
        return
    x, y = np.asarray(got), np.asarray(want)
    assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype,
                                                       x.shape, y.shape)
    np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.mark.parametrize("mode", ["apply", "captured", "capture"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["graph", "tpset"])
def test_walk_matches_jax(kind, case, mode):
    """One batch of B = 2,200 lanes a view through the port and through
    JAX: the uncaptured apply, the captured apply (the case's ``ok``) and
    the capture (its ``ok``, then the same state and drops as the
    captured apply of what it captured)."""
    seed = 10 * CASES.index(case) + (kind == "graph")
    st, ops = workloads.graph_walk_case(np.random.default_rng(seed), case,
                                        V, K, CV, CE, NV, B,
                                        edges=kind == "graph")
    apply, capture, fields = PORT[kind]
    if mode != "captured":
        ops = {f: ops[f] for f in fields}
    mine = _torch(st)
    before = kernels.launches()
    if mode == "capture":
        want_st, prepared = J_CAPTURE[kind](st, ops)
        _, want_drop = J_APPLY[kind](st, prepared)
        ok, drop = capture(mine, _torch(ops))
        _assert_equal(ok, prepared["ok"], f"{case} ok")
        if case == "hazards":
            assert (ok == 0).any() and (ok == 1).any()
    else:
        want_st, want_drop = J_APPLY[kind](st, ops)
        drop = apply(mine, _torch(ops))
    assert kernels.launches() == before  # the CPU runs plain
    _assert_equal(mine, want_st, f"{case} {mode}")
    _assert_equal(drop, want_drop, f"{case} {mode} dropped")
    if case == "full":
        assert (np.asarray(want_drop) > 0).all()

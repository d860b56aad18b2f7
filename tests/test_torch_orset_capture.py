"""The OR-Set capture's edge cases on the CPU: the port's
``kernels.orset_capture`` (its plain version, which runs for CPU tensors)
and ``models.orset.prepare_ops_batch`` against JAX's
``orset.prepare_ops_batch`` vmapped over the views, bit-equal (tolerance
exactly 0).

The cases come from ``workloads.orset_capture_case``, which the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` reuse to hold the
kernel (adds bucketed by row, a warp a capture) against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import orset as jax_orset

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import orset
from janus_tpu_torch.ops.lattice import SENTINEL

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.ORSET_CAPTURE_CASES
FIELDS = ("tag_rep", "tag_ctr", "elem", "removed", "valid")
CAPTURED = ("rm_rep", "rm_ctr", "rm_elem")
GEOMETRIES = [  # (V, K, C, B, r_cap)
    (2, 6, 16, 300, 4),   # B past one 256-lane tile, not a multiple of it
    (1, 5, 8, 257, 32),   # the widest capture, r_cap > C
    (3, 4, 24, 96, 1),    # the narrowest
]

# JAX's batched capture per view, jitted so that each shape compiles once
J_CAPTURE = jax.jit(jax.vmap(jax_orset.prepare_ops_batch))


def _torch(tree):
    """Copies: JAX on the CPU may still be reading the same numpy memory
    (its dispatch is asynchronous)."""
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "V{}K{}C{}B{}r{}"
                         .format(*g))
@pytest.mark.parametrize("case", CASES)
def test_orset_capture_matches_prepare_ops_batch(case, geo):
    v, k, c, b, r_cap = geo
    rng = np.random.default_rng(CASES.index(case) * 10 + GEOMETRIES.index(geo))
    st, ops = workloads.orset_capture_case(rng, case, (v, b), k, c)
    st["_rm_cap"] = np.zeros((v, r_cap, 0), np.int32)
    want = J_CAPTURE({f: jnp.asarray(x) for f, x in st.items()},
                     {f: jnp.asarray(x) for f, x in ops.items()})
    want = {f: np.asarray(want[f]) for f in CAPTURED}
    got = kernels.orset_capture({f: _torch(st)[f] for f in FIELDS},
                                _torch(ops), r_cap)
    for f, x in zip(CAPTURED, got):
        np.testing.assert_array_equal(x.numpy(), want[f], err_msg=f)
    model = orset.prepare_ops_batch(_torch(st), _torch(ops))
    for f in CAPTURED:
        np.testing.assert_array_equal(convert.tree_to_numpy(model)[f], want[f],
                                      err_msg=f"model {f}")
    # the case reaches the batch prefix, not only the rows
    assert (want["rm_rep"] != SENTINEL).any()

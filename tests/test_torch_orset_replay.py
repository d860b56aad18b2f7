"""The OR-Set replay's edge cases on the CPU: the port's
``kernels.orset_replay`` (its plain version, which runs for CPU tensors)
and ``models.orset.apply_ops`` on captured batches against JAX's
``orset._apply_captured_batch`` vmapped over the views, bit-equal
(tolerance exactly 0): the new rows and the drops per view.

The cases come from ``workloads.orset_replay_case``: a hot key past its
bucket, rows whose state slots do not ascend, a tag four times across
state and ops, the INT32_MAX tag, every record on negative keys, keys past
the rows, rows filled exactly to C and one past it; at capture widths 1,
4 and 32. The card tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` reuse the generator to hold the kernel (op records
bucketed by row, merged into the sorted row) against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import orset as jax_orset

from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import orset

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.ORSET_REPLAY_CASES
FIELDS = ("tag_rep", "tag_ctr", "elem", "removed", "valid")
GEOMETRIES = [  # (V, K, C, B, r_cap)
    (2, 6, 8, 96, 4),
    (1, 5, 6, 64, 1),    # the narrowest capture
    (2, 4, 16, 80, 32),  # the widest, r_cap > C
]

# JAX's replay per view, jitted so that each shape compiles once
J_REPLAY = jax.jit(jax.vmap(jax_orset._apply_captured_batch))


def _torch(tree):
    """Copies: JAX on the CPU may still be reading the same numpy memory
    (its dispatch is asynchronous)."""
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "V{}K{}C{}B{}r{}"
                         .format(*g))
@pytest.mark.parametrize("case", CASES)
def test_orset_replay_matches_apply_captured_batch(case, geo):
    v, k, c, b, r_cap = geo
    rng = np.random.default_rng(CASES.index(case) * 10 + GEOMETRIES.index(geo))
    st, ops = workloads.orset_replay_case(rng, case, (v, b), k, c, r_cap)
    jst = {f: jnp.asarray(x) for f, x in st.items()}
    jst["_rm_cap"] = jnp.zeros((v, r_cap, 0), jnp.int32)
    want, want_drop = J_REPLAY(jst, {f: jnp.asarray(x) for f, x in ops.items()})
    got, drop = kernels.orset_replay({f: _torch(st)[f] for f in FIELDS},
                                     _torch(ops))
    for f in FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    np.testing.assert_array_equal(drop.numpy(), np.asarray(want_drop))
    # through the model's apply: the same rows and drops
    mst = _torch(st)
    mst["_rm_cap"] = torch.zeros((v, r_cap, 0), dtype=torch.int32)
    new, mdrop = orset._apply_ops_impl(mst, _torch(ops))
    for f in FIELDS:
        np.testing.assert_array_equal(new[f].numpy(), np.asarray(want[f]),
                                      err_msg=f"model {f}")
    np.testing.assert_array_equal(mdrop.numpy(), np.asarray(want_drop))


def test_orset_replay_cases_reach_their_edges():
    """Each case holds what it names, at the first geometry."""
    v, k, c, b, r_cap = GEOMETRIES[0]

    def case(name, seed=0):
        return workloads.orset_replay_case(np.random.default_rng(seed), name,
                                           (v, b), k, c, r_cap)

    st, ops = case("hot_key")
    assert (ops["key"] == 0).sum() >= 8 * b * v // 10
    st, _ = case("unsorted_rows")
    tag = st["tag_rep"].astype(np.int64) * 2**32 + st["tag_ctr"]
    valid = st["valid"]
    assert ((valid[..., 1:] & ~valid[..., :-1])
            | (valid[..., 1:] & valid[..., :-1] & (tag[..., 1:] < tag[..., :-1]))
            ).any()
    st, ops = case("sentinel_tags")
    big = np.iinfo(np.int32).max
    assert ((st["tag_rep"] == big) & (st["tag_ctr"] == big) & st["valid"]).any()
    assert ((ops["a1"] == big) & (ops["a2"] == big) & (ops["op"] == 1)).any()
    _, ops = case("negative_keys")
    assert (ops["key"] < 0).all()
    _, ops = case("past_rows")
    assert (ops["key"] >= k).mean() > 0.7
    st, ops = case("exact_fill")
    _, drop = kernels.orset_replay_plain(
        {f: torch.from_numpy(st[f]) for f in FIELDS}, _torch(ops))
    assert int(drop.sum()) > 0

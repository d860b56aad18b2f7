"""The RGA compaction's edge cases on the CPU: the port's
``kernels.rga_compact`` (its plain version, which runs for CPU tensors)
against JAX's ``rga.compact``, bit-equal (tolerance exactly 0).

The cases come from ``workloads.rga_compact_case``: sorted rows, whose
parent test the kernel makes by searching the row's ids, and rows with a
descent or an invalid slot mid-row, which it sorts; duplicate ids (every
equal slot is a parent), a valid SENTINEL id, self-parents, references to
invalid slots and to absent ids, dead interior chains; with and without a
protect mask, at C = 16, 300 and 1,024, into fresh tensors and in place,
and over no row at all. The card tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` reuse the generator to hold the kernel against the
plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.models import rga as jax_rga

from janus_tpu_torch import convert, kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import rga

# the suite's parallel test workers share the cores: one torch thread each
torch.set_num_threads(1)

CASES = workloads.RGA_COMPACT_CASES
LEAD = (3,)

# the JAX function, jitted so that each shape compiles once
J_COMPACT = jax.jit(jax_rga.compact)


def _jax_state(rows):
    st = {f: jnp.asarray(v) for f, v in rows.items()}
    st["_depth"] = jnp.zeros((1,), jnp.int32)  # carried through untouched
    st["ctr_floor"] = jnp.zeros((1,), jnp.int32)
    return st


def _torch(tree):
    """Copies: the port writes in place, and JAX on the CPU may still be
    reading the same numpy memory (its dispatch is asynchronous)."""
    return {f: torch.from_numpy(np.array(v)) for f, v in tree.items()}


def _want(rows, protect):
    out = J_COMPACT(_jax_state(rows),
                    None if protect is None else jnp.asarray(protect))
    return {f: np.asarray(out[f]) for f in rga.FIELDS}


def _assert_equal(got, want, where=""):
    got = convert.tree_to_numpy(got)
    for f in rga.FIELDS:
        assert got[f].dtype == want[f].dtype, (where, f)
        assert got[f].shape == want[f].shape, (where, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{where}.{f}")


@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("c", [16, 300, 1024])
@pytest.mark.parametrize("case", CASES)
def test_rga_compact_matches_jax(case, c, protect):
    """Fresh outputs, with and without the protect mask."""
    rows, prot = workloads.rga_compact_case(
        np.random.default_rng(CASES.index(case) * 10 + c), case, LEAD, c)
    prot = prot if protect else None
    want = _want(rows, prot)
    before = kernels.rga_compact.launches
    got = kernels.rga_compact(_torch(rows),
                              None if prot is None else torch.from_numpy(prot))
    assert kernels.rga_compact.launches == before  # the CPU runs plain
    _assert_equal(got, want, f"{case} C{c}")
    kept = want["valid"].sum()
    assert 0 < kept < rows["valid"].sum() or case == "sorted", case


@pytest.mark.parametrize("case", CASES)
def test_rga_compact_in_place_matches_jax(case):
    """``out`` aliasing ``rows`` (the model's compaction, in place), at
    C = 300 with the protect mask."""
    rows, prot = workloads.rga_compact_case(
        np.random.default_rng(100 + CASES.index(case)), case, LEAD, 300)
    want = _want(rows, prot)
    mine = _torch(rows)
    kernels.rga_compact(mine, torch.from_numpy(prot), out=mine)
    _assert_equal(mine, want, case)
    state = _torch(rows)
    state["ctr_floor"] = torch.zeros(LEAD, dtype=torch.int32)
    state["_depth"] = torch.zeros(LEAD + (4, 0), dtype=torch.int32)
    rga.compact(state, torch.from_numpy(prot))
    _assert_equal(state, want, f"{case} model")


def test_rga_compact_of_no_rows_matches_jax():
    """Zero rows of 16 slots: empty outputs of the right types."""
    rows, prot = workloads.rga_compact_case(np.random.default_rng(7),
                                            "sorted", (0,), 16)
    _assert_equal(kernels.rga_compact(_torch(rows), torch.from_numpy(prot)),
                  _want(rows, prot), "no rows")

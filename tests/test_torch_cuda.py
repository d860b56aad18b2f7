"""The hand kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports
nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is bit-equal (int32; tolerance exactly 0).
"""
import numpy as np
import pytest
import torch

from janus_tpu_torch import kernels
from janus_tpu_torch.bench import workloads
from janus_tpu_torch.models import pncounter
from janus_tpu_torch.runtime import engine, store

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda_device():
    """The card; decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


def _rand(rng, shape, lo=-(2**31), hi=2**31 - 1):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,w,b", [(5, 7, 5, 333), (4, 64, 16, 1024)])
def test_pnc_apply_kernel_matches_plain(cuda_device, r, k, w, b):
    """Duplicates, no-ops, keys/writers in [-size, 2*size), amounts near
    INT32_MAX (wraparound)."""
    rng = np.random.default_rng(7)
    state = {f: torch.from_numpy(_rand(rng, (r, k, w), lo=INT32_MAX - 1000))
             .to(cuda_device) for f in "pn"}
    ops = {
        "op": rng.integers(0, 4, (r, b)),
        "key": rng.integers(-k, 2 * k, (r, b)),
        "a0": rng.integers(INT32_MAX - 50, INT32_MAX, (r, b)),
        "a1": np.zeros((r, b)), "a2": np.zeros((r, b)),
        "writer": rng.integers(-w, 2 * w, (r, b)),
    }
    dops = workloads.ops_to_device(ops, cuda_device)
    ref = {f: v.clone() for f, v in state.items()}
    before = kernels.pnc_apply.launches
    kernels.pnc_apply(state["p"], state["n"], dops)
    kernels.pnc_apply_plain(ref["p"], ref["n"], dops)
    torch.cuda.synchronize()
    assert kernels.pnc_apply.launches == before + 1
    for f in "pn":
        assert torch.equal(state[f], ref[f])


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,w", [(5, 7, 9), (4, 16, 8), (1, 3, 3)])
def test_replica_join_kernel_matches_plain(cuda_device, r, k, w):
    """Odd R, a row length that is not a multiple of four (the scalar
    path) and one that is (the 16-byte vector path)."""
    rng = np.random.default_rng(r)
    st = {f: torch.from_numpy(_rand(rng, (r, k, w))).to(cuda_device) for f in "pn"}
    ref = {f: v.clone() for f, v in st.items()}
    before = kernels.replica_join.launches
    kernels.replica_join(st["p"], st["n"])
    kernels.replica_join_plain(ref["p"], ref["n"])
    torch.cuda.synchronize()
    assert kernels.replica_join.launches == before + 1
    for f in "pn":
        assert torch.equal(st[f], ref[f])


@pytest.mark.cuda
def test_tick_on_card_matches_tick_on_cpu(cuda_device):
    """The engine tick through both kernels equals the CPU tick (plain
    versions) over a few ticks."""
    rng = np.random.default_rng(3)
    r, k, b = 6, 40, 64
    batches = [workloads.pnc_uniform(rng, r, k, b) for _ in range(3)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        st = store.replicated_init(pncounter.SPEC, r, device=dev, num_keys=k,
                                   num_writers=r)
        tick = engine.make_tick(pncounter.SPEC, device=dev)
        for ops in batches:
            st = tick(st, workloads.ops_to_device(ops, dev))
        out[dev.type] = {f: v.cpu() for f, v in st.items()}
    for f in "pn":
        assert torch.equal(out["cuda"][f], out["cpu"][f])


@pytest.mark.cuda
def test_wrappers_refuse_mixed_devices(cuda_device):
    p = torch.zeros((2, 3, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.replica_join(p, p.cpu())
    ops = {f: torch.zeros((2, 5), dtype=torch.int32) for f in
           ("op", "key", "a0", "writer")}
    with pytest.raises(ValueError):
        kernels.pnc_apply(p, p.clone(), ops)
    # a field with fewer columns than ``op`` would be read past its end
    ops = {f: v.to(cuda_device) for f, v in ops.items()}
    ops["key"] = ops["key"][:, :4].contiguous()
    with pytest.raises(ValueError, match="'key'"):
        kernels.pnc_apply(p, p.clone(), ops)


@pytest.mark.cuda
def test_safekv_on_card_matches_safekv_on_cpu(cuda_device):
    """SafeKV for the PN-Counter (submit and delta-apply through
    ``pnc_apply``) at N=4, window 8, 64-op blocks, 16 keys, with node 3
    crashed for rounds 5-9: every device tensor and the packed output
    bit-equal, round by round, between the card and the CPU."""
    from janus_tpu_torch import convert
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.runtime import safecrdt

    n, w, b, k = 4, 8, 64, 16
    rng = np.random.default_rng(12)
    kvs = {dev.type: safecrdt.SafeKV(DagConfig(n, w), pncounter.SPEC,
                                     ops_per_block=b, device=dev,
                                     num_keys=k, num_writers=n)
           for dev in (cuda_device, torch.device("cpu"))}
    before = kernels.pnc_apply.launches
    for t in range(20):
        ops = workloads.pnc_uniform(rng, n, k, b)
        safe = rng.random((n, b)) < 0.5
        active = np.array([True] * 3 + [not 5 <= t < 10])
        packed = {}
        for name, kv in kvs.items():
            packed[name], meta = kv.step_dispatch(
                workloads.ops_to_device(ops, kv.device), safe, active=active)
            kv.step_absorb(packed[name], meta)
        assert torch.equal(packed["cuda"].cpu(), packed["cpu"])
        st = {name: convert.tree_to_numpy(
            {f: getattr(kv, f) for f in safecrdt.DEVICE_FIELDS})
            for name, kv in kvs.items()}
        _assert_trees_equal(st["cuda"], st["cpu"], f"round {t}")
    assert kernels.pnc_apply.launches == before + 3 * 20
    assert kvs["cuda"].stats == kvs["cpu"].stats
    assert kvs["cuda"].stats["state_transfers"] > 0


def _assert_trees_equal(a, b, where):
    assert a.keys() == b.keys(), where
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key], f"{where}.{key}")
        else:
            assert a[key].dtype == b[key].dtype, (where, key)
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{where}.{key}")

"""The port stands alone: it imports without JAX and loads nothing of the
JAX package, and its entry points refuse to run when no GPU is present
unless the caller asks for the CPU."""
import subprocess
import sys
import textwrap

import pytest
import torch

MODULES = (
    "janus_tpu_torch",
    "janus_tpu_torch.device",
    "janus_tpu_torch.convert",
    "janus_tpu_torch.ops",
    "janus_tpu_torch.ops.lattice",
    "janus_tpu_torch.ops.setops",
    "janus_tpu_torch.utils",
    "janus_tpu_torch.utils.ids",
    "janus_tpu_torch.models",
    "janus_tpu_torch.models.base",
    "janus_tpu_torch.models.pncounter",
    "janus_tpu_torch.models.orset",
    "janus_tpu_torch.models.rga",
    "janus_tpu_torch.kernels",
    "janus_tpu_torch.kernels.build",
    "janus_tpu_torch.kernels.pnc_apply",
    "janus_tpu_torch.kernels.replica_join",
    "janus_tpu_torch.kernels.operands",
    "janus_tpu_torch.kernels.tusk_commit",
    "janus_tpu_torch.kernels.causal_closure",
    "janus_tpu_torch.kernels.dag_round",
    "janus_tpu_torch.kernels.dag_phases",
    "janus_tpu_torch.kernels.leader",
    "janus_tpu_torch.kernels.orset_rows",
    "janus_tpu_torch.kernels.slot_union",
    "janus_tpu_torch.kernels.orset_capture",
    "janus_tpu_torch.kernels.orset_replay",
    "janus_tpu_torch.kernels.orset_apply",
    "janus_tpu_torch.kernels.dirty_rows",
    "janus_tpu_torch.kernels.delta_select",
    "janus_tpu_torch.kernels.rga_rows",
    "janus_tpu_torch.kernels.rga_union",
    "janus_tpu_torch.kernels.rga_apply",
    "janus_tpu_torch.kernels.rga_compact",
    "janus_tpu_torch.kernels.rga_order",
    "janus_tpu_torch.kernels.safekv_submit",
    "janus_tpu_torch.kernels.block_select",
    "janus_tpu_torch.kernels.state_transfer",
    "janus_tpu_torch.kernels.gc_frontier",
    "janus_tpu_torch.obs",
    "janus_tpu_torch.obs.metrics",
    "janus_tpu_torch.obs.stages",
    "janus_tpu_torch.utils.perf",
    "janus_tpu_torch.runtime",
    "janus_tpu_torch.runtime.store",
    "janus_tpu_torch.runtime.engine",
    "janus_tpu_torch.runtime.safecrdt",
    "janus_tpu_torch.consensus",
    "janus_tpu_torch.consensus.dag",
    "janus_tpu_torch.consensus.tusk",
    "janus_tpu_torch.bench",
    "janus_tpu_torch.bench.workloads",
    "janus_tpu_torch.bench.harness",
)


def test_port_imports_without_jax_and_loads_no_jax_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None  # any import of jax now fails
        for name in {MODULES!r}:
            importlib.import_module(name)
        loaded = [m for m in sys.modules
                  if m == "janus_tpu" or m.startswith("janus_tpu.")
                  or m == "jax" and sys.modules[m] is not None
                  or m.startswith("jax.") or m.startswith("jaxlib")]
        assert not loaded, loaded
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no GPU, ``device=None`` raises instead of running on the CPU;
    ``device="cpu"`` is the only way onto the CPU."""
    from janus_tpu_torch import resolve_device
    from janus_tpu_torch.consensus import DagConfig
    from janus_tpu_torch.models import orset, pncounter, rga
    from janus_tpu_torch.runtime import engine, store
    from janus_tpu_torch.runtime.safecrdt import SafeKV

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_tick(pncounter.SPEC, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_local_tick(pncounter.SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.replicated_init(pncounter.SPEC, 2, num_keys=4, num_writers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SafeKV(DagConfig(4, 8), pncounter.SPEC, ops_per_block=4,
               num_keys=4, num_writers=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_tick(orset.SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SafeKV(DagConfig(4, 8), orset.SPEC, ops_per_block=4, num_keys=4,
               capacity=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_delta_tick(orset.SPEC, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.Store(2, {"pnc": dict(num_keys=4, num_writers=2)},
                    dirty_budget=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_tick(rga.SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rga.init(num_keys=4, capacity=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.replicated_init(rga.SPEC, 2, num_keys=4, capacity=8,
                              max_depth=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    SafeKV(DagConfig(4, 8), pncounter.SPEC, ops_per_block=4, device="cpu",
           num_keys=4, num_writers=4)
    store.Store(2, {"orset": dict(num_keys=4, capacity=4)}, device="cpu")
    store.Store(2, {"rga": dict(num_keys=4, capacity=4, max_depth=2)},
                device="cpu")

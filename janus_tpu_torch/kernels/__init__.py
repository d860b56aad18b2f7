"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and with a launch counter (``<wrapper>.launches``). A row-list
mode of a kernel (``replica_join_rows``, ``slot_union_rows``,
``rga_union_rows``) is a wrapper of its own, with its own counter, over
the same source; so is the RGA instantiation of ``slot_union.cu``
(``rga_union``). A source with two entry points counts both on one
wrapper: ``safekv_board`` on ``safekv_submit``, ``gc_clear_ring`` on
``gc_frontier``.

Sources live in ``janus_tpu_torch/csrc/``; ``build`` compiles them with
``nvcc`` on first use. Nothing here imports or builds anything at import
time.
"""

from janus_tpu_torch.kernels.block_select import (  # noqa: F401
    block_select, block_select_plain)
from janus_tpu_torch.kernels.causal_closure import (  # noqa: F401
    causal_closure, causal_closure_plain)
from janus_tpu_torch.kernels.dag_round import dag_round, dag_round_plain  # noqa: F401
from janus_tpu_torch.kernels.delta_select import (  # noqa: F401
    delta_select, delta_select_plain)
from janus_tpu_torch.kernels.dirty_rows import (  # noqa: F401
    dirty_rows, dirty_rows_plain)
from janus_tpu_torch.kernels.gc_frontier import (  # noqa: F401
    gc_clear_ring, gc_clear_ring_plain, gc_frontier, gc_frontier_plain)
from janus_tpu_torch.kernels.orset_apply import (  # noqa: F401
    orset_apply, orset_apply_plain)
from janus_tpu_torch.kernels.orset_capture import (  # noqa: F401
    orset_capture, orset_capture_plain)
from janus_tpu_torch.kernels.orset_replay import (  # noqa: F401
    orset_replay, orset_replay_plain)
from janus_tpu_torch.kernels.pnc_apply import pnc_apply, pnc_apply_plain  # noqa: F401
from janus_tpu_torch.kernels.rga_apply import rga_apply, rga_apply_plain  # noqa: F401
from janus_tpu_torch.kernels.rga_compact import (  # noqa: F401
    rga_compact, rga_compact_plain)
from janus_tpu_torch.kernels.rga_order import rga_order, rga_order_plain  # noqa: F401
from janus_tpu_torch.kernels.rga_union import (  # noqa: F401
    rga_union, rga_union_plain, rga_union_rows, rga_union_rows_plain)
from janus_tpu_torch.kernels.replica_join import (  # noqa: F401
    replica_join, replica_join_plain, replica_join_rows,
    replica_join_rows_plain)
from janus_tpu_torch.kernels.safekv_submit import (  # noqa: F401
    safekv_board, safekv_board_plain, safekv_submit, safekv_submit_plain)
from janus_tpu_torch.kernels.slot_union import (  # noqa: F401
    slot_union, slot_union_plain, slot_union_rows, slot_union_rows_plain)
from janus_tpu_torch.kernels.state_transfer import (  # noqa: F401
    state_transfer, state_transfer_plain)
from janus_tpu_torch.kernels.tusk_commit import (  # noqa: F401
    tusk_commit, tusk_commit_plain)

WRAPPERS = {"pnc_apply": pnc_apply, "replica_join": replica_join,
            "tusk_commit": tusk_commit, "causal_closure": causal_closure,
            "dag_round": dag_round, "slot_union": slot_union,
            "orset_capture": orset_capture, "orset_replay": orset_replay,
            "orset_apply": orset_apply, "dirty_rows": dirty_rows,
            "delta_select": delta_select,
            "replica_join_rows": replica_join_rows,
            "slot_union_rows": slot_union_rows, "rga_union": rga_union,
            "rga_union_rows": rga_union_rows, "rga_apply": rga_apply,
            "rga_compact": rga_compact, "rga_order": rga_order,
            "safekv_submit": safekv_submit, "block_select": block_select,
            "state_transfer": state_transfer, "gc_frontier": gc_frontier}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}

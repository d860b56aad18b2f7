"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and with a launch counter (``<wrapper>.launches``). A row-list
mode of a kernel (``replica_join_rows``, ``slot_union_rows``,
``rga_union_rows``, ``lww_union_rows``, ``tp_union_rows``,
``edge_union_rows``, ``mvr_merge_rows``) is a wrapper of its own, with its
own counter, over the same source; so are the RGA's, the LWW-Set's and the
two tombstone layouts' instantiations of ``slot_union.cu`` (``rga_union``,
``lww_union``, ``tp_union`` for the 2P-Set and the Graph's vertices,
``edge_union`` for the Graph's edges). A source with two entry points counts both on one
wrapper: ``safekv_board`` on ``safekv_submit``, ``orset_watermark`` and
``orset_compact_fences`` on ``orset_compact``. The capture
mode of ``rga_apply.cu`` is a wrapper of its own, ``rga_capture``; so
are those of ``lww_apply.cu``, ``mvr_apply.cu`` and ``graph_apply.cu``
(``lww_capture``, ``mvr_capture``, ``graph_capture``). The 2P-Set's apply
and capture are ``graph_apply.cu``'s walk with no edge block, wrappers of
their own (``tpset_apply``, ``tpset_capture``). The split mode of
``dag_round`` (``owned`` given) is an instantiation of ``dag_round.cu``
counted on ``dag_round``.

Sources live in ``janus_tpu_torch/csrc/``; ``build`` compiles them with
``nvcc`` on first use. Nothing here imports or builds anything at import
time.
"""

from janus_tpu_torch.kernels.block_select import (  # noqa: F401
    block_select, block_select_plain)
from janus_tpu_torch.kernels.causal_closure import (  # noqa: F401
    causal_closure, causal_closure_plain)
from janus_tpu_torch.kernels.dag_ingest import (  # noqa: F401
    dag_ingest, dag_ingest_plain)
from janus_tpu_torch.kernels.dag_round import dag_round, dag_round_plain  # noqa: F401
from janus_tpu_torch.kernels.delta_select import (  # noqa: F401
    delta_select, delta_select_plain)
from janus_tpu_torch.kernels.dirty_rows import (  # noqa: F401
    dirty_rows, dirty_rows_plain)
from janus_tpu_torch.kernels.edge_mask import (  # noqa: F401
    edge_mask, edge_mask_plain)
from janus_tpu_torch.kernels.gc_frontier import (  # noqa: F401
    gc_clear_ring_plain, gc_frontier, gc_frontier_plain, gc_round_plain)
from janus_tpu_torch.kernels.graph_apply import (  # noqa: F401
    graph_apply, graph_apply_plain, graph_capture, graph_capture_plain,
    tpset_apply, tpset_apply_plain, tpset_capture, tpset_capture_plain,
    walk_occupancy)
from janus_tpu_torch.kernels.lww_apply import (  # noqa: F401
    lww_apply, lww_apply_plain, lww_capture, lww_capture_plain)
from janus_tpu_torch.kernels.mark_members import (  # noqa: F401
    mark_members, mark_members_plain)
from janus_tpu_torch.kernels.mvr_apply import (  # noqa: F401
    mvr_apply, mvr_apply_plain, mvr_capture, mvr_capture_plain)
from janus_tpu_torch.kernels.mvr_merge import (  # noqa: F401
    mvr_merge, mvr_merge_plain, mvr_merge_rows, mvr_merge_rows_plain)
from janus_tpu_torch.kernels.orset_apply import (  # noqa: F401
    orset_apply, orset_apply_plain)
from janus_tpu_torch.kernels.orset_compact import (  # noqa: F401
    orset_compact, orset_compact_fences, orset_compact_fences_plain,
    orset_compact_plain, orset_watermark, orset_watermark_plain)
from janus_tpu_torch.kernels.orset_capture import (  # noqa: F401
    orset_capture, orset_capture_plain)
from janus_tpu_torch.kernels.orset_replay import (  # noqa: F401
    orset_replay, orset_replay_plain)
from janus_tpu_torch.kernels.pnc_apply import pnc_apply, pnc_apply_plain  # noqa: F401
from janus_tpu_torch.kernels.rga_apply import (  # noqa: F401
    rga_apply, rga_apply_plain, rga_capture, rga_capture_plain)
from janus_tpu_torch.kernels.rga_compact import (  # noqa: F401
    rga_compact, rga_compact_plain)
from janus_tpu_torch.kernels.rga_order import rga_order, rga_order_plain  # noqa: F401
from janus_tpu_torch.kernels.ring_resize import (  # noqa: F401
    ring_resize, ring_resize_plain)
from janus_tpu_torch.kernels.rga_union import (  # noqa: F401
    rga_union, rga_union_plain, rga_union_rows, rga_union_rows_plain)
from janus_tpu_torch.kernels.replica_join import (  # noqa: F401
    replica_join, replica_join_plain, replica_join_rows,
    replica_join_rows_plain)
from janus_tpu_torch.kernels.safekv_submit import (  # noqa: F401
    safekv_board, safekv_board_plain, safekv_submit, safekv_submit_plain)
from janus_tpu_torch.kernels.slot_union import (  # noqa: F401
    edge_union, edge_union_plain, edge_union_rows, edge_union_rows_plain,
    lww_union, lww_union_plain, lww_union_rows, lww_union_rows_plain,
    slot_union, slot_union_plain, slot_union_rows, slot_union_rows_plain,
    tp_union, tp_union_plain, tp_union_rows, tp_union_rows_plain)
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
            "state_transfer": state_transfer, "gc_frontier": gc_frontier,
            "orset_compact": orset_compact, "rga_capture": rga_capture,
            "mark_members": mark_members, "lww_union": lww_union,
            "lww_union_rows": lww_union_rows, "lww_apply": lww_apply,
            "lww_capture": lww_capture, "mvr_merge": mvr_merge,
            "mvr_merge_rows": mvr_merge_rows, "mvr_apply": mvr_apply,
            "mvr_capture": mvr_capture, "tp_union": tp_union,
            "tp_union_rows": tp_union_rows, "edge_union": edge_union,
            "edge_union_rows": edge_union_rows, "tpset_apply": tpset_apply,
            "tpset_capture": tpset_capture, "graph_apply": graph_apply,
            "graph_capture": graph_capture, "edge_mask": edge_mask,
            "dag_ingest": dag_ingest, "ring_resize": ring_resize}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}

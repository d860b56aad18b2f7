"""DAG mempool (Narwhal-style) + Tusk wave commit as tensor programs
(counterpart: janus_tpu/consensus)."""

from janus_tpu_torch.consensus.dag import (  # noqa: F401
    DagConfig,
    advance_rounds,
    create_blocks,
    deliver_blocks,
    deliver_certificates,
    form_certificates,
    init,
    recycle,
    round_step,
    sign_blocks,
    slot_of,
    structural_validity,
)
from janus_tpu_torch.consensus.tusk import (  # noqa: F401
    commit_view,
    init_commit,
    leader_of,
    leaders,
    order_key,
    ordered_blocks,
    recycle_commit,
)

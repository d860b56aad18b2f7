"""OR-Set tag minting (counterpart: janus_tpu/utils/ids.py ``TagMinter``).

Tags are dense int32 ``(replica, counter)`` pairs, minted per replica in
increasing counter order, and every id stays below ``ops.SENTINEL`` (the
empty-slot marker).
"""
from __future__ import annotations

import numpy as np

from janus_tpu_torch.ops.lattice import SENTINEL

_MAX_ID = int(SENTINEL) - 1


class TagMinter:
    """Mints unique ``(replica, counter)`` tag pairs for OR-Set adds; the
    counter starts at 1, so ``(0, 0)`` never collides with a zero fill."""

    def __init__(self, replica_id: int) -> None:
        self.replica_id = int(replica_id)
        self._next = 1

    def mint(self) -> tuple[int, int]:
        ctr = self._next
        self._next += 1
        if ctr > _MAX_ID:
            raise OverflowError("tag counter exhausted")
        return self.replica_id, ctr

    def mint_many(self, n: int) -> np.ndarray:
        """[n, 2] int32 array of (replica, counter) tags."""
        if self._next + n - 1 > _MAX_ID:
            raise OverflowError("tag counter exhausted")
        out = np.empty((n, 2), np.int32)
        out[:, 0] = self.replica_id
        out[:, 1] = np.arange(self._next, self._next + n, dtype=np.int32)
        self._next += n
        return out

"""State carried across from the JAX package.

Both packages keep state as nested dicts of arrays, so a state is handed
over as numpy: ``tree_to_numpy`` accepts torch tensors and any array that
``np.asarray`` reads (JAX arrays included, without importing JAX), and
``tree_from_numpy`` puts the arrays on a device as tensors with the same
dtype and shape.
"""
from __future__ import annotations

import numpy as np
import torch

from janus_tpu_torch.device import resolve_device


def tree_to_numpy(tree):
    """Nested dict of tensors or arrays -> same nesting of numpy arrays
    (copies; a 0-dim leaf stays a 0-dim array)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree, copy=True)


def tree_from_numpy(tree, device=None):
    """Nested dict of arrays -> same nesting of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def load_store(store, states, dirty) -> None:
    """Continue a run in the port's ``runtime.store.Store``: replace its
    per-type ``states`` and ``dirty`` masks with ``states`` and ``dirty``
    (``{type_code: ...}`` of arrays, e.g. a JAX ``Store``'s attributes of
    the same names), on the store's device."""
    for tc in store.states:
        store.states[tc] = tree_from_numpy(tree_to_numpy(states[tc]),
                                           store.device)
        store.dirty[tc] = tree_from_numpy(tree_to_numpy(dirty[tc]),
                                          store.device)

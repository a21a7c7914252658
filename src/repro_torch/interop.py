"""Parameter exchange with the reference package, through numpy.

``jax.random``'s threefry stream cannot be reproduced in torch, so parity
runs start both packages from the same exported parameters.  The reference
keeps nested dicts (``{"fc1": {"w": ..., "b": ...}, ...}``); the port keeps
flat dicts with dotted names (``{"fc1.w": ..., "fc1.b": ...}``).  Nothing here
imports jax: the caller converts jax arrays with ``numpy.asarray`` (for
example ``jax.tree.map(np.asarray, tree)``).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, *, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat dict of tensors, values copied exactly."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, f"{prefix}{key}.")
        else:
            out[prefix[:-1]] = torch.as_tensor(np.array(node), device=device)

    walk(tree, "")
    return out


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """Flat dict of tensors -> nested dict of numpy arrays (the reference's tree)."""
    tree: dict = {}
    for name, value in params.items():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree

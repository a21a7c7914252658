"""Parameter and state exchange with the reference package, through numpy.

``jax.random``'s threefry stream cannot be reproduced in torch, so parity
runs start both packages from the same exported parameters, or from the
same exported round state (``state_from_jax``).  The reference
keeps nested dicts (``{"fc1": {"w": ..., "b": ...}, ...}``); the port keeps
flat dicts with dotted names (``{"fc1.w": ..., "fc1.b": ...}``).  Nothing here
imports jax: the caller converts jax arrays with ``numpy.asarray`` (for
example ``jax.tree.map(np.asarray, tree)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import p2p
from repro_torch.core import task as task_lib


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


def state_from_jax(
    jstate, task: task_lib.TrainTask, *, device: torch.device | str = "cpu"
) -> p2p.P2PState:
    """A reference ``P2PState`` whose arrays were converted to numpy
    (``jax.tree.map(np.asarray, state)``) -> the port's ``P2PState``.

    Every state tree becomes one (K, row) buffer in ``ParamLayout`` order,
    the public-estimate tree of a compressed wire (``compression``) included,
    so both packages can run a phase from one state.  Gossip only: a
    protocol state (push-sum's mass) is queue 1 item 8b.
    """
    if jstate.protocol != ():
        raise NotImplementedError(
            "protocol state (push-sum) is not ported yet: ROADMAP.md queue 1 item 8b"
        )
    layout = p2p.ParamLayout.of(task)

    def flat(tree):
        return layout.flatten(params_from_jax(tree)).to(device)

    comp = jstate.compression
    return p2p.P2PState(
        params=flat(jstate.params),
        momentum=flat(jstate.momentum),
        d_bias=flat(jstate.d_bias),
        b_bias=flat(jstate.b_bias),
        round_idx=int(jstate.round_idx),
        compression=flat(comp) if isinstance(comp, dict) else (),
    )

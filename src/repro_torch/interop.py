"""Parameter and state exchange with the reference package, through numpy.

Parameter initialisation draws from ``jax.random`` in the reference and from
``torch.Generator`` in the port, so parity runs start both packages from the
same exported parameters, or from the same exported round state
(``state_from_jax``).  The reference
keeps nested dicts (``{"fc1": {"w": ..., "b": ...}, ...}``); the port keeps
flat dicts with dotted names (``{"fc1.w": ..., "fc1.b": ...}``).  Nothing here
imports jax: the caller converts jax arrays with ``numpy.asarray`` (for
example ``jax.tree.map(np.asarray, tree)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import p2p, protocols
from repro_torch.core import task as task_lib


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit.  ``np.asarray`` of a jax bf16
    array is an ``ml_dtypes.bfloat16`` array, which torch does not take: its
    bits are carried through an int16 view."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def _array_of(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, bit for bit (bf16 as ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bf16 type, as jax uses it; needed only here

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: dict, *, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat dict of tensors, values copied
    exactly (bf16 included): ``{"layers": {"time_mix": {"w_r": ...}}}`` ->
    ``{"layers.time_mix.w_r": ...}``, layer-stacked leaves as they are."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, f"{prefix}{key}.")
        else:
            out[prefix[:-1]] = _tensor_of(np.array(node)).to(device)

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
        node[leaf] = _array_of(value)
    return tree


def key_from_jax(key) -> torch.Tensor:
    """A reference uint32 threefry key (``np.asarray`` of a ``PRNGKey`` or
    of a stack of them) -> the port's int64 tensor of the same values."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32:
        raise ValueError(f"a threefry key is uint32, got {arr.dtype}")
    return torch.as_tensor(arr.astype(np.int64))


def key_to_jax(key: torch.Tensor) -> np.ndarray:
    """The port's int64 key -> the reference's uint32 values (numpy)."""
    arr = key.detach().cpu().numpy()
    if arr.min(initial=0) < 0 or arr.max(initial=0) > 0xFFFFFFFF:
        raise ValueError("a threefry key holds uint32 values")
    return arr.astype(np.uint32)


def flat_from_jax(
    tree: dict, task: task_lib.TrainTask, *, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """A reference stacked parameter tree ((K, ...) numpy leaves, e.g. the
    reference's ``P2PState.params`` of a decoder) -> the port's (K, row)
    buffer of ``task``'s layout, in the task's type (``ParamLayout.dtype``:
    a bf16 model's exported bf16 leaves carried bit for bit).  A task of
    mixed leaf types has two buffers, and raises: take
    ``ParamLayout.flatten_blocks`` of ``params_from_jax(tree)``."""
    layout = p2p.ParamLayout.of(task)
    if layout.wide is not None:
        raise ValueError(f"{task.name}'s leaves are of two types in two buffers "
                         "(ParamLayout.flatten_blocks)")
    return layout.flatten(params_from_jax(tree)).to(device)


def state_from_jax(
    jstate, task: task_lib.TrainTask, *, device: torch.device | str = "cpu"
) -> p2p.P2PState:
    """A reference ``P2PState`` whose arrays were converted to numpy
    (``jax.tree.map(np.asarray, state)``) -> the port's ``P2PState``.

    Every state tree becomes one (K, row) buffer in ``ParamLayout`` order,
    the public-estimate tree of a compressed wire (``compression``) included,
    so both packages can run a phase from one state.  Push-sum's state, a
    ``PushSumState`` whose ``mass`` is a (K,) array, becomes the port's
    ``protocols.PushSumState`` with the same float32 values.  The
    bounded-staleness buffer, a ``StalenessState``, becomes the port's
    ``p2p.StalenessState``: the published tree flattened to one (K, row)
    buffer, the (K,) ages as int32.  Adaptive selection's ``AdaptiveState``
    becomes the port's: the (K, 2) uint32 key as int64 values
    (``key_from_jax``; ``key_to_jax`` turns it back), the (K,) float32
    last losses as they are.  A task of mixed leaf types gets both blocks:
    its float32 leaves of every tree in ``P2PState.wide``.
    """
    layout = p2p.ParamLayout.of(task)

    def blocks(tree) -> list[torch.Tensor]:  # one buffer a block: a mixed task's two
        return [b.to(device) for b in layout.flatten_blocks(params_from_jax(tree))]

    def flat(tree):
        return blocks(tree)[0]

    comp = jstate.compression
    proto = jstate.protocol
    if proto != ():
        proto = protocols.PushSumState(
            mass=torch.as_tensor(np.asarray(proto.mass, dtype=np.float32)).to(device))
    adaptive = jstate.adaptive
    if adaptive != ():
        adaptive = p2p.AdaptiveState(
            key=key_from_jax(adaptive.key).to(device),
            last_losses=torch.as_tensor(np.array(adaptive.last_losses, dtype=np.float32))
            .to(device))
    stale = jstate.staleness
    if stale != ():
        stale = p2p.StalenessState(
            published=flat(stale.published),
            age=torch.as_tensor(np.array(stale.age, dtype=np.int32)).to(device))
    wide = ()
    if layout.wide is not None:
        wide = p2p.WideState(
            *(blocks(getattr(jstate, f))[1] for f in ("params", "momentum", "d_bias", "b_bias")),
            compression=blocks(comp)[1] if isinstance(comp, dict) else (),
            published=blocks(jstate.staleness.published)[1] if stale != () else ())
    return p2p.P2PState(
        params=flat(jstate.params),
        momentum=flat(jstate.momentum),
        d_bias=flat(jstate.d_bias),
        b_bias=flat(jstate.b_bias),
        round_idx=int(jstate.round_idx),
        protocol=proto,
        adaptive=adaptive,
        compression=flat(comp) if isinstance(comp, dict) else (),
        staleness=stale,
        wide=wide,
    )

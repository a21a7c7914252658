"""Communication compression for the consensus phase (the port's
``repro.compression.compressors``).

Instead of gossiping raw float32 parameters, each peer broadcasts a
compressed payload that every receiver applies to a persistent *public
estimate* of the sender's parameters (CHOCO-SGD 1902.00340, Sparse-Push
2102.05715).  Every node, the sender included, carries the same estimate
stack ``x̂`` (``P2PState.compression``: one (K, row) buffer, warm-started as a
copy of the parameters).  Each consensus step the sender ships ``C(x - x̂)``
and everyone advances ``x̂ <- x̂ + D(C(x - x̂))``.  The un-shipped part
``x - x̂`` is the error-feedback residual: it stays in the next difference and
is compressed again, so the estimate converges to the parameters.

Three compressors, one registry:

    none  — the identity: the runtime takes the exact uncompressed path
            (``identity = True``) and carries no estimate.
    topk  — per-leaf top-k magnitude sparsification: keep the ``frac``
            largest-|value| coordinates of each flattened leaf difference,
            ties to the lower index; payload = (values float32, indices
            int64) with a leading peer axis.
    qint8 — symmetric per-leaf int8 quantization of the difference: one
            float32 scale per peer and leaf (``max|diff| / 127``) plus an
            int8 tensor; the error per coordinate is at most ``scale / 2``.

Leaves are the task's parameter leaves, reached through ``ParamLayout.views``
of the flat (K, row) buffers: a scale or a top-k set never spans two leaves
or the row's zero padding.  Everything here is plain PyTorch; on the card
``ef_flat``'s quantize and top-k passes run as PyTorch ops (the reference
runs them as ``jnp`` outside any Pallas kernel), and the int8 advance is fused
into the ``dequant_mix`` kernel that consumes the payload.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RawPayload(NamedTuple):
    """The uncompressed message (compressor="none"): the leaf itself, flat."""

    values: torch.Tensor  # (K, N) float32


class TopKPayload(NamedTuple):
    """Top-k sparsification: the kept coordinates of each flattened leaf."""

    values: torch.Tensor  # (K, M) float32 — signed values at the kept slots
    indices: torch.Tensor  # (K, M) int64 — flat coordinate of each kept slot


class QInt8Payload(NamedTuple):
    """Symmetric int8 quantization with one float32 scale per peer row."""

    q: torch.Tensor  # (K, N) int8
    scale: torch.Tensor  # (K, 1) float32 — max|h| / 127 per row


class FlatPayload(NamedTuple):
    """One error-feedback step over a flat (K, row) stack, leaf by leaf.

    ``est`` is the estimate stack the mix reads as it stands: already advanced
    (top-k scatters its payload in), or not yet (qint8 leaves the advance
    ``est + scale * q`` to the consumer, which fuses it into the mix).
    ``q`` is (K, row) int8, zero outside the leaves; ``scale`` is (K, L)
    float32, one column per leaf.  Both are ``None`` for top-k.
    """

    est: torch.Tensor
    q: torch.Tensor | None
    scale: torch.Tensor | None


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    """(K, ...) leaf -> (K, N) float32 working view."""
    return leaf.to(torch.float32).reshape(leaf.shape[0], -1)


class Compressor:
    """One leaf-compression rule; stateless apart from the carried estimate."""

    name: str = "base"
    # the identity makes the runtime take the exact uncompressed code path
    identity: bool = False

    def init_estimate(self, params: torch.Tensor) -> torch.Tensor | tuple:
        """The public-estimate stack carried in ``P2PState.compression``:
        a copy of the (K, row) parameters, ``()`` for the identity.
        Warm-starting at the parameters means payloads only ever carry
        training drift, which starts at zero."""
        if self.identity:
            return ()
        return params.clone()

    def compress(self, leaf: torch.Tensor) -> NamedTuple:
        """(K, ...) leaf -> payload NamedTuple of tensors with leading K axis."""
        raise NotImplementedError

    def decompress(self, payload: NamedTuple, like: torch.Tensor) -> torch.Tensor:
        """Payload -> its dense value, shaped ``(K,) + like.shape[1:]``."""
        raise NotImplementedError

    def ef_flat(self, x: torch.Tensor, est: torch.Tensor, layout) -> FlatPayload:
        """Compress ``x - est`` over flat (K, row) stacks, leaf by leaf through
        ``layout.views`` (a ``core.p2p.ParamLayout``): ``receive`` of
        ``wire``."""
        return self.receive(est, self.wire(x, est, layout), layout)

    def wire(self, x: torch.Tensor, est: torch.Tensor, layout) -> list[torch.Tensor]:
        """What the rows of (K', row) stacks ship: the payload's tensors, each
        with a leading row axis (the sharded runtime all-gathers a rank's
        one row of each)."""
        raise NotImplementedError

    def receive(self, est: torch.Tensor, shipped: list[torch.Tensor], layout) -> FlatPayload:
        """The ``FlatPayload`` of the estimate stack ``est`` and the rows'
        shipped tensors (``wire``'s, one row a peer of ``est``)."""
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity: the runtime bypasses compression entirely (``identity = True``).

    ``compress``/``decompress`` are still real (the flat float32 leaf as
    payload) so tests can treat every compressor alike.
    """

    name = "none"
    identity = True

    def compress(self, leaf: torch.Tensor) -> RawPayload:
        return RawPayload(values=_flat(leaf))

    def decompress(self, payload: RawPayload, like: torch.Tensor) -> torch.Tensor:
        k = payload.values.shape[0]
        return payload.values.reshape((k,) + tuple(like.shape[1:])).to(like.dtype)


class TopKCompressor(Compressor):
    """Per-leaf top-k magnitude sparsification (Sparse-Push / CHOCO style)."""

    name = "topk"

    def __init__(self, frac: float = 0.01):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {frac}")
        self.frac = float(frac)

    def keep(self, n: int) -> int:
        """Kept coordinates for a leaf of N features (>= 1; Python's round)."""
        return max(1, int(round(self.frac * n)))

    def compress(self, leaf: torch.Tensor) -> TopKPayload:
        flat = _flat(leaf)
        # largest |value| first, equal magnitudes in index order, as
        # lax.top_k orders them (torch.topk leaves ties unspecified, and a
        # tie at the boundary would keep another coordinate than the
        # reference); the payload carries the SIGNED values
        order = torch.sort(flat.abs(), dim=1, descending=True, stable=True).indices
        idx = order[:, : self.keep(flat.shape[1])]
        return TopKPayload(values=flat.gather(1, idx), indices=idx)

    def decompress(self, payload: TopKPayload, like: torch.Tensor) -> torch.Tensor:
        k = payload.values.shape[0]
        n = like[0].numel()
        out = payload.values.new_zeros(k, n).scatter_(1, payload.indices, payload.values)
        return out.reshape((k,) + tuple(like.shape[1:])).to(like.dtype)

    def wire(self, x: torch.Tensor, est: torch.Tensor, layout) -> list[torch.Tensor]:
        """Each leaf's kept values and their indices, in the layout's order:
        [values_0, indices_0, values_1, ...]."""
        out = []
        for diff in layout.views(x - est).values():
            payload = self.compress(diff)
            out += [payload.values, payload.indices]
        return out

    def receive(self, est: torch.Tensor, shipped: list[torch.Tensor], layout) -> FlatPayload:
        """Advance a copy of ``est`` by each leaf's payload: ``est + D(C(x - est))``,
        with the top-k indices distinct per row so the scatter-add adds each
        kept value once.  A bf16 stack takes the difference and the sum in
        bf16, as the reference's ``ef_compress_leaf`` does (the kept values
        are the bf16 difference's own, so the cast back is exact)."""
        new = est.clone()
        for i, leaf in enumerate(layout.views(new).values()):
            values, indices = shipped[2 * i], shipped[2 * i + 1]
            leaf.view(est.shape[0], -1).scatter_add_(1, indices, values.to(new.dtype))
        return FlatPayload(est=new, q=None, scale=None)


class QInt8Compressor(Compressor):
    """Symmetric per-leaf int8 quantization with a float32 scale lane."""

    name = "qint8"

    def compress(self, leaf: torch.Tensor) -> QInt8Payload:
        flat = _flat(leaf)
        # times the float32 reciprocal, not a division: the reference's jitted
        # rounds compute max|h| / 127 so (XLA rewrites a division by a
        # constant), and a scale one ulp off flips round(h / scale) at ties
        scale = flat.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0)  # (K, 1)
        safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))  # zero row -> q = 0
        # torch.round, like jnp.round, rounds half to even
        q = torch.clamp(torch.round(flat / safe), -127.0, 127.0).to(torch.int8)
        return QInt8Payload(q=q, scale=scale)

    def decompress(self, payload: QInt8Payload, like: torch.Tensor) -> torch.Tensor:
        k = payload.q.shape[0]
        out = payload.q.to(torch.float32) * payload.scale
        return out.reshape((k,) + tuple(like.shape[1:])).to(like.dtype)

    def wire(self, x: torch.Tensor, est: torch.Tensor, layout) -> list[torch.Tensor]:
        """Each leaf's (q, scale) in one (K, row) int8 buffer and a (K, L)
        scale table.  ``q`` is allocated zeroed, so the row's padding
        columns carry q = 0."""
        q = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
        q_leaves = layout.views(q)
        scales = []
        for name, diff in layout.views(x - est).items():
            payload = self.compress(diff)
            q_leaves[name].view(x.shape[0], -1).copy_(payload.q)
            scales.append(payload.scale)
        return [q, torch.cat(scales, dim=1).contiguous()]

    def receive(self, est: torch.Tensor, shipped: list[torch.Tensor], layout) -> FlatPayload:
        """``est`` as it is (the consumer advances it by ``q * scale``)."""
        q, scale = shipped
        return FlatPayload(est=est, q=q, scale=scale)


# ---------------------------------------------------------------------------
# Error feedback (estimate tracking) over named leaves
# ---------------------------------------------------------------------------


def ef_compress_leaf(
    comp: Compressor, x: torch.Tensor, est: torch.Tensor
) -> tuple[NamedTuple, torch.Tensor]:
    """One estimate-tracking compression of a leaf: the payload is
    ``C(x - est)`` and everyone advances the estimate by its decompression.
    Returns ``(payload, est + D(payload))``."""
    payload = comp.compress(x - est)
    return payload, est + comp.decompress(payload, x)


def ef_compress_tree(
    comp: Compressor, params: dict[str, torch.Tensor], est: dict[str, torch.Tensor]
) -> tuple[list, dict[str, torch.Tensor]]:
    """``ef_compress_leaf`` over a dict of stacked leaves; payloads in the
    dict's order."""
    payloads, new = [], {}
    for name, x in params.items():
        payload, new[name] = ef_compress_leaf(comp, x, est[name])
        payloads.append(payload)
    return payloads, new


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[Compressor]] = {}


def register_compressor(cls: type[Compressor]) -> type[Compressor]:
    """Add a compressor class to the registry (name must be unique)."""
    if not cls.name or cls.name == "base":
        raise ValueError("compressor needs a distinct name")
    if cls.name in _REGISTRY:
        raise ValueError(f"compressor {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def compressor_names() -> tuple[str, ...]:
    """Registered compressor names, in registration order."""
    return tuple(_REGISTRY)


def get_compressor(name: str, *, topk_frac: float = 0.01) -> Compressor:
    """Instantiate a registered compressor (``topk`` takes its kept fraction)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown compressor {name!r}; one of {compressor_names()}") from None
    if cls is TopKCompressor:
        return cls(topk_frac)
    return cls()


def from_config(cfg) -> Compressor:
    """The config's compressor (needs ``.compressor`` and ``.topk_frac``)."""
    return get_compressor(cfg.compressor, topk_frac=cfg.topk_frac)


register_compressor(NoneCompressor)
register_compressor(TopKCompressor)
register_compressor(QInt8Compressor)

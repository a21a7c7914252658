"""Distributed average-consensus (gossip) operators over stacked peers (the
port's ``repro.core.consensus``: the vmap runtime's half, and the one-device
case of the hierarchical runtime's slot forms).

Three forms of the same op out_k = sum_j W[k, j] x_j on a (K, N) flat buffer:

1. **Dense** (``mix_stacked``, ``mix_leaf`` for one (K, ...) leaf): one
   (K, K) @ (K, N) product in float32 — the reference round's form, kept
   here as the test oracle for the sparse path.
2. **Sparse padded-neighbor** (``sparse_mixing``): host-side (self_w,
   nbr_idx, nbr_w) rows that feed the fused ``consensus_mix`` kernel, which
   the port's round runs (``repro_torch.kernels.consensus_mix.ops``).
3. **Slot sums** (``ring_gather_slots``, ``mix_slots``, ``slot_sum``): the
   degree-bounded form of the hierarchical runtime's "segment" mode, the
   plain version of the ``segment_mix`` kernel.  Each sums the D slots in
   slot order, in float32, as the kernel does.  ``scatter_rows`` turns
   padded slot rows back into a dense block.
"""
from __future__ import annotations

import numpy as np
import torch


def mix_leaf(w_mat: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """out_k = sum_j W[k, j] leaf_j over the leading peer axis of a (K, ...)
    leaf, accumulated in float32 and cast back to the leaf's type."""
    out = w_mat.to(torch.float32) @ leaf.to(torch.float32).reshape(leaf.shape[0], -1)
    return out.reshape(w_mat.shape[0], *leaf.shape[1:]).to(leaf.dtype)


def mix_stacked(w_mat: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """W @ flat over the leading peer axis, float32 accumulation, cast back."""
    return mix_leaf(w_mat, flat)


def mixing_degrees(w_mat: np.ndarray) -> np.ndarray:
    """Per-peer neighbor count of a dense mixing matrix: off-diagonal nonzeros."""
    off_diag = w_mat - np.diag(np.diag(w_mat))
    return (off_diag != 0).sum(axis=1)


def sparse_mixing(
    w_mat: np.ndarray, *, dmax: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert a dense mixing matrix to padded (self_w, nbr_idx, nbr_w).

    nbr_idx: (K, Dmax) int32, padded with the peer's own index (weight 0).
    ``dmax`` overrides the padding width.
    """
    k = w_mat.shape[0]
    off_diag = w_mat - np.diag(np.diag(w_mat))
    deg = mixing_degrees(w_mat)
    need = max(int(deg.max()), 1) if k else 1
    if dmax is None:
        dmax = need
    elif dmax < need:
        raise ValueError(f"dmax={dmax} below the actual max degree {need}")
    nbr_idx = np.tile(np.arange(k, dtype=np.int32)[:, None], (1, dmax))
    nbr_w = np.zeros((k, dmax), dtype=np.float32)
    for i in range(k):
        nbrs = np.nonzero(off_diag[i])[0]
        nbr_idx[i, : len(nbrs)] = nbrs
        nbr_w[i, : len(nbrs)] = off_diag[i, nbrs]
    self_w = np.diag(w_mat).astype(np.float32)
    return self_w, nbr_idx, nbr_w


def scatter_rows(
    nbr_idx: torch.Tensor,  # (p, D) int — global column indices per row
    nbr_w: torch.Tensor,  # (p, D) weights (0.0 at padding slots)
    num_peers: int,
    *,
    row_ids: torch.Tensor | None = None,  # (p,) global row indices
    self_w: torch.Tensor | None = None,  # (p,) diagonal values, if any
) -> torch.Tensor:
    """Scatter padded sparse rows into a dense (p, K) float32 weight block.

    Real slots place their weight at (row, idx); padding slots (idx == the
    row's own global index, weight 0.0) add +-0.0 onto the diagonal entry,
    so the block equals the dense matrix block the rows were extracted from.
    """
    p = nbr_idx.shape[0]
    rows = torch.arange(p, device=nbr_idx.device)
    block = torch.zeros((p, num_peers), dtype=torch.float32, device=nbr_idx.device)
    if self_w is not None:
        if row_ids is None:
            raise ValueError("self_w placement needs the global row_ids")
        block[rows, row_ids.long()] = self_w.to(torch.float32)
    idx = nbr_idx.long()
    return block.index_put_((rows[:, None].expand_as(idx), idx), nbr_w.to(torch.float32),
                            accumulate=True)


def ring_gather_slots(x_block: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Neighbor rows by global index: (p, D, ...) from a (p, ...) block and
    (p, D) indices.

    The one-device case of the reference's ring gather: the block is every
    peer, so the gather is a local take ``x[nbr_idx]``.  Streaming the
    blocks of several devices around a ring is ROADMAP.md queue 1 item 15.
    """
    return x_block[nbr_idx.long()]


def mix_slots(
    self_w: torch.Tensor,  # (p,)
    nbr_w: torch.Tensor,  # (p, D)
    x_block: torch.Tensor,  # (p, ...)
    gathered: torch.Tensor,  # (p, D, ...) from ring_gather_slots
) -> torch.Tensor:
    """out_i = self_w[i] x_i + sum_d nbr_w[i, d] gathered[i, d], accumulated
    from the self term through slots 0..D-1 in float32, cast back."""
    feat = (1,) * (x_block.dim() - 1)
    nbr_w = nbr_w.to(torch.float32)
    out = self_w.to(torch.float32).reshape(-1, *feat) * x_block.to(torch.float32)
    for slot in range(nbr_w.shape[1]):
        out = out + nbr_w[:, slot].reshape(-1, *feat) * gathered[:, slot].to(torch.float32)
    return out.to(x_block.dtype)


def slot_sum(nbr_w: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """out_i = sum_d nbr_w[i, d] gathered[i, d] (the affinity-beta form, no
    self term), accumulated through slots 0..D-1 in float32, cast back."""
    feat = (1,) * (gathered.dim() - 2)
    nbr_w = nbr_w.to(torch.float32)
    out = torch.zeros(gathered[:, 0].shape, dtype=torch.float32, device=gathered.device)
    for slot in range(nbr_w.shape[1]):
        out = out + nbr_w[:, slot].reshape(-1, *feat) * gathered[:, slot].to(torch.float32)
    return out.to(gathered.dtype)


def max_norm_sync(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """All peers adopt, per leaf, the initialization with the largest L2 norm
    (P2PL's initialization, Ref. [6]); ties go to the lowest peer index."""

    def leaf(x):
        k = x.shape[0]
        norms = torch.sqrt(torch.sum(torch.square(x.to(torch.float32).reshape(k, -1)), dim=1))
        return x[int(torch.argmax(norms))].expand_as(x).clone()

    return {name: leaf(x) for name, x in stacked.items()}


def consensus_error(flat: torch.Tensor) -> torch.Tensor:
    """Model drift metric: mean_k ||w_k - w_bar||_2 (f32)."""
    xf = flat.to(torch.float32)
    return torch.sqrt(torch.sum(torch.square(xf - xf.mean(dim=0, keepdim=True)), dim=1)).mean()


def pairwise_drift(flat: torch.Tensor, *blocks: torch.Tensor) -> torch.Tensor:
    """Max over peer pairs of ||w_i - w_j||_2 — the paper's drift/divergence —
    over the rows of ``flat`` and of any further (K, ...) ``blocks`` (a mixed
    task's float32 block), in float32."""
    sq = None
    for block in (flat, *blocks):
        xf = block.to(torch.float32)
        # ||x_i - x_j||^2 = ||x_i||^2 + ||x_j||^2 - 2 x_i . x_j
        n2 = torch.sum(xf * xf, dim=1)
        term = n2[:, None] + n2[None, :] - 2.0 * (xf @ xf.T)
        sq = term if sq is None else sq + term
    return torch.sqrt(torch.clamp(sq, min=0.0)).max()

"""Distributed average-consensus (gossip) operators over stacked peers (the
port's ``repro.core.consensus``: the vmap runtime's half, and the
hierarchical runtime's slot forms).

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
   slot order, in float32, as the kernel does.  ``ring_gather_slots``
   gathers the neighbor rows of a block of peers, from the block alone on
   one device or around the ring of a ``core.peer_group.PeerGroup``.  ``scatter_rows`` turns
   padded slot rows back into a dense block.  ``mix_sparse`` is the padded
   form's plain mix.

The collective forms (``gather_peer_leaf``, ``gather_peer_rows``,
``mix_psum``, ``mix_ring``, ``mix_collective``) run in one rank of the
sharded runtime, with a ``core.peer_group.PeerGroup`` in place of the
reference's ``axis_name``: each takes the rank's (1, ...) block (or a tree
of them) and returns the rank's block of the stacked result, which equals
its row of ``mix_stacked``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.graph import PermLane


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


def mix_sparse(self_w: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
               stacked) -> object:
    """out_k = self_w[k] x_k + sum_d nbr_w[k, d] x[nbr_idx[k, d]] on every
    (K, ...) leaf of ``stacked`` (a tensor or a tree), float32, cast back."""

    def leaf(x):
        xf = x.to(torch.float32)
        feat = (1,) * (x.dim() - 1)
        gathered = xf[nbr_idx.long()]  # (K, D, ...)
        out = self_w.to(torch.float32).reshape(-1, *feat) * xf + torch.sum(
            nbr_w.to(torch.float32).reshape(*nbr_w.shape, *feat) * gathered, dim=1)
        return out.to(x.dtype)

    return pytree.tree_map(leaf, stacked)


def gather_peer_leaf(v: torch.Tensor, group, lanes) -> torch.Tensor:
    """One leaf of ``gather_peer_rows``: the rank's (1, ...) block -> the
    stacked (K, ...) leaf, its own row and every in-neighbor's (one
    ``group.exchange`` over ``lanes``), zeros for the peers it never hears
    from."""
    return group.exchange(v, lanes)


def gather_peer_rows(block, group, lanes):
    """``gather_peer_leaf`` on every (1, ...) leaf of a tree (or a tensor):
    the stacked rows the rank's mix reads.  The zero rows meet zero mixing
    weights, so a mix of the result equals the dense stacked form's row."""
    return pytree.tree_map(lambda v: gather_peer_leaf(v, group, lanes), block)


def mix_psum(x, group, *, self_weight: float, peer_weight: float):
    """Complete-graph gossip with uniform weights as one sum over the ranks:
    out_k = (self_weight - peer_weight) x_k + peer_weight sum_j x_j, float32."""

    def leaf(v):
        vf = v.to(torch.float32)
        total = group.all_reduce(vf)
        return ((self_weight - peer_weight) * vf + peer_weight * total).to(v.dtype)

    return pytree.tree_map(leaf, x)


def _ring_lane(n: int, shift: int):
    """The lane that sends every rank's row to rank + shift (mod n)."""
    return PermLane(perm=tuple(sorted((i, (i + shift) % n) for i in range(n))),
                    src_for_dst=tuple((d - shift) % n for d in range(n)))


def mix_ring(x, group, *, self_weight: float, left_weight: float, right_weight: float):
    """Ring gossip, two exchanges (from the left, from the right) and a
    weighted sum in float32: out_k = self x_k + left x_{k-1} + right x_{k+1}."""
    n, me = group.size, group.rank

    def leaf(v):
        vf = v.to(torch.float32)
        from_left = group.exchange(vf, [_ring_lane(n, 1)])[(me - 1) % n][None]
        from_right = group.exchange(vf, [_ring_lane(n, -1)])[(me + 1) % n][None]
        out = self_weight * vf + left_weight * from_left + right_weight * from_right
        return out.to(v.dtype)

    return pytree.tree_map(leaf, x)


def mix_collective(x, group, w_row: torch.Tensor, *, topology: str = "complete"):
    """A row of a mixing matrix across the ranks: ``w_row`` (K,) is this
    rank's row; the complete topology all-gathers every block and sums
    ``w_row[j] x_j`` in float32.  Sparse topologies take ``mix_ring`` /
    ``mix_psum`` or the runtime's lanes."""
    if topology != "complete":
        raise ValueError(f"mix_collective only supports complete topology, got {topology!r}")

    def leaf(v):
        allv = group.all_gather(v[0].to(torch.float32))  # (K, ...)
        w = w_row.to(torch.float32).reshape(-1, *(1,) * (allv.dim() - 1))
        return torch.sum(w * allv, dim=0, keepdim=True).to(v.dtype)

    return pytree.tree_map(leaf, x)


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


_GATHER_ROWS = 64  # slots ring_gather_slots copies at a time


def ring_gather_slots(x_block: torch.Tensor, nbr_idx: torch.Tensor, group=None) -> torch.Tensor:
    """Neighbor rows by global index across a block-sharded peer axis:
    (p, D, ...) from the rank's (p, ...) block and its (p, D) GLOBAL indices
    (the reference's ``ring_gather_slots``).

    Peers are laid out block-major: global row g lives on rank g // p at
    local row g % p.  The rank's block streams around the ring
    (``group.ring_shift``): at step s the rank holds the block of rank
    (me + s) mod n and fills the slots whose owner just arrived with a local
    take.  Memory is the block, the visiting block and the (p, D, ...)
    slots: never a (K, ...) tensor.  With no group, or a group of one rank,
    the block is every peer and the gather is the local take
    ``x[nbr_idx]``.
    """
    idx = nbr_idx.long()
    if group is None or group.size == 1:
        return x_block[idx]
    n, me, p = group.size, group.rank, x_block.shape[0]
    owner, local = (idx // p).reshape(-1), (idx % p).reshape(-1)
    out = x_block.new_zeros((*idx.shape, *x_block.shape[1:]))
    flat_out = out.view(idx.numel(), -1)
    visiting = x_block
    for s in range(n):
        filled = torch.nonzero(owner == (me + s) % n).reshape(-1)
        # a few rows at a time: a take of every slot at once would hold a
        # second (p, D, ...) buffer
        for part in filled.split(_GATHER_ROWS):
            flat_out.index_copy_(0, part, visiting.reshape(p, -1).index_select(0, local[part]))
        if s + 1 < n:
            visiting = group.ring_shift(visiting)
    return out


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

"""Peer-stacked batch pipeline (the port's ``repro.data.pipeline.PeerBatcher``).

Batches come per round as (T, K, B, ...) — step-major, then peer — the layout
of ``repro_torch.core.p2p.local_phase``.  Each peer cycles through its own
local dataset with per-peer reshuffling at epoch boundaries.

The index stream stays on the host in numpy, with the reference's RNG streams
(``seed + 7k``), cursors and reshuffles, so batch order matches the reference
exactly.  Every peer's shard is uploaded to the device once; each round moves
only its (T, K, B) index array and gathers the batches there.  The scan
driver (``core.p2p.make_scan_driver``) takes a chunk of C rounds as one
(C, T, K, B) index upload (``chunk_batches_on``), drawn in one call in the
same order as C calls of ``round_batches_on``.

``TokenSequenceBatcher`` serves sequence models: each shard tokenized once
into a pixel stream (``images_to_tokens``, sequential MNIST), then sampled
as ``PeerBatcher`` samples.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ChunkBatches(NamedTuple):
    """C rounds' batches as rows of device-resident data: round c's batches
    are ``(x_all[idx[c]], y_all[idx[c]])``, each (T, K, B, ...)."""

    x_all: torch.Tensor  # (N, ...) every peer's shard, concatenated
    y_all: torch.Tensor  # (N,)
    idx: torch.Tensor  # (C, T, K, B) int64 rows of x_all and y_all


class PeerBatcher:
    """Cyclic per-peer mini-batch sampler over heterogeneous local datasets."""

    def __init__(self, parts: list[tuple[np.ndarray, np.ndarray]], batch_size: int, *,
                 seed: int = 0):
        self.parts = parts
        self.b = batch_size
        self.rngs = [np.random.default_rng(seed + 7 * k) for k in range(len(parts))]
        self.orders = [rng.permutation(len(p[0])) for rng, p in zip(self.rngs, parts)]
        self.cursors = [0] * len(parts)
        # start row of each peer's shard in the concatenated device copy
        sizes = np.asarray([len(p[0]) for p in parts], dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        # (device key, images, labels) of the device copy, made on first use
        self._resident: tuple[str, torch.Tensor, torch.Tensor] | None = None

    @property
    def num_peers(self) -> int:
        return len(self.parts)

    def _next_indices(self, k: int) -> np.ndarray:
        n = len(self.parts[k][0])
        if n < self.b:
            # sample with replacement when the local set is tiny
            return self.rngs[k].integers(0, n, size=self.b)
        if self.cursors[k] + self.b > n:
            self.cursors[k] = 0
            self.orders[k] = self.rngs[k].permutation(n)
        sel = self.orders[k][self.cursors[k] : self.cursors[k] + self.b]
        self.cursors[k] += self.b
        return sel

    def round_indices(self, local_steps: int) -> np.ndarray:
        """One round's sample indices, (T, K, B) int64, each into its own
        peer's shard — drawn in the reference's order (step, then peer)."""
        out = np.empty((local_steps, self.num_peers, self.b), np.int64)
        for t in range(local_steps):
            for k in range(self.num_peers):
                out[t, k] = self._next_indices(k)
        return out

    def resident(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """Every peer's shard, concatenated, on ``device`` (float32 images or
        int64 tokens, int64 labels): uploaded on first use, then kept."""
        if self._resident is None or self._resident[0] != str(device):
            x_all = np.concatenate([p[0] for p in self.parts])
            y_all = np.concatenate([p[1] for p in self.parts])
            x_type = torch.int64 if np.issubdtype(x_all.dtype, np.integer) else torch.float32
            self._resident = (
                str(device),
                torch.as_tensor(x_all, dtype=x_type, device=device),
                torch.as_tensor(y_all, dtype=torch.int64, device=device),
            )
        return self._resident[1], self._resident[2]

    def _rows(self, local_steps: int) -> np.ndarray:
        """``round_indices`` as rows of the concatenated shards."""
        return self.round_indices(local_steps) + self.offsets[None, :, None]

    def round_batches_on(
        self, local_steps: int, device: torch.device
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One round's batches on ``device``: (x (T,K,B,F) float32 or
        (T,K,B,L) int64 tokens, y (T,K,B) int64), the reference's
        ``round_batches`` values."""
        x_all, y_all = self.resident(device)
        gidx = torch.as_tensor(self._rows(local_steps), device=x_all.device)
        return x_all[gidx], y_all[gidx]

    def chunk_batches_on(self, local_steps: int, rounds: int,
                         device: torch.device) -> ChunkBatches:
        """``rounds`` rounds' batches as one (C, T, K, B) index upload: the
        reference scan driver's ``round_batches(T * C)`` reshaped to (C, T,
        ...), which equals C calls of ``round_batches_on``."""
        x_all, y_all = self.resident(device)
        rows = self._rows(local_steps * rounds)
        idx = rows.reshape(rounds, local_steps, *rows.shape[1:])
        return ChunkBatches(x_all, y_all, torch.as_tensor(idx, device=x_all.device))


def images_to_tokens(x: np.ndarray, *, num_bins: int = 16, pool: int = 2,
                     side: int = 28) -> np.ndarray:
    """Flat images (N, side*side) -> pixel-stream tokens (N, L) int32 (the
    reference's sequential-MNIST transform): ``pool`` x ``pool`` average
    pooling (784 -> 196 positions at the default), then each pooled intensity
    quantized into one of ``num_bins`` levels over the fixed range [-3, 4]
    (a dataset constant: the same pixel always maps to the same token);
    values outside clip into the edge bins."""
    if side % pool:
        raise ValueError(f"pool={pool} does not divide side={side}")
    n = x.shape[0]
    imgs = np.asarray(x, np.float32).reshape(n, side, side)
    if pool > 1:
        s = side // pool
        imgs = imgs.reshape(n, s, pool, s, pool).mean(axis=(2, 4))
    lo, hi = -3.0, 4.0
    u = np.clip((imgs - lo) / (hi - lo), 0.0, np.nextafter(1.0, 0.0))
    return np.floor(u * num_bins).astype(np.int32).reshape(n, -1)


class TokenSequenceBatcher(PeerBatcher):
    """``PeerBatcher`` for sequence models: image shards in, token batches
    out.  Each peer's shard is tokenized once (``images_to_tokens``); the
    sampling is ``PeerBatcher``'s, so batch order equals the image
    batcher's, and the device copy holds int64 tokens."""

    def __init__(self, parts: list[tuple[np.ndarray, np.ndarray]], batch_size: int, *,
                 seed: int = 0, num_bins: int = 16, pool: int = 2):
        tok_parts = [(images_to_tokens(px, num_bins=num_bins, pool=pool),
                      np.asarray(py, np.int32)) for px, py in parts]
        super().__init__(tok_parts, batch_size, seed=seed)


def global_to_peer_batch(x: np.ndarray, num_peers: int) -> np.ndarray:
    """Split a global batch along axis 0 into a leading peer axis."""
    b = x.shape[0]
    if b % num_peers:
        raise ValueError(f"global batch {b} not divisible by {num_peers} peers")
    return x.reshape(num_peers, b // num_peers, *x.shape[1:])

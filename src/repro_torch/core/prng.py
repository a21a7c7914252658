"""The reference's threefry key stream in PyTorch (``jax.random`` with
``jax_threefry_partitionable``, the JAX default).

Adaptive partner selection (``core.graph.partner_scores``) draws its random
scores and its exploration coin from a key carried as run state, one split
consumed per round.  This module computes those draws bit for bit as
``jax.random`` does, so the port's matchings equal the reference's for every
partner rule:

* ``threefry2x32`` is ``jax._src.prng._threefry2x32_lowering`` (20 rounds of
  ``apply_round`` with its key injections);
* ``split`` is ``_threefry_split_foldlike``: the hash of an iota counter
  (``iota_2x32_shape``), new key i = (bits1[i], bits2[i]);
* ``random_bits32`` is ``_threefry_random_bits_partitionable`` at 32 bits,
  ``bits1 ^ bits2`` over the counter;
* ``uniform`` is ``jax.random._uniform`` in float32 on [0, 1): the top 23
  bits as the mantissa of a float in [1, 2), minus 1;
* ``bernoulli`` is ``jax.random._bernoulli`` (mode "low"): ``uniform(key, ())
  < p``;
* ``prng_key`` is ``jax.random.PRNGKey`` (``threefry_seed``) of a Python int,
  which JAX reads as 32 bits: ``(0, seed mod 2**32)``.

uint32 values are held in int64 tensors and every sum is masked back to 32
bits.  A key is a (2,) int64 tensor; every draw runs on the key's device as
ordinary elementwise kernels of fixed shape, with no ``torch.Generator`` and
no read back to the host, so a round that draws can be captured in a CUDA
graph and replayed.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor on ``device``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _rotate_left(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2), all int64 holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotate_left(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _hash_iota(key: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the key over the 64-bit counter 0 .. n-1 (high words,
    low words), ``iota_2x32_shape`` flattened."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], count >> 32, count & MASK)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2) int64, row i the i-th new key."""
    bits1, bits2 = _hash_iota(key, n)
    return torch.stack([bits1, bits2], dim=1)


def random_bits32(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 holding uint32 values."""
    bits1, bits2 = _hash_iota(key, math.prod(shape))
    return (bits1 ^ bits2).reshape(shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 on [0, 1)."""
    float_bits = (random_bits32(key, shape) >> 9) | 0x3F800000  # 1.0's exponent
    return float_bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)``: a 0-d bool tensor, ``uniform(key,
    ()) < p`` with p rounded to float32 as JAX rounds it."""
    return uniform(key, ()) < float(torch.tensor(p, dtype=torch.float32))

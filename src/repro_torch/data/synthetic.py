"""Deterministic synthetic datasets (the port's copy of
``repro.data.synthetic``).

``mnist_like`` — each of the 10 classes is a fixed smooth 28x28 prototype (a
seed-fixed low-frequency random field) plus per-sample Gaussian noise and
brightness jitter.  ``token_stream`` / ``lm_batches`` — Zipf-ish integer
token batches for the language models.  Pure numpy, so the same seed gives
the reference's arrays bit for bit — the first link of the port's parity
chain.
"""
from __future__ import annotations

import numpy as np


def _smooth_field(rng: np.random.Generator, size: int = 28, cutoff: int = 6) -> np.ndarray:
    """Low-frequency random image in [0, 1] (smooth 'digit-like' blob)."""
    spec = np.zeros((size, size), np.complex128)
    spec[:cutoff, :cutoff] = rng.normal(size=(cutoff, cutoff)) + 1j * rng.normal(
        size=(cutoff, cutoff)
    )
    img = np.fft.ifft2(spec).real
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return img


def mnist_like(
    num_train: int = 60000,
    num_test: int = 10000,
    *,
    num_classes: int = 10,
    noise: float = 1.0,
    seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train (N,784) f32, y_train (N,) i32, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_field(rng) for _ in range(num_classes)])  # (C, 28, 28)

    def sample(n, rng):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        base = protos[y]
        bright = rng.uniform(0.7, 1.3, size=(n, 1, 1))
        x = base * bright + rng.normal(scale=noise, size=base.shape)
        return x.reshape(n, -1).astype(np.float32), y

    x_tr, y_tr = sample(num_train, np.random.default_rng(seed + 1))
    x_te, y_te = sample(num_test, np.random.default_rng(seed + 2))
    return x_tr, y_tr, x_te, y_te


def token_stream(
    num_tokens: int, vocab_size: int, *, seed: int = 0, zipf_a: float = 1.2
) -> np.ndarray:
    """Zipf-ish int32 token ids (more realistic softmax stats than uniform)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(zipf_a, size=num_tokens)
    return np.minimum(raw - 1, vocab_size - 1).astype(np.int32)


def lm_batches(
    num_batches: int, batch: int, seq: int, vocab_size: int, *, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) of shape (num_batches, batch, seq): next-token LM."""
    stream = token_stream(num_batches * batch * (seq + 1), vocab_size, seed=seed)
    arr = stream.reshape(num_batches, batch, seq + 1)
    return arr[..., :-1].copy(), arr[..., 1:].copy()

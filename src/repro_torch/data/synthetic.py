"""Deterministic synthetic MNIST stand-in (the port's copy of
``repro.data.synthetic.mnist_like``).

Each of the 10 classes is a fixed smooth 28x28 prototype (a seed-fixed
low-frequency random field) plus per-sample Gaussian noise and brightness
jitter.  Pure numpy, so the same seed gives the reference's arrays bit for
bit — the first link of the port's parity chain.
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

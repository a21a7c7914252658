"""Dataset partitioning across peers: IID and pathological non-IID (the port's
copy of ``repro.data.partition``; pure numpy, seed-for-seed identical).

- IID (Sec. V-A): "randomly shuffle and equally partition" into K local sets.
- Pathological non-IID (Sec. V-B): each device sees only a subset of classes.
"""
from __future__ import annotations

import numpy as np


def iid_partition(
    x: np.ndarray, y: np.ndarray, num_peers: int, *, seed: int = 0
) -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    # len(x) % num_peers samples go one-each to the first peers, so the union
    # of the parts is the whole dataset (data-weighted mixing sums to N).
    n_per, extra = divmod(len(x), num_peers)
    out = []
    start = 0
    for k in range(num_peers):
        stop = start + n_per + (1 if k < extra else 0)
        out.append((x[idx[start:stop]], y[idx[start:stop]]))
        start = stop
    return out


def pathological_partition(
    x: np.ndarray,
    y: np.ndarray,
    peer_classes: list[tuple[int, ...]],
    *,
    samples_per_class: int | None = None,
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each peer k gets samples only from peer_classes[k].

    samples_per_class=None takes *all* samples of that class; an int takes
    that many (Fig. 3 uses 50).
    """
    rng = np.random.default_rng(seed)
    present = np.unique(y)
    for classes in peer_classes:
        for c in classes:
            if c not in present:
                raise ValueError(
                    f"peer_classes references class {c!r} which does not occur "
                    f"in y (present classes: {present.tolist()})"
                )
    out = []
    for classes in peer_classes:
        xs, ys = [], []
        for c in classes:
            idx = np.nonzero(y == c)[0]
            idx = rng.permutation(idx)
            if samples_per_class is not None:
                idx = idx[:samples_per_class]
            xs.append(x[idx])
            ys.append(y[idx])
        xk, yk = np.concatenate(xs), np.concatenate(ys)
        perm = rng.permutation(len(xk))
        out.append((xk[perm], yk[perm]))
    return out


def data_sizes(parts: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    return np.asarray([len(p[0]) for p in parts], dtype=np.int64)

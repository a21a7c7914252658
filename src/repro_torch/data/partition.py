"""Dataset partitioning across peers: IID, pathological non-IID, Dirichlet
(the port's copy of ``repro.data.partition``; pure numpy, seed-for-seed
identical).

- IID (Sec. V-A): "randomly shuffle and equally partition" into K local sets.
- Pathological non-IID (Sec. V-B): each device sees only a subset of classes.
- Dirichlet(alpha): the federated literature's in-between.
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


def dirichlet_partition(
    x: np.ndarray, y: np.ndarray, num_peers: int, *, alpha: float = 0.5, seed: int = 0
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each class split over the peers by a Dirichlet(alpha) draw; a peer
    left empty takes one sample at a time from the largest, as the
    reference rebalances (an empty peer is a zero row of the data-weighted
    mixing matrix)."""
    if len(x) < num_peers:
        raise ValueError(
            f"dirichlet_partition needs at least one sample per peer: "
            f"len(x)={len(x)} < num_peers={num_peers}"
        )
    rng = np.random.default_rng(seed)
    peer_idx: list[list[int]] = [[] for _ in range(num_peers)]
    for c in np.unique(y):
        idx = rng.permutation(np.nonzero(y == c)[0])
        props = rng.dirichlet([alpha] * num_peers)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            peer_idx[k].extend(part.tolist())
    sizes = np.asarray([len(p) for p in peer_idx])
    while (sizes == 0).any():
        dst = int(np.argmin(sizes))
        src = int(np.argmax(sizes))
        peer_idx[dst].append(peer_idx[src].pop())
        sizes[dst] += 1
        sizes[src] -= 1
    out = []
    for k in range(num_peers):
        sel = rng.permutation(np.asarray(peer_idx[k], dtype=int))
        out.append((x[sel], y[sel]))
    return out


def data_sizes(parts: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    return np.asarray([len(p[0]) for p in parts], dtype=np.int64)

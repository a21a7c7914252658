"""Communication graphs and mixing matrices (host side; the port's copy of the
numpy half of ``repro.core.graph``).

The paper (Sec. III-C) models the network as a flat, undirected, connected
graph; devices exchange parameters only over its edges.  Mixing matrices are
row-stochastic — the paper's choice is data-size weighted:

    alpha_kj = n_j / (n_k + sum_{i in N(k)} n_i)        (neighbors j)
    alpha_kk = 1 - sum_j alpha_kj

Everything here is float64 numpy and must equal the reference bit for bit.
The undirected time-varying schedules (link dropout, random matchings, peer
churn, round robin) are ported; directed schedules and column-stochastic
(push-sum) matrices are still to be ported (ROADMAP.md queue 1 item 8b), and
so are the on-device adaptive matchings (item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

TOPOLOGIES = (
    "complete",
    "ring",
    "chain",
    "star",
    "torus2d",
    "erdos_renyi",
    "hypercube",
    "disconnected",  # for "no consensus" baselines (self-loops only)
    "directed_ring",  # i -> i+1 only: the canonical push-sum topology
)


def _reachable(adjacency: np.ndarray, start: int = 0) -> np.ndarray:
    k = adjacency.shape[0]
    seen = np.zeros(k, dtype=bool)
    stack = [start]
    seen[start] = True
    while stack:
        v = stack.pop()
        for u in np.nonzero(adjacency[v])[0]:
            if not seen[u]:
                seen[u] = True
                stack.append(int(u))
    return seen


@dataclasses.dataclass(frozen=True)
class CommGraph:
    """A communication graph over K peers.

    adjacency: (K, K) bool, no self loops.  ``adjacency[i, j]`` = "i sends to
    j"; undirected graphs (the default) must be symmetric, ``directed=True``
    admits one-way edges.
    """

    adjacency: np.ndarray
    directed: bool = False

    def __post_init__(self):
        """Validate squareness, symmetry (if undirected), and no self loops."""
        a = np.asarray(self.adjacency, dtype=bool)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not self.directed and not np.array_equal(a, a.T):
            raise ValueError("graph must be undirected (symmetric adjacency)")
        if a.diagonal().any():
            raise ValueError("no self loops in adjacency (self weight is alpha_kk)")
        object.__setattr__(self, "adjacency", a)

    @property
    def num_peers(self) -> int:
        """K, the number of peers (rows of the adjacency)."""
        return self.adjacency.shape[0]

    def in_degree(self) -> np.ndarray:
        """(K,) number of peers each peer receives from."""
        return self.adjacency.sum(axis=0)

    def is_connected(self) -> bool:
        """Weak connectivity (edge directions ignored)."""
        return bool(_reachable(self.adjacency | self.adjacency.T).all())

    def max_degree(self) -> int:
        """Max *in*-degree — the padded neighbor width of the sparse mixing row."""
        return int(self.in_degree().max()) if self.num_peers else 0


def build_graph(topology: str, num_peers: int, *, p: float = 0.3, seed: int = 0) -> CommGraph:
    """Construct a named topology over ``num_peers`` devices."""
    k = num_peers
    if k < 1:
        raise ValueError("need at least one peer")
    a = np.zeros((k, k), dtype=bool)
    if topology == "complete":
        a = ~np.eye(k, dtype=bool)
        if k == 1:
            a = np.zeros((1, 1), dtype=bool)
    elif topology == "ring":
        for i in range(k):
            a[i, (i + 1) % k] = a[(i + 1) % k, i] = True
        np.fill_diagonal(a, False)
    elif topology == "chain":
        for i in range(k - 1):
            a[i, i + 1] = a[i + 1, i] = True
    elif topology == "star":
        a[0, 1:] = a[1:, 0] = True
    elif topology == "torus2d":
        side = int(round(np.sqrt(k)))
        if side * side != k:
            raise ValueError(f"torus2d needs a square peer count, got {k}")
        idx = lambda r, c: r * side + c  # noqa: E731
        for r in range(side):
            for c in range(side):
                a[idx(r, c), idx((r + 1) % side, c)] = True
                a[idx((r + 1) % side, c), idx(r, c)] = True
                a[idx(r, c), idx(r, (c + 1) % side)] = True
                a[idx(r, (c + 1) % side), idx(r, c)] = True
        np.fill_diagonal(a, False)
    elif topology == "hypercube":
        dim = int(round(np.log2(k)))
        if 2**dim != k:
            raise ValueError(f"hypercube needs a power-of-2 peer count, got {k}")
        for i in range(k):
            for d in range(dim):
                j = i ^ (1 << d)
                a[i, j] = a[j, i] = True
    elif topology == "erdos_renyi":
        rng = np.random.default_rng(seed)
        while True:
            u = rng.random((k, k)) < p
            a = np.triu(u, 1)
            a = a | a.T
            g = CommGraph(a)
            if g.is_connected():
                return g
    elif topology == "disconnected":
        pass  # all-zero adjacency: every peer isolated
    elif topology == "directed_ring":
        for i in range(k):
            a[i, (i + 1) % k] = True
        np.fill_diagonal(a, False)
        return CommGraph(a, directed=True)
    else:
        raise ValueError(f"unknown topology {topology!r}; one of {TOPOLOGIES}")
    return CommGraph(a)


MIXINGS = ("data_weighted", "metropolis", "uniform_neighbor", "identity")


def mixing_matrix(
    graph: CommGraph,
    mixing: str = "data_weighted",
    *,
    data_sizes: Sequence[int] | None = None,
    consensus_step_size: float | np.ndarray = 1.0,
) -> np.ndarray:
    """Row-stochastic mixing matrix W with W[k, j] = alpha_kj.

    data_weighted — the paper's choice (Sec. V-A):
        alpha_kj = n_j / (n_k + sum_{i in N(k)} n_i), alpha_kk = remainder.
    metropolis — doubly stochastic: alpha_kj = 1 / (1 + max(deg_k, deg_j)).
    uniform_neighbor — alpha_kj = 1 / (deg_k + 1) (row stochastic).
    identity — no mixing (isolated training baseline).

    consensus_step_size: the paper's per-device epsilon_k^(t); W_eps =
    (1 - eps_k) I + eps_k W applied row-wise. eps=1 reproduces W.
    """
    k = graph.num_peers
    adj = graph.adjacency
    if mixing == "identity":
        w = np.eye(k)
    elif mixing == "data_weighted":
        if data_sizes is None:
            data_sizes = np.ones(k)
        n = np.asarray(data_sizes, dtype=np.float64)
        if n.shape != (k,) or (n <= 0).any():
            raise ValueError("data_sizes must be positive, one per peer")
        w = np.zeros((k, k))
        for i in range(k):
            nbrs = np.nonzero(adj[:, i])[0]
            denom = n[i] + n[nbrs].sum()
            w[i, nbrs] = n[nbrs] / denom
            w[i, i] = 1.0 - w[i, nbrs].sum()
    elif mixing == "metropolis":
        deg = graph.in_degree()
        w = np.zeros((k, k))
        for i in range(k):
            for j in np.nonzero(adj[:, i])[0]:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
            w[i, i] = 1.0 - w[i].sum()
    elif mixing == "uniform_neighbor":
        deg = graph.in_degree()
        w = np.zeros((k, k))
        for i in range(k):
            nbrs = np.nonzero(adj[:, i])[0]
            w[i, nbrs] = 1.0 / (deg[i] + 1.0)
            w[i, i] = 1.0 - w[i, nbrs].sum()
    else:
        raise ValueError(f"unknown mixing {mixing!r}; one of {MIXINGS}")

    eps = np.asarray(consensus_step_size, dtype=np.float64)
    if eps.ndim == 0:
        eps = np.full(k, float(eps))
    if eps.shape != (k,):
        raise ValueError("consensus_step_size must be scalar or (K,)")
    w = (1.0 - eps)[:, None] * np.eye(k) + eps[:, None] * w

    if not np.all(w >= -1e-12):
        raise ValueError("mixing weights must be nonnegative")
    if not np.allclose(w.sum(axis=1), 1.0):
        raise ValueError("mixing matrix must be row stochastic")
    return w


def affinity_matrix(graph: CommGraph, *, data_sizes: Sequence[int] | None = None) -> np.ndarray:
    """Beta matrix for the affinity bias d (Sec. V-C):

        beta_kj = n_j / sum_{i in N(k)} n_i  for j in N(k), else 0.

    Rows sum to 1 over in-neighbors only (no self weight).  Isolated peers
    get an all-zero row (d stays 0 — no neighbors to be biased toward).
    """
    k = graph.num_peers
    adj = graph.adjacency
    if data_sizes is None:
        data_sizes = np.ones(k)
    n = np.asarray(data_sizes, dtype=np.float64)
    b = np.zeros((k, k))
    for i in range(k):
        nbrs = np.nonzero(adj[:, i])[0]
        if len(nbrs) == 0:
            continue
        b[i, nbrs] = n[nbrs] / n[nbrs].sum()
    return b


SCHEDULES = (
    "static",
    "link_dropout",
    "random_matching",
    "peer_churn",
    "round_robin",
    "one_way_matching",
)


@dataclasses.dataclass(frozen=True)
class GraphSchedule:
    """A periodic sequence of communication graphs, one per round.

    Round ``r`` communicates over ``graphs[r % period]``.  A period-1 schedule
    is the paper's fixed-topology setting; longer periods model churn (links
    dropping, gossip pairs re-sampled every round, peers going offline).
    Individual rounds may be disconnected: consensus then relies on the
    union over one period being connected (B-connectivity).
    """

    graphs: tuple[CommGraph, ...]
    name: str = "static"

    def __post_init__(self):
        """Validate a non-empty schedule with a uniform peer count."""
        graphs = tuple(self.graphs)
        if not graphs:
            raise ValueError("schedule needs at least one graph")
        k = graphs[0].num_peers
        if any(g.num_peers != k for g in graphs):
            raise ValueError("all graphs in a schedule must share the peer count")
        object.__setattr__(self, "graphs", graphs)

    @property
    def period(self) -> int:
        """R, the number of graphs before the schedule repeats."""
        return len(self.graphs)

    @property
    def num_peers(self) -> int:
        """K, shared by every graph in the schedule."""
        return self.graphs[0].num_peers

    @property
    def directed(self) -> bool:
        """True iff any round's graph is directed."""
        return any(g.directed for g in self.graphs)

    def graph_at(self, round_idx: int) -> CommGraph:
        """The round's graph: periodic indexing ``round_idx % period``."""
        return self.graphs[round_idx % self.period]

    def max_degree(self) -> int:
        """Max (in-)degree over all rounds."""
        return max(g.max_degree() for g in self.graphs)

    def union_graph(self) -> CommGraph:
        """OR of all adjacencies: the B-connectivity window of one period."""
        adj = np.zeros((self.num_peers, self.num_peers), dtype=bool)
        for g in self.graphs:
            adj |= g.adjacency
        return CommGraph(adj, directed=self.directed)

    def union_is_connected(self) -> bool:
        """Weak connectivity of the period union (B-connectivity check)."""
        return self.union_graph().is_connected()


def _directed_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1 item 8b")


def static_schedule(graph: CommGraph) -> GraphSchedule:
    """Period-1 wrapper — the fixed topology."""
    return GraphSchedule((graph,), name="static")


def link_dropout_schedule(
    base: CommGraph, survival_prob: float, rounds: int, *, seed: int = 0
) -> GraphSchedule:
    """Each base link independently survives each round with prob ``survival_prob``.

    Undirected bases only: dropping the directed edges of a directed base one
    by one is the push-sum half of the schedule (queue 1 item 8b).
    """
    if not 0.0 < survival_prob <= 1.0:
        raise ValueError("survival_prob must be in (0, 1]")
    if rounds < 1:
        raise ValueError("need at least one round")
    if base.directed:
        raise _directed_not_ported("link_dropout on a directed base graph")
    rng = np.random.default_rng(seed)
    k = base.num_peers
    iu, ju = np.triu_indices(k, 1)
    edge_mask = base.adjacency[iu, ju]
    graphs = []
    for _ in range(rounds):
        keep = edge_mask & (rng.random(len(iu)) < survival_prob)
        a = np.zeros((k, k), dtype=bool)
        a[iu[keep], ju[keep]] = True
        graphs.append(CommGraph(a | a.T))
    return GraphSchedule(tuple(graphs), name="link_dropout")


def random_matching_schedule(num_peers: int, rounds: int, *, seed: int = 0) -> GraphSchedule:
    """One-peer pairwise gossip: a random perfect matching per round.

    Every peer talks to at most one partner per round; with odd ``num_peers``
    one peer idles (its row of W is the self-loop).
    """
    if num_peers < 2:
        raise ValueError("matching needs at least two peers")
    if rounds < 1:
        raise ValueError("need at least one round")
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(rounds):
        perm = rng.permutation(num_peers)
        a = np.zeros((num_peers, num_peers), dtype=bool)
        for p in range(0, num_peers - 1, 2):
            i, j = perm[p], perm[p + 1]
            a[i, j] = a[j, i] = True
        graphs.append(CommGraph(a))
    return GraphSchedule(tuple(graphs), name="random_matching")


def peer_churn_schedule(
    base: CommGraph, online_prob: float, rounds: int, *, seed: int = 0
) -> GraphSchedule:
    """Peers go offline/online per round; offline peers lose all their edges.

    An offline peer keeps training locally but neither sends nor receives: its
    row of W is the self-loop and its row of Beta is zero, so consensus leaves
    its parameters and its d untouched.
    """
    if not 0.0 < online_prob <= 1.0:
        raise ValueError("online_prob must be in (0, 1]")
    if rounds < 1:
        raise ValueError("need at least one round")
    rng = np.random.default_rng(seed)
    k = base.num_peers
    graphs = []
    for _ in range(rounds):
        online = rng.random(k) < online_prob
        a = base.adjacency & online[:, None] & online[None, :]
        graphs.append(CommGraph(a))
    return GraphSchedule(tuple(graphs), name="peer_churn")


def one_way_matching_schedule(num_peers: int, rounds: int, *, seed: int = 0) -> GraphSchedule:
    """Directed pairwise gossip: raises, push-sum and directed graphs are item 8b."""
    raise _directed_not_ported("the one_way_matching schedule")


def round_robin_schedule(graphs: Sequence[CommGraph]) -> GraphSchedule:
    """Cycle deterministically over a fixed list of graphs."""
    return GraphSchedule(tuple(graphs), name="round_robin")


def schedule_matrices(
    schedule: GraphSchedule,
    mixing: str = "data_weighted",
    *,
    data_sizes: Sequence[int] | None = None,
    consensus_step_size: float | np.ndarray = 1.0,
    stochasticity: str = "row",
) -> tuple[np.ndarray, np.ndarray]:
    """Stacked per-round mixing/affinity matrices: (R, K, K) W and Beta."""
    if stochasticity == "column":
        raise _directed_not_ported("column-stochastic (push-sum) matrices")
    if stochasticity != "row":
        raise ValueError(f"unknown stochasticity {stochasticity!r}; 'row' or 'column'")
    w = np.stack(
        [
            mixing_matrix(
                g, mixing, data_sizes=data_sizes, consensus_step_size=consensus_step_size
            )
            for g in schedule.graphs
        ]
    )
    beta = np.stack([affinity_matrix(g, data_sizes=data_sizes) for g in schedule.graphs])
    return w, beta


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2| of the mixing matrix — the consensus rate.

    For row-stochastic (not necessarily symmetric) W the eigenvalues are
    ranked by magnitude; lambda_1 = 1 always.
    """
    eig = np.sort(np.abs(np.linalg.eigvals(w)))[::-1]
    if len(eig) < 2:
        return 1.0
    return float(1.0 - eig[1])

"""Communication graphs and mixing matrices (the port's ``repro.core.graph``:
its numpy half on the host, its adaptive partner selection in torch on the
device).

The paper (Sec. III-C) models the network as a flat, undirected, connected
graph; devices exchange parameters only over its edges.  Mixing matrices are
row-stochastic — the paper's choice is data-size weighted:

    alpha_kj = n_j / (n_k + sum_{i in N(k)} n_i)        (neighbors j)
    alpha_kk = 1 - sum_j alpha_kj

The graphs and matrices are float64 numpy and equal the reference's bit for
bit.  Graphs may be directed (``CommGraph(a, directed=True)``): push-sum
(``core.protocols.PushSumProtocol``) mixes them with the column-stochastic
weights of ``column_stochastic_matrix``.  The time-varying schedules (link
dropout, undirected or one-way edge by edge, random and one-way matchings,
peer churn, round robin) and their sparse degree-bounded form
(``SparseSchedule``, row- or column-stochastic) are built the same way.

Adaptive partner selection (``schedule="adaptive"``) is not numpy: each
round's pairwise matching is computed on the run's device from run state,
the peers' previous losses and a threefry key (``core.prng``), by
``adaptive_round_matrices``.  Its scores, matching and float32 (W, Beta)
equal the reference's bit for bit given the same losses and key.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prng

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

    def out_degree(self) -> np.ndarray:
        """(K,) number of peers each peer sends to."""
        return self.adjacency.sum(axis=1)

    def is_connected(self) -> bool:
        """Weak connectivity (edge directions ignored)."""
        return bool(_reachable(self.adjacency | self.adjacency.T).all())

    def is_strongly_connected(self) -> bool:
        """Every peer reaches every peer along directed edges (push-sum's
        condition for the de-biased estimates to converge)."""
        return bool(_reachable(self.adjacency).all() and _reachable(self.adjacency.T).all())

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


def column_stochastic_matrix(
    graph: CommGraph,
    mixing: str = "data_weighted",
    *,
    data_sizes: Sequence[int] | None = None,
    consensus_step_size: float | np.ndarray = 1.0,
) -> np.ndarray:
    """Column-stochastic push weights A with A[k, j] = the share of sender j's
    mass that j pushes to k.

    Column j splits j's mass over its out-neighbors and itself (sum_k A[k, j]
    = 1), so the total mass is conserved every round, on any directed, even
    disconnected, graph:

    data_weighted — A[k, j] = n_k / (n_j + sum_{i in out(j)} n_i), A[j, j] the rest.
    metropolis — A[k, j] = 1 / (1 + max(outdeg_j, outdeg_k)) per edge j -> k.
    uniform_neighbor — A[k, j] = 1 / (outdeg_j + 1), the classic push-sum split.
    identity — no mixing.

    On an undirected graph ``metropolis`` gives a symmetric doubly
    stochastic A, ``mixing_matrix``'s.  consensus_step_size applies column
    by column: A_eps = (1 - eps_j) I + eps_j A.
    """
    k = graph.num_peers
    adj = graph.adjacency
    if mixing == "identity":
        a = np.eye(k)
    elif mixing == "data_weighted":
        if data_sizes is None:
            data_sizes = np.ones(k)
        n = np.asarray(data_sizes, dtype=np.float64)
        if n.shape != (k,) or (n <= 0).any():
            raise ValueError("data_sizes must be positive, one per peer")
        a = np.zeros((k, k))
        for j in range(k):
            out = np.nonzero(adj[j])[0]
            denom = n[j] + n[out].sum()
            a[out, j] = n[out] / denom
            a[j, j] = 1.0 - a[out, j].sum()
    elif mixing == "metropolis":
        deg = graph.out_degree()
        a = np.zeros((k, k))
        for j in range(k):
            for i in np.nonzero(adj[j])[0]:
                a[i, j] = 1.0 / (1.0 + max(deg[j], deg[i]))
            a[j, j] = 1.0 - a[:, j].sum()
    elif mixing == "uniform_neighbor":
        deg = graph.out_degree()
        a = np.zeros((k, k))
        for j in range(k):
            out = np.nonzero(adj[j])[0]
            a[out, j] = 1.0 / (deg[j] + 1.0)
            a[j, j] = 1.0 - a[out, j].sum()
    else:
        raise ValueError(f"unknown mixing {mixing!r}; one of {MIXINGS}")

    eps = np.asarray(consensus_step_size, dtype=np.float64)
    if eps.ndim == 0:
        eps = np.full(k, float(eps))
    if eps.shape != (k,):
        raise ValueError("consensus_step_size must be scalar or (K,)")
    a = np.eye(k) * (1.0 - eps)[None, :] + eps[None, :] * a

    if not np.all(a >= -1e-12):
        raise ValueError("push weights must be nonnegative")
    if not np.allclose(a.sum(axis=0), 1.0):
        raise ValueError("push matrix must be column stochastic")
    if not np.all(np.diag(a) > 0):
        raise ValueError("senders must retain some mass (positive diagonal)")
    return a


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

    def union_is_strongly_connected(self) -> bool:
        """Strong connectivity of the period union: push-sum's condition for
        the de-biased estimates to reach consensus."""
        return self.union_graph().is_strongly_connected()


def static_schedule(graph: CommGraph) -> GraphSchedule:
    """Period-1 wrapper — the fixed topology."""
    return GraphSchedule((graph,), name="static")


def link_dropout_schedule(
    base: CommGraph, survival_prob: float, rounds: int, *, seed: int = 0
) -> GraphSchedule:
    """Each base edge independently survives each round with prob ``survival_prob``.

    On a directed base every one-way edge drops on its own: a round may keep
    i -> j and lose j -> i.  Undirected bases drop whole links.
    """
    if not 0.0 < survival_prob <= 1.0:
        raise ValueError("survival_prob must be in (0, 1]")
    if rounds < 1:
        raise ValueError("need at least one round")
    rng = np.random.default_rng(seed)
    k = base.num_peers
    graphs = []
    if base.directed:
        ei, ej = np.nonzero(base.adjacency)
        for _ in range(rounds):
            keep = rng.random(len(ei)) < survival_prob
            a = np.zeros((k, k), dtype=bool)
            a[ei[keep], ej[keep]] = True
            graphs.append(CommGraph(a, directed=True))
        return GraphSchedule(tuple(graphs), name="link_dropout")
    iu, ju = np.triu_indices(k, 1)
    edge_mask = base.adjacency[iu, ju]
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
    """Directed pairwise gossip: a random one-way matching per round.

    Each round pairs peers at random and each pair transmits in one
    direction, sender to receiver.  Row-stochastic gossip cannot average
    under this schedule; push-sum's mass correction makes it exact.
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
            a[perm[p], perm[p + 1]] = True  # perm[p] sends, perm[p + 1] receives
        graphs.append(CommGraph(a, directed=True))
    return GraphSchedule(tuple(graphs), name="one_way_matching")


def round_robin_schedule(graphs: Sequence[CommGraph]) -> GraphSchedule:
    """Cycle deterministically over a fixed list of graphs."""
    return GraphSchedule(tuple(graphs), name="round_robin")


# ---------------------------------------------------------------------------
# Permutation lanes (the sharded runtime, one process per peer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PermLane:
    """One exchange's worth of edges: every peer sends at most once and
    receives at most once along a lane (``core.peer_group.PeerGroup.exchange``
    makes one send and one receive a lane per rank).

    perm:         ((src, dst), ...) pairs, sorted.
    src_for_dst:  (K,) — src_for_dst[k] is the peer whose row k receives in
                  this lane, or the sentinel K when k receives nothing.
    """

    perm: tuple[tuple[int, int], ...]
    src_for_dst: tuple[int, ...]


def edge_color_lanes(adjacency: np.ndarray) -> tuple[PermLane, ...]:
    """Partition ``adjacency[src, dst]`` edges into lanes: a greedy
    bipartite edge coloring in row-major edge order (each lane uses every
    peer at most once as a source and once as a destination), equal to the
    reference's lane for lane."""
    adjacency = np.asarray(adjacency, dtype=bool)
    k = adjacency.shape[0]
    lanes: list[dict[int, int]] = []  # per lane: dst -> src
    for src, dst in zip(*np.nonzero(adjacency)):
        src, dst = int(src), int(dst)
        for lane in lanes:
            if dst not in lane and src not in lane.values():
                lane[dst] = src
                break
        else:
            lanes.append({dst: src})
    out = []
    for lane in lanes:
        src_for_dst = np.full((k,), k, dtype=np.int32)
        for dst, src in lane.items():
            src_for_dst[dst] = src
        out.append(PermLane(perm=tuple(sorted((src, dst) for dst, src in lane.items())),
                            src_for_dst=tuple(int(s) for s in src_for_dst)))
    return tuple(out)


def schedule_lanes(schedule: GraphSchedule) -> tuple[PermLane, ...]:
    """The lanes of the union of the schedule's edge sets: one lane set
    serves every round, and a round's weights are zero on every lane edge
    absent from its graph."""
    return edge_color_lanes(schedule.union_graph().adjacency)


def schedule_matrices(
    schedule: GraphSchedule,
    mixing: str = "data_weighted",
    *,
    data_sizes: Sequence[int] | None = None,
    consensus_step_size: float | np.ndarray = 1.0,
    stochasticity: str = "row",
) -> tuple[np.ndarray, np.ndarray]:
    """Stacked per-round mixing/affinity matrices: (R, K, K) W and Beta.

    stochasticity: "row" (gossip, ``mixing_matrix``) or "column" (push-sum,
    ``column_stochastic_matrix``).
    """
    if stochasticity == "row":
        build = mixing_matrix
    elif stochasticity == "column":
        build = column_stochastic_matrix
    else:
        raise ValueError(f"unknown stochasticity {stochasticity!r}; 'row' or 'column'")
    w = np.stack(
        [
            build(
                g, mixing, data_sizes=data_sizes, consensus_step_size=consensus_step_size
            )
            for g in schedule.graphs
        ]
    )
    beta = np.stack([affinity_matrix(g, data_sizes=data_sizes) for g in schedule.graphs])
    return w, beta


# ---------------------------------------------------------------------------
# Sparse degree-bounded schedules (large-K form of schedule_matrices)
# ---------------------------------------------------------------------------


def _padded_in_neighbors(
    mask: np.ndarray, degree_bound: int
) -> tuple[np.ndarray, np.ndarray]:
    """Padded neighbor lists from a row-oriented neighbor mask.

    ``mask[i, j]`` = "j is a neighbor of row i".  Returns ``(idx, valid)``:
    ``idx`` (K, D) int32 lists each row's neighbors in increasing index order
    (the order ``np.nonzero`` yields, so weight sums reduce in the dense
    builders' order), padded with the row's own index; ``valid`` marks the
    real slots.
    """
    k = mask.shape[0]
    d = int(degree_bound)
    deg = mask.sum(axis=1)
    if d < int(deg.max(initial=0)):
        raise ValueError(
            f"degree_bound={d} below the actual max degree {int(deg.max())}"
        )
    # a stable argsort of the negated mask puts the neighbor columns first,
    # in increasing column order
    order = np.argsort(~mask, axis=1, kind="stable")[:, :d].astype(np.int32)
    # a bound past K: the slots past column K are padding (the reference
    # fails to broadcast here)
    order = np.pad(order, ((0, 0), (0, d - order.shape[1])))
    valid = np.arange(d)[None, :] < deg[:, None]
    own = np.arange(k, dtype=np.int32)[:, None]
    return np.where(valid, order, own), valid


def _slot_sum(vals: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-row sum over the real slots, in slot (== increasing index) order:
    the dense builders' accumulation order."""
    return np.where(valid, vals, 0.0).sum(axis=1)


def _check_data_sizes(n, k: int) -> np.ndarray:
    if n is None:
        n = np.ones(k)
    n = np.asarray(n, dtype=np.float64)
    if n.shape != (k,) or (n <= 0).any():
        raise ValueError("data_sizes must be positive, one per peer")
    return n


def _check_eps(consensus_step_size, k: int) -> np.ndarray:
    eps = np.asarray(consensus_step_size, dtype=np.float64)
    if eps.ndim == 0:
        eps = np.full(k, float(eps))
    if eps.shape != (k,):
        raise ValueError("consensus_step_size must be scalar or (K,)")
    return eps


def _sparse_row_weights(
    graph: CommGraph,
    mixing: str,
    n: np.ndarray,
    eps: np.ndarray,
    nbr_idx: np.ndarray,
    valid: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """(self_w (K,), nbr_w (K, D)): the rows of ``mixing_matrix`` without
    ever building (K, K), value for value: the same float64 expressions,
    summed in the same order."""
    k = graph.num_peers
    if mixing == "identity":
        nbr_w = np.zeros(nbr_idx.shape)
        self_w = np.ones(k)
    elif mixing == "data_weighted":
        denom = n + _slot_sum(n[nbr_idx], valid)
        nbr_w = np.where(valid, n[nbr_idx] / denom[:, None], 0.0)
        self_w = 1.0 - _slot_sum(nbr_w, valid)
    elif mixing == "metropolis":
        deg = graph.in_degree().astype(np.float64)
        nbr_w = np.where(
            valid, 1.0 / (1.0 + np.maximum(deg[:, None], deg[nbr_idx])), 0.0
        )
        self_w = 1.0 - _slot_sum(nbr_w, valid)
    elif mixing == "uniform_neighbor":
        deg = graph.in_degree().astype(np.float64)
        nbr_w = np.where(valid, 1.0 / (deg[:, None] + 1.0), 0.0)
        self_w = 1.0 - _slot_sum(nbr_w, valid)
    else:
        raise ValueError(f"unknown mixing {mixing!r}; one of {MIXINGS}")
    # consensus step size, row-wise: W_eps = (1 - eps) I + eps W
    nbr_w = eps[:, None] * nbr_w
    self_w = (1.0 - eps) + eps * self_w
    return self_w, nbr_w


def _sparse_col_weights(
    graph: CommGraph,
    mixing: str,
    n: np.ndarray,
    eps: np.ndarray,
    nbr_idx: np.ndarray,
    valid: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """(self_w (K,), nbr_w (K, D)): the rows of ``column_stochastic_matrix``.

    ``nbr_w[i, s]`` is A[i, j] for the in-neighbor j = nbr_idx[i, s] (the
    mass j pushes to i); the diagonal is a column property (the mass sender
    j keeps), so it sums over each sender's padded out-neighbor slots.
    """
    k = graph.num_peers
    adj = graph.adjacency
    if mixing == "identity":
        return np.ones(k), np.zeros(nbr_idx.shape)
    # out_idx[j]: the receivers of sender j's mass
    out_deg = graph.out_degree()
    out_idx, out_valid = _padded_in_neighbors(adj, max(int(out_deg.max()), 1))
    if mixing == "data_weighted":
        denom = n + _slot_sum(n[out_idx], out_valid)  # per sender j
        nbr_w = np.where(valid, n[:, None] / denom[nbr_idx], 0.0)
        col_vals = np.where(out_valid, n[out_idx] / denom[:, None], 0.0)
        self_w = 1.0 - _slot_sum(col_vals, out_valid)
    elif mixing == "metropolis":
        deg = out_deg.astype(np.float64)
        nbr_w = np.where(
            valid, 1.0 / (1.0 + np.maximum(deg[nbr_idx], deg[:, None])), 0.0
        )
        col_vals = np.where(
            out_valid, 1.0 / (1.0 + np.maximum(deg[:, None], deg[out_idx])), 0.0
        )
        self_w = 1.0 - _slot_sum(col_vals, out_valid)
    elif mixing == "uniform_neighbor":
        deg = out_deg.astype(np.float64)
        nbr_w = np.where(valid, 1.0 / (deg[nbr_idx] + 1.0), 0.0)
        col_vals = np.where(out_valid, 1.0 / (deg[:, None] + 1.0), 0.0)
        self_w = 1.0 - _slot_sum(col_vals, out_valid)
    else:
        raise ValueError(f"unknown mixing {mixing!r}; one of {MIXINGS}")
    # consensus step size, column-wise: A_eps = I (1 - eps) + eps A
    nbr_w = eps[nbr_idx] * nbr_w
    self_w = (1.0 - eps) + eps * self_w
    return self_w, nbr_w


def _sparse_beta(n: np.ndarray, nbr_idx: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Padded rows of ``affinity_matrix``: beta[i, s] = n_j / sum_nbrs n,
    zero rows for isolated peers."""
    nsum = _slot_sum(n[nbr_idx], valid)
    safe = np.where(nsum > 0, nsum, 1.0)
    return np.where(valid & (nsum > 0)[:, None], n[nbr_idx] / safe[:, None], 0.0)


@dataclasses.dataclass(frozen=True)
class SparseSchedule:
    """Degree-bounded sparse form of a schedule's per-round mixing constants.

    The large-K counterpart of ``schedule_matrices``: instead of (R, K, K)
    dense stacks (128 MB of float64 per matrix at K = 4096) each round is a
    padded edge list with one degree bound D for the whole schedule:

        self_w  (R, K)    retained self weight W[r, i, i]
        nbr_idx (R, K, D) int32 indices of row i's in-neighbors, in
                          increasing index order, padded with i's own index
        nbr_w   (R, K, D) the off-diagonal weight per slot (0.0 at padding)
        beta    (R, K, D) the affinity weight per slot (0.0 at padding)

    All weights are float64, like the dense builders'; the runtime casts them
    to float32 once, at upload, so a value built here and the same value
    sliced from the dense stack become the same float32 bits.

    ``to_dense(from_dense(w, beta)) == (w, beta)`` exactly.  ``from_schedule``
    builds the same values straight from the graphs without any (K, K) float
    array; its neighbor pattern is the adjacency itself, so a round whose
    mixing weight is 0 on an edge ("identity" mixing, a step size of 0) keeps
    that edge's slot and its affinity weight.
    """

    self_w: np.ndarray  # (R, K) float64
    nbr_idx: np.ndarray  # (R, K, D) int32
    nbr_w: np.ndarray  # (R, K, D) float64
    beta: np.ndarray  # (R, K, D) float64
    stochasticity: str = "row"
    name: str = "static"

    def __post_init__(self):
        """Validate the padded (R, K, D) slot arrays and index bounds."""
        self_w = np.asarray(self.self_w, dtype=np.float64)
        nbr_idx = np.asarray(self.nbr_idx, dtype=np.int32)
        nbr_w = np.asarray(self.nbr_w, dtype=np.float64)
        beta = np.asarray(self.beta, dtype=np.float64)
        if self_w.ndim != 2:
            raise ValueError(f"self_w must be (R, K), got {self_w.shape}")
        r, k = self_w.shape
        for name, arr in (("nbr_idx", nbr_idx), ("nbr_w", nbr_w), ("beta", beta)):
            if arr.ndim != 3 or arr.shape[:2] != (r, k):
                raise ValueError(
                    f"{name} must be (R, K, D) matching self_w {self_w.shape}, "
                    f"got {arr.shape}"
                )
        if nbr_idx.shape != nbr_w.shape or nbr_w.shape != beta.shape:
            raise ValueError("nbr_idx, nbr_w, beta must share one (R, K, D) shape")
        if (nbr_idx < 0).any() or (nbr_idx >= k).any():
            raise ValueError("nbr_idx entries must index peers in [0, K)")
        if self.stochasticity not in ("row", "column"):
            raise ValueError(
                f"stochasticity must be 'row' or 'column', got {self.stochasticity!r}"
            )
        object.__setattr__(self, "self_w", self_w)
        object.__setattr__(self, "nbr_idx", nbr_idx)
        object.__setattr__(self, "nbr_w", nbr_w)
        object.__setattr__(self, "beta", beta)

    @property
    def period(self) -> int:
        """R, the number of rounds before the schedule repeats."""
        return self.self_w.shape[0]

    @property
    def num_peers(self) -> int:
        """K, the number of peers."""
        return self.self_w.shape[1]

    @property
    def degree_bound(self) -> int:
        """D, the padded per-peer neighbor-slot width."""
        return self.nbr_idx.shape[2]

    def round_edges(self, r: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Round ``r``'s edge list: (senders, receivers, weights) over the
        real (non-padding) slots, j -> i for each weight W[i, j]."""
        r = r % self.period
        recv, slot = np.nonzero(self.nbr_idx[r] != np.arange(self.num_peers)[:, None])
        send = self.nbr_idx[r, recv, slot]
        return send, recv.astype(np.int64), self.nbr_w[r, recv, slot]

    def to_dense(self) -> tuple[np.ndarray, np.ndarray]:
        """Scatter back to dense (R, K, K) (w, beta) stacks.

        Padding slots carry weight 0.0 and target the diagonal, so the
        scatter-add leaves every dense entry exactly equal to the value it
        was built from.  For the small-K tests: at K = 4096 this builds the
        very arrays the sparse form avoids.
        """
        r, k, _ = self.nbr_idx.shape
        rows = np.arange(k)[None, :, None]
        rr = np.arange(r)[:, None, None]
        w = np.zeros((r, k, k))
        w[rr[..., 0], rows[..., 0], rows[..., 0]] = self.self_w
        where = (np.broadcast_to(rr, self.nbr_idx.shape),
                 np.broadcast_to(rows, self.nbr_idx.shape), self.nbr_idx)
        np.add.at(w, where, self.nbr_w)
        beta = np.zeros((r, k, k))
        np.add.at(beta, where, self.beta)
        return w, beta

    @classmethod
    def from_dense(
        cls,
        w_stack: np.ndarray,
        beta_stack: np.ndarray,
        *,
        stochasticity: str = "row",
        degree_bound: int | None = None,
        name: str = "static",
    ) -> "SparseSchedule":
        """Verbatim extraction from dense (R, K, K) stacks.

        The neighbor pattern of row i is the union of the nonzero off-diagonal
        ``w`` and nonzero ``beta`` entries; values are copied bit for bit, so
        the round trip through ``to_dense`` is exact.
        """
        w_stack = np.asarray(w_stack, dtype=np.float64)
        beta_stack = np.asarray(beta_stack, dtype=np.float64)
        if w_stack.ndim != 3 or w_stack.shape != beta_stack.shape:
            raise ValueError(
                "w/beta must be matching (R, K, K) stacks, got "
                f"{w_stack.shape} and {beta_stack.shape}"
            )
        r, k, _ = w_stack.shape
        pattern = ((w_stack != 0) | (beta_stack != 0)) & ~np.eye(k, dtype=bool)
        if degree_bound is None:
            degree_bound = max(1, int(pattern.sum(axis=2).max(initial=0)))
        rows = np.arange(k)[:, None]
        self_w = np.empty((r, k))
        idx = np.empty((r, k, degree_bound), np.int32)
        nbr_w = np.empty((r, k, degree_bound))
        beta_p = np.empty((r, k, degree_bound))
        for t in range(r):
            ix, valid = _padded_in_neighbors(pattern[t], degree_bound)
            self_w[t] = np.diagonal(w_stack[t])
            idx[t] = ix
            nbr_w[t] = np.where(valid, w_stack[t][rows, ix], 0.0)
            beta_p[t] = np.where(valid, beta_stack[t][rows, ix], 0.0)
        return cls(self_w, idx, nbr_w, beta_p, stochasticity=stochasticity, name=name)

    @classmethod
    def from_schedule(
        cls,
        schedule: GraphSchedule,
        mixing: str = "data_weighted",
        *,
        data_sizes: Sequence[int] | None = None,
        consensus_step_size: float | np.ndarray = 1.0,
        stochasticity: str = "row",
        degree_bound: int | None = None,
    ) -> "SparseSchedule":
        """Direct sparse build from the graphs, with no (K, K) float array.

        The exact values of ``schedule_matrices`` + ``from_dense`` (the same
        float64 expressions, the same summation order) at any K; the neighbor
        pattern is the adjacency itself.  ``stochasticity`` "row" builds
        gossip's weights, "column" push-sum's.
        """
        if stochasticity == "row":
            weights = _sparse_row_weights
        elif stochasticity == "column":
            weights = _sparse_col_weights
        else:
            raise ValueError(f"unknown stochasticity {stochasticity!r}; 'row' or 'column'")
        k = schedule.num_peers
        n = _check_data_sizes(data_sizes, k)
        eps = _check_eps(consensus_step_size, k)
        if degree_bound is None:
            degree_bound = max(1, schedule.max_degree())
        self_w, idx, nbr_w, beta = [], [], [], []
        for g in schedule.graphs:
            ix, valid = _padded_in_neighbors(g.adjacency.T, degree_bound)
            sw, nw = weights(g, mixing, n, eps, ix, valid)
            self_w.append(sw)
            idx.append(ix)
            nbr_w.append(nw)
            beta.append(_sparse_beta(n, ix, valid))
        return cls(
            np.stack(self_w), np.stack(idx), np.stack(nbr_w), np.stack(beta),
            stochasticity=stochasticity, name=schedule.name,
        )


# ---------------------------------------------------------------------------
# Adaptive (state-dependent) partner selection: torch, on the run's device
# ---------------------------------------------------------------------------

ADAPTIVE_RULES = ("loss_proximity", "random", "eps_greedy")

_MATCH_INF = 1e30  # sentinel: masked (used-up) score entries, float32


def partner_scores(
    losses: torch.Tensor,  # (K,) per-peer recent training losses
    key: torch.Tensor,  # (2,) int64 threefry key (``core.prng``) for this round
    rule: str = "loss_proximity",
    eps: float = 0.1,
) -> torch.Tensor:
    """Symmetric (K, K) float32 pairing scores, lower a more desirable partner
    (the reference's ``partner_scores``): "loss_proximity" |l_i - l_j|;
    "random" ``0.5 (u + u^T)`` with u uniform from the key's second split;
    "eps_greedy" the random scores when a Bernoulli(eps) coin from its
    first split comes up, else the loss scores."""
    if rule not in ADAPTIVE_RULES:
        raise ValueError(f"unknown partner rule {rule!r}; one of {ADAPTIVE_RULES}")
    k = losses.shape[0]
    lf = losses.to(torch.float32)
    loss_s = (lf[:, None] - lf[None, :]).abs()
    if rule == "loss_proximity":
        return loss_s
    key_coin, key_scores = prng.split(key)
    u = prng.uniform(key_scores, (k, k))
    rand_s = 0.5 * (u + u.T)
    if rule == "random":
        return rand_s
    return torch.where(prng.bernoulli(key_coin, eps), rand_s, loss_s)


def greedy_matching(scores: torch.Tensor) -> torch.Tensor:
    """Greedy minimum-score matching over a symmetric (K, K) score matrix
    (the reference's ``greedy_matching``): ``partner`` (K,) int64, with
    ``partner[k] == k`` for the one peer an odd K leaves unmatched.

    K // 2 fixed steps of "take the global argmin pair, then mask both
    peers"; ties go to the first flat index (``torch.argmin``'s rule on
    either device).  Every step is a kernel of fixed shape and the "pairs
    left" flag stays a device boolean, so the loop runs inside a captured
    round with no read back to the host.
    """
    k = scores.shape[0]
    dev = scores.device
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    s = torch.where(eye, _MATCH_INF, scores.to(torch.float32))
    idx = torch.arange(k, device=dev)
    partner = idx
    for _ in range(k // 2):
        flat = torch.argmin(s.reshape(-1)).reshape(1)
        i, j = flat // k, flat % k
        ok = s.reshape(-1).gather(0, flat) < _MATCH_INF  # all masked: no pairs left
        paired = torch.where(idx == j, i, torch.where(idx == i, j, partner))
        partner = torch.where(ok, paired, partner)
        used = (idx == i) | (idx == j)
        s = torch.where(ok & (used[:, None] | used[None, :]), _MATCH_INF, s)
    return partner


def matching_matrices(
    partner: torch.Tensor,  # (K,) int, symmetric (partner[partner[k]] == k)
    *,
    data_sizes: torch.Tensor | None = None,
    consensus_step_size: float = 1.0,
    stochasticity: str = "row",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, Beta) float32 of a pairwise matching round (the reference's
    ``matching_matrices``): row form (gossip) ``W[k, p] = n_p / (n_k +
    n_p)`` at p = partner[k], the diagonal the remainder; column form
    (push-sum) ``n_k / (n_k + n_p)`` and columns summing to 1; then the
    paper's epsilon, ``(1 - eps) I + eps W`` row- (column-) wise.  Beta is
    one-hot at the partner, all-zero for an unmatched peer."""
    if stochasticity not in ("row", "column"):
        raise ValueError(f"unknown stochasticity {stochasticity!r}; 'row' or 'column'")
    k = partner.shape[0]
    dev = partner.device
    idx = torch.arange(k, device=dev)
    n = (torch.ones(k, dtype=torch.float32, device=dev) if data_sizes is None
         else torch.as_tensor(data_sizes, dtype=torch.float32, device=dev))
    matched = partner != idx
    adj = (partner[:, None] == idx[None, :]) & matched[:, None]
    denom = n[:, None] + n[None, :]
    beta = adj.to(torch.float32)
    eps = torch.full((k,), consensus_step_size, dtype=torch.float32, device=dev)
    eye = torch.eye(k, dtype=torch.float32, device=dev)
    if stochasticity == "row":
        off = torch.where(adj, n[None, :] / denom, 0.0)
        w = off + torch.diag(1.0 - off.sum(dim=1))
        w = (1.0 - eps)[:, None] * eye + eps[:, None] * w
    else:
        off = torch.where(adj, n[:, None] / denom, 0.0)
        w = off + torch.diag(1.0 - off.sum(dim=0))
        w = (1.0 - eps)[None, :] * eye + eps[None, :] * w
    return w, beta


def adaptive_round_matrices(
    losses: torch.Tensor,  # (K,) per-peer recent training losses
    key: torch.Tensor,  # (2,) int64 key for this round
    *,
    rule: str = "loss_proximity",
    eps: float = 0.1,
    data_sizes: torch.Tensor | None = None,
    consensus_step_size: float = 1.0,
    stochasticity: str = "row",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One adaptive round's (W, Beta) on the losses' device: scores, greedy
    matching, stochastic matrices (the reference's
    ``adaptive_round_matrices``)."""
    partner = greedy_matching(partner_scores(losses, key, rule, eps))
    return matching_matrices(partner, data_sizes=data_sizes,
                             consensus_step_size=consensus_step_size,
                             stochasticity=stochasticity)


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2| of the mixing matrix — the consensus rate.

    For row-stochastic (not necessarily symmetric) W the eigenvalues are
    ranked by magnitude; lambda_1 = 1 always.
    """
    eig = np.sort(np.abs(np.linalg.eigvals(w)))[::-1]
    if len(eig) < 2:
        return 1.0
    return float(1.0 - eig[1])

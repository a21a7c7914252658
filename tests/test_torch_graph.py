"""Port parity, graphs: adjacencies and the float64 W / Beta matrices, row-
and column-stochastic, equal ``repro.core.graph`` bit for bit
(``array_equal``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

# (topology, K, data sizes): noniid_k2, iid_k100, a ring of 8 unequal shards,
# and the isolated baseline's disconnected pair
CASES = {
    "noniid_k2": ("complete", 2, np.array([100, 100])),
    "iid_k100": ("complete", 100, np.full(100, 600)),
    "ring": ("ring", 8, np.arange(1, 9) * 30),
    "isolated": ("disconnected", 2, np.array([100, 100])),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mixing", ["data_weighted", "metropolis", "uniform_neighbor",
                                    "identity"])
def test_matrices_equal(case, mixing):
    topology, k, sizes = CASES[case]
    jg, tg = jgraph.build_graph(topology, k), tgraph.build_graph(topology, k)
    np.testing.assert_array_equal(tg.adjacency, jg.adjacency)
    for eps in (1.0, 0.5):
        np.testing.assert_array_equal(
            tgraph.mixing_matrix(tg, mixing, data_sizes=sizes, consensus_step_size=eps),
            jgraph.mixing_matrix(jg, mixing, data_sizes=sizes, consensus_step_size=eps),
        )
    np.testing.assert_array_equal(
        tgraph.affinity_matrix(tg, data_sizes=sizes),
        jgraph.affinity_matrix(jg, data_sizes=sizes),
    )
    got = tgraph.schedule_matrices(tgraph.static_schedule(tg), mixing, data_sizes=sizes)
    want = jgraph.schedule_matrices(jgraph.static_schedule(jg), mixing, data_sizes=sizes)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("topology,k", [
    ("complete", 5), ("ring", 7), ("chain", 6), ("star", 6), ("torus2d", 9),
    ("erdos_renyi", 10), ("hypercube", 8), ("disconnected", 4), ("directed_ring", 5),
])
def test_topologies_equal(topology, k):
    jg = jgraph.build_graph(topology, k, p=0.3, seed=2)
    tg = tgraph.build_graph(topology, k, p=0.3, seed=2)
    np.testing.assert_array_equal(tg.adjacency, jg.adjacency)
    assert tg.directed == jg.directed
    assert tg.max_degree() == jg.max_degree()
    assert tg.is_connected() == jg.is_connected()
    assert tg.is_strongly_connected() == jg.is_strongly_connected()
    np.testing.assert_array_equal(tg.out_degree(), jg.out_degree())


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_mixing_equal(case):
    topology, k, sizes = CASES[case]
    w = jgraph.mixing_matrix(jgraph.build_graph(topology, k), data_sizes=sizes)
    for dmax in (None, k + 1):
        got = tconsensus.sparse_mixing(w, dmax=dmax)
        want = jconsensus.sparse_mixing(w, dmax=dmax)
        for g, ww in zip(got, want):
            assert g.dtype == ww.dtype
            np.testing.assert_array_equal(g, ww)
    np.testing.assert_array_equal(tconsensus.mixing_degrees(w), jconsensus.mixing_degrees(w))


@pytest.mark.parametrize("experiment", ["noniid_k2", "iid_k100"])
def test_protocol_constants_equal(experiment):
    jexp = getattr(jconfigs, experiment)()
    texp = getattr(tconfigs, experiment)()
    sizes = np.full(jexp.p2p.num_peers, 100 if experiment == "noniid_k2" else 600)
    jc, _ = jp2p.protocol_constants(jexp.p2p, sizes)
    tc, sched = tp2p.protocol_constants(texp.p2p, sizes)
    assert sched.period == 1 and sched.name == "static"
    np.testing.assert_array_equal(tc.w, jc.w)
    np.testing.assert_array_equal(tc.beta, jc.beta)


# push-sum's topologies: the directed ring, and undirected graphs (where
# metropolis gives gossip's doubly stochastic matrix) down to no edges at all
COLUMN_CASES = {
    "directed_ring": ("directed_ring", 8, np.arange(1, 9) * 30),
    "complete": ("complete", 5, np.array([10, 20, 30, 40, 50])),
    "ring": ("ring", 7, np.arange(3, 10)),
    "disconnected": ("disconnected", 3, np.array([100, 100, 50])),
}


@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
@pytest.mark.parametrize("mixing", ["data_weighted", "metropolis", "uniform_neighbor",
                                    "identity"])
def test_column_stochastic_matrices_equal(case, mixing):
    topology, k, sizes = COLUMN_CASES[case]
    jg, tg = jgraph.build_graph(topology, k), tgraph.build_graph(topology, k)
    for eps in (1.0, 0.5, np.linspace(0.2, 1.0, k)):
        got = tgraph.column_stochastic_matrix(tg, mixing, data_sizes=sizes,
                                              consensus_step_size=eps)
        want = jgraph.column_stochastic_matrix(jg, mixing, data_sizes=sizes,
                                               consensus_step_size=eps)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    got = tgraph.schedule_matrices(tgraph.static_schedule(tg), mixing, data_sizes=sizes,
                                   stochasticity="column")
    want = jgraph.schedule_matrices(jgraph.static_schedule(jg), mixing, data_sizes=sizes,
                                    stochasticity="column")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if mixing == "metropolis" and not tg.directed:
        np.testing.assert_array_equal(got[0][0], tgraph.mixing_matrix(tg, mixing))


def test_column_stochastic_rejects_what_the_reference_rejects():
    g = tgraph.build_graph("directed_ring", 4)
    with pytest.raises(ValueError, match="data_sizes"):
        tgraph.column_stochastic_matrix(g, data_sizes=np.zeros(4))
    with pytest.raises(ValueError, match="mixing"):
        tgraph.column_stochastic_matrix(g, "max_degree")
    with pytest.raises(ValueError, match="consensus_step_size"):
        tgraph.column_stochastic_matrix(g, consensus_step_size=np.ones(3))
    with pytest.raises(ValueError, match="stochasticity"):
        tgraph.schedule_matrices(tgraph.static_schedule(g), stochasticity="diag")

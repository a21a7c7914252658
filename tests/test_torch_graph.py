"""Port parity, graphs: adjacencies and the float64 W / Beta matrices equal
``repro.core.graph`` bit for bit (``array_equal``)."""
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


def test_column_stochastic_is_not_ported():
    sched = tgraph.static_schedule(tgraph.build_graph("ring", 4))
    with pytest.raises(NotImplementedError, match="item 8"):
        tgraph.schedule_matrices(sched, stochasticity="column")

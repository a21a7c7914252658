"""Port parity, time-varying schedules: every schedule builder, undirected
and directed, ``build_schedule`` and ``schedule_matrices`` (row- and
column-stochastic) give adjacencies equal to ``repro.core.graph``'s
(``array_equal``) and float64 W / Beta equal bit for bit, for several seeds;
``spectral_gap`` and the schedule's union checks agree; and the config
checks of the time-varying and compression fields reject what the reference
rejects."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

SEEDS = (0, 1, 7)
UNDIRECTED = ("static", "link_dropout", "random_matching", "peer_churn", "round_robin")


def _assert_schedules_equal(got, want):
    assert got.name == want.name and got.period == want.period
    assert got.num_peers == want.num_peers and got.directed == want.directed
    for g, w in zip(got.graphs, want.graphs):
        np.testing.assert_array_equal(g.adjacency, w.adjacency)
    assert got.max_degree() == want.max_degree()
    np.testing.assert_array_equal(got.union_graph().adjacency, want.union_graph().adjacency)
    assert got.union_is_connected() == want.union_is_connected()
    assert got.union_is_strongly_connected() == want.union_is_strongly_connected()
    for r in (0, 1, got.period, 2 * got.period + 1):
        np.testing.assert_array_equal(got.graph_at(r).adjacency, want.graph_at(r).adjacency)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("topology,k", [("ring", 8), ("complete", 5), ("torus2d", 9)])
def test_link_dropout_equal(topology, k, seed):
    for q in (0.3, 0.7, 1.0):
        _assert_schedules_equal(
            tgraph.link_dropout_schedule(tgraph.build_graph(topology, k), q, 6, seed=seed),
            jgraph.link_dropout_schedule(jgraph.build_graph(topology, k), q, 6, seed=seed),
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [2, 7, 8])
def test_random_matching_equal(k, seed):
    _assert_schedules_equal(tgraph.random_matching_schedule(k, 5, seed=seed),
                            jgraph.random_matching_schedule(k, 5, seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("topology,k", [("ring", 8), ("star", 6)])
def test_peer_churn_equal(topology, k, seed):
    for p in (0.5, 0.8):
        _assert_schedules_equal(
            tgraph.peer_churn_schedule(tgraph.build_graph(topology, k), p, 6, seed=seed),
            jgraph.peer_churn_schedule(jgraph.build_graph(topology, k), p, 6, seed=seed),
        )


def test_round_robin_equal():
    topos = ("ring", "star", "complete", "disconnected")
    _assert_schedules_equal(
        tgraph.round_robin_schedule([tgraph.build_graph(t, 6) for t in topos]),
        jgraph.round_robin_schedule([jgraph.build_graph(t, 6) for t in topos]),
    )


def test_builder_argument_checks_match():
    for fn_t, fn_j, args in (
        (tgraph.link_dropout_schedule, jgraph.link_dropout_schedule, (0.0, 3)),
        (tgraph.link_dropout_schedule, jgraph.link_dropout_schedule, (0.5, 0)),
        (tgraph.peer_churn_schedule, jgraph.peer_churn_schedule, (1.5, 3)),
    ):
        with pytest.raises(ValueError):
            fn_j(jgraph.build_graph("ring", 4), *args)
        with pytest.raises(ValueError):
            fn_t(tgraph.build_graph("ring", 4), *args)
    with pytest.raises(ValueError):
        tgraph.random_matching_schedule(1, 3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [4, 8])
def test_directed_link_dropout_equal(k, seed):
    """On a directed base each one-way edge drops on its own."""
    for q in (0.3, 0.7, 1.0):
        _assert_schedules_equal(
            tgraph.link_dropout_schedule(tgraph.build_graph("directed_ring", k), q, 6,
                                         seed=seed),
            jgraph.link_dropout_schedule(jgraph.build_graph("directed_ring", k), q, 6,
                                         seed=seed),
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [2, 7, 8])
def test_one_way_matching_equal(k, seed):
    _assert_schedules_equal(tgraph.one_way_matching_schedule(k, 5, seed=seed),
                            jgraph.one_way_matching_schedule(k, 5, seed=seed))
    with pytest.raises(ValueError):
        tgraph.one_way_matching_schedule(1, 3)
    with pytest.raises(ValueError):
        tgraph.one_way_matching_schedule(k, 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("schedule", ["static", "link_dropout", "one_way_matching"])
def test_directed_build_schedule_and_column_matrices_equal(schedule, seed):
    """``directed_k8``'s schedules and their column-stochastic (push-sum)
    and row-stochastic (gossip) matrices."""
    kw = dict(schedule=schedule, schedule_rounds=5)
    jcfg = dataclasses.replace(jconfigs.directed_k8(**kw).p2p, schedule_seed=seed)
    tcfg = dataclasses.replace(tconfigs.directed_k8(**kw).p2p, schedule_seed=seed)
    tsched, jsched = tp2p.build_schedule(tcfg), jp2p.build_schedule(jcfg)
    _assert_schedules_equal(tsched, jsched)
    assert tsched.directed
    sizes = np.arange(1, 9) * 37
    for mixing in ("data_weighted", "metropolis", "uniform_neighbor"):
        for stochasticity in ("column", "row"):
            kw = dict(data_sizes=sizes, consensus_step_size=0.7, stochasticity=stochasticity)
            got = tgraph.schedule_matrices(tsched, mixing, **kw)
            want = jgraph.schedule_matrices(jsched, mixing, **kw)
            for g, w in zip(got, want):
                assert g.dtype == np.float64 and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def _experiments(schedule, seed):
    kw = dict(schedule=schedule, schedule_rounds=5)
    jexp, texp = jconfigs.timevarying_k8(**kw), tconfigs.timevarying_k8(**kw)
    return (dataclasses.replace(jexp.p2p, schedule_seed=seed),
            dataclasses.replace(texp.p2p, schedule_seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("schedule", UNDIRECTED)
def test_build_schedule_and_matrices_equal(schedule, seed):
    jcfg, tcfg = _experiments(schedule, seed)
    tsched, jsched = tp2p.build_schedule(tcfg), jp2p.build_schedule(jcfg)
    _assert_schedules_equal(tsched, jsched)
    sizes = np.arange(1, 9) * 37
    for mixing in ("data_weighted", "metropolis"):
        got = tgraph.schedule_matrices(tsched, mixing, data_sizes=sizes, consensus_step_size=0.7)
        want = jgraph.schedule_matrices(jsched, mixing, data_sizes=sizes, consensus_step_size=0.7)
        for g, w in zip(got, want):
            assert g.dtype == np.float64 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    tc, _ = tp2p.protocol_constants(tcfg, sizes)
    jc, _ = jp2p.protocol_constants(jcfg, sizes)
    np.testing.assert_array_equal(tc.w, jc.w)
    np.testing.assert_array_equal(tc.beta, jc.beta)


def test_timevarying_k2_schedules_equal():
    for schedule in UNDIRECTED:
        jexp = jconfigs.timevarying_k2(schedule=schedule)
        texp = tconfigs.timevarying_k2(schedule=schedule)
        assert texp.name == jexp.name
        _assert_schedules_equal(tp2p.build_schedule(texp.p2p), jp2p.build_schedule(jexp.p2p))


def test_experiment_configs_match_reference():
    for builder, kw in (("timevarying_k2", {}), ("timevarying_k8", {}),
                        ("timevarying_k8", dict(schedule="round_robin", compressor="qint8")),
                        ("timevarying_k8", dict(compressor="topk", topk_frac=0.05))):
        jexp = getattr(jconfigs, builder)(**kw)
        texp = getattr(tconfigs, builder)(**kw)
        assert texp.name == jexp.name
        assert (texp.batch_size, texp.samples_per_class, texp.rounds, texp.peer_classes) == (
            jexp.batch_size, jexp.samples_per_class, jexp.rounds, jexp.peer_classes)
        assert dataclasses.asdict(texp.p2p) == dataclasses.asdict(jexp.p2p)


@pytest.mark.parametrize("topology,k", [("complete", 5), ("ring", 8), ("star", 6),
                                        ("disconnected", 3), ("complete", 1)])
def test_spectral_gap_matches(topology, k):
    sizes = np.arange(1, k + 1) * 10
    w = tgraph.mixing_matrix(tgraph.build_graph(topology, k), data_sizes=sizes)
    assert tgraph.spectral_gap(w) == jgraph.spectral_gap(w)


@pytest.mark.parametrize("kw", [
    dict(schedule_rounds=0),
    dict(topk_frac=0.0),
    dict(topk_frac=1.5),
    dict(schedule="round_robin"),
    dict(schedule="round_robin", round_robin_topologies=("ring", "mesh3d")),
    dict(schedule="round_robin", round_robin_topologies=("ring", 3)),
    dict(compressor="qint8", staleness_bound=2),
])
def test_config_checks_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jp2p.P2PConfig(**kw)
    with pytest.raises(ValueError) as got:
        tp2p.P2PConfig(**kw)
    if "staleness_bound" in kw:
        assert str(got.value) == str(want.value)  # the compatibility table's message


def test_round_robin_with_a_directed_member_equals_reference():
    kw = dict(num_peers=6, schedule="round_robin",
              round_robin_topologies=("ring", "directed_ring", "star"))
    tcfg, jcfg = tp2p.P2PConfig(**kw), jp2p.P2PConfig(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tsched, jsched = tp2p.build_schedule(tcfg), jp2p.build_schedule(jcfg)
    _assert_schedules_equal(tsched, jsched)
    assert tsched.directed and [g.directed for g in tsched.graphs] == [False, True, False]

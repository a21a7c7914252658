"""Port parity, the sparse degree-bounded schedule: ``graph.SparseSchedule``
built straight from the graphs equals ``repro.core.graph.SparseSchedule``
field for field (``array_equal``, float64) for every schedule and mixing,
row-stochastic (gossip) and column-stochastic (push-sum, on the directed
schedules too), scatters back to the float64 ``schedule_matrices`` exactly,
and round-trips through ``from_dense`` / ``to_dense``.  At K = 4096 the build
and the upload stay sparse: the dense builders are patched to raise.

The runtime's operands come from this form (``GossipProtocol.operands``), so
a round whose mixing weight is 0 on an edge keeps the edge's slot and its
affinity weight; ``ops.sparse_from_matrices`` takes the union of the W and
Beta patterns for the same reason."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as tops  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

K = 8
UNDIRECTED = ("static", "link_dropout", "random_matching", "peer_churn", "round_robin")
MIXINGS = ("data_weighted", "metropolis", "uniform_neighbor", "identity")
FIELDS = ("self_w", "nbr_idx", "nbr_w", "beta")


def _schedules(name, num_peers=K, topology="ring"):
    kw = dict(num_peers=num_peers, topology=topology, schedule=name, schedule_rounds=4,
              round_robin_topologies=("ring", "star") if name == "round_robin" else ())
    return tp2p.build_schedule(tp2p.P2PConfig(**kw)), jp2p.build_schedule(jp2p.P2PConfig(**kw))


def _assert_sparse_equal(got, want):
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.name, got.stochasticity) == (want.name, want.stochasticity)
    assert (got.period, got.num_peers, got.degree_bound) == (
        want.period, want.num_peers, want.degree_bound)


@pytest.mark.parametrize("eps", [1.0, 0.7])
@pytest.mark.parametrize("mixing", MIXINGS)
@pytest.mark.parametrize("name", UNDIRECTED)
def test_from_schedule_equals_reference(name, mixing, eps):
    tsched, jsched = _schedules(name)
    sizes = np.arange(3, 3 + K)
    kw = dict(data_sizes=sizes, consensus_step_size=eps)
    got = tgraph.SparseSchedule.from_schedule(tsched, mixing, **kw)
    _assert_sparse_equal(got, jgraph.SparseSchedule.from_schedule(jsched, mixing, **kw))
    w, beta = tgraph.schedule_matrices(tsched, mixing, **kw)
    w2, beta2 = got.to_dense()
    assert np.array_equal(w, w2) and np.array_equal(beta, beta2)


@pytest.mark.parametrize("name", UNDIRECTED)
def test_from_dense_round_trip_and_edges_equal_reference(name):
    tsched, _ = _schedules(name)
    w, beta = tgraph.schedule_matrices(tsched, "data_weighted", data_sizes=np.arange(1, K + 1))
    got = tgraph.SparseSchedule.from_dense(w, beta, name=name)
    want = jgraph.SparseSchedule.from_dense(w, beta, stochasticity="row", name=name)
    _assert_sparse_equal(got, want)
    w2, beta2 = got.to_dense()
    assert np.array_equal(w, w2) and np.array_equal(beta, beta2)
    _assert_sparse_equal(tgraph.SparseSchedule.from_dense(w2, beta2, name=name), got)
    for r in range(got.period + 2):
        for g, ww in zip(got.round_edges(r), want.round_edges(r)):
            assert g.dtype == ww.dtype
            np.testing.assert_array_equal(g, ww)


def test_degree_bound_validation():
    tsched, _ = _schedules("static")
    w, beta = tgraph.schedule_matrices(tsched, "data_weighted")
    # ring in-degree is 2: a bound of 1 must refuse, not truncate
    with pytest.raises(ValueError, match="degree"):
        tgraph.SparseSchedule.from_dense(w, beta, degree_bound=1)
    with pytest.raises(ValueError, match="degree"):
        tgraph.SparseSchedule.from_schedule(tsched, degree_bound=1)
    padded = tgraph.SparseSchedule.from_dense(w, beta, degree_bound=5)
    assert padded.degree_bound == 5
    _assert_sparse_equal(padded, jgraph.SparseSchedule.from_dense(w, beta, degree_bound=5))
    w2, beta2 = padded.to_dense()
    assert np.array_equal(w, w2) and np.array_equal(beta, beta2)
    # a bound past K (the reference fails to broadcast): padding slots only
    past = tgraph.SparseSchedule.from_dense(w, beta, degree_bound=K + 2)
    np.testing.assert_array_equal(past.nbr_idx[:, :, 5:], np.broadcast_to(
        np.arange(K, dtype=np.int32)[None, :, None], (1, K, K - 3)))
    w2, beta2 = past.to_dense()
    assert np.array_equal(w, w2) and np.array_equal(beta, beta2)


def test_invalid_arrays_and_stochasticity_rejected():
    tsched, _ = _schedules("static")
    sp = tgraph.SparseSchedule.from_schedule(tsched)
    with pytest.raises(ValueError, match="self_w"):
        tgraph.SparseSchedule(sp.self_w[0], sp.nbr_idx, sp.nbr_w, sp.beta)
    with pytest.raises(ValueError, match="nbr_w"):
        tgraph.SparseSchedule(sp.self_w, sp.nbr_idx, sp.nbr_w[:, :, :1], sp.beta)
    with pytest.raises(ValueError, match=r"\[0, K\)"):
        tgraph.SparseSchedule(sp.self_w, sp.nbr_idx + K, sp.nbr_w, sp.beta)
    with pytest.raises(ValueError, match="stochasticity"):
        tgraph.SparseSchedule(sp.self_w, sp.nbr_idx, sp.nbr_w, sp.beta, stochasticity="diag")
    column = dict(data_sizes=np.arange(1, K + 1), stochasticity="column")
    _assert_sparse_equal(tgraph.SparseSchedule.from_schedule(tsched, **column),
                         jgraph.SparseSchedule.from_schedule(_schedules("static")[1], **column))
    with pytest.raises(ValueError, match="stochasticity"):
        tgraph.SparseSchedule.from_schedule(tsched, stochasticity="diag")


@pytest.fixture
def no_dense_builders(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a dense (K, K) builder ran")

    for name in ("schedule_matrices", "mixing_matrix", "affinity_matrix"):
        monkeypatch.setattr(tgraph, name, refuse)


def test_large_k_build_and_upload_stay_sparse(no_dense_builders):
    """K = 4096 on a ring: no (K, K) float array is built, D stays the ring's
    in-degree (2), the values equal the reference's, and the runtime's upload
    is (R, K, D) float32."""
    bigk = 4096
    tsched, jsched = _schedules("static", num_peers=bigk)
    sizes = np.arange(bigk) % 7 + 5
    got = tgraph.SparseSchedule.from_schedule(tsched, "data_weighted", data_sizes=sizes)
    assert got.degree_bound == 2 and got.nbr_w.shape == (1, bigk, 2)
    _assert_sparse_equal(got, jgraph.SparseSchedule.from_schedule(
        jsched, "data_weighted", data_sizes=sizes))
    cfg = tp2p.P2PConfig(num_peers=bigk, topology="ring")
    ops_s = tp2p.schedule_operands(cfg, sizes, device="cpu")
    assert tuple(ops_s.nbr_idx.shape) == (1, bigk, 2) and ops_s.nbr_idx.dtype == torch.int32
    assert ops_s.beta.dtype == torch.float32
    np.testing.assert_array_equal(ops_s.beta.numpy(), got.beta.astype(np.float32))


@pytest.mark.parametrize("mixing,eps", [("identity", 1.0), ("data_weighted", 0.0)])
def test_operands_keep_beta_where_mixing_weight_is_zero(mixing, eps):
    """The fault fixed here: with W = I the operands used to have no slots,
    so d lost its affinity weights.  Both ways of building operands now keep
    them, equal to the reference's sparse schedule cast to float32."""
    g = tgraph.build_graph("ring", 6)
    sizes = np.arange(1, 7)
    w = tgraph.mixing_matrix(g, mixing, data_sizes=sizes, consensus_step_size=eps)
    beta = tgraph.affinity_matrix(g, data_sizes=sizes)
    assert np.array_equal(w, np.eye(6))
    want = jgraph.SparseSchedule.from_dense(w[None], beta[None])
    from_matrices = tops.sparse_from_matrices(w, beta)
    cfg = tp2p.P2PConfig(num_peers=6, topology="ring", mixing=mixing, consensus_step_size=eps)
    (from_schedule,) = tp2p.round_operands(cfg, sizes, device="cpu")
    for ops in (from_matrices, from_schedule):
        for field, t in zip(FIELDS, ops):
            np.testing.assert_array_equal(
                t.numpy(), getattr(want, field)[0].astype(t.numpy().dtype), err_msg=field)
        assert bool((ops.beta.sum(dim=1) == 1).all()) and bool((ops.nbr_w == 0).all())


DIRECTED = ("static", "link_dropout", "one_way_matching")


@pytest.mark.parametrize("eps", [1.0, 0.7])
@pytest.mark.parametrize("mixing", MIXINGS)
@pytest.mark.parametrize("name", DIRECTED)
def test_column_from_schedule_equals_reference_on_directed_schedules(name, mixing, eps):
    """Push-sum's column-stochastic sparse weights on the directed ring's
    schedules: equal to the reference's, and ``to_dense`` gives the float64
    ``schedule_matrices(..., stochasticity="column")`` exactly."""
    tsched, jsched = _schedules(name, topology="directed_ring")
    assert tsched.directed
    kw = dict(data_sizes=np.arange(3, 3 + K), consensus_step_size=eps, stochasticity="column")
    got = tgraph.SparseSchedule.from_schedule(tsched, mixing, **kw)
    _assert_sparse_equal(got, jgraph.SparseSchedule.from_schedule(jsched, mixing, **kw))
    w, beta = tgraph.schedule_matrices(tsched, mixing, **kw)
    w2, beta2 = got.to_dense()
    assert np.array_equal(w, w2) and np.array_equal(beta, beta2)


@pytest.mark.parametrize("name", UNDIRECTED)
def test_column_from_schedule_equals_reference_on_undirected_schedules(name):
    tsched, jsched = _schedules(name)
    for mixing in MIXINGS:
        kw = dict(data_sizes=np.arange(3, 3 + K), stochasticity="column")
        got = tgraph.SparseSchedule.from_schedule(tsched, mixing, **kw)
        _assert_sparse_equal(got, jgraph.SparseSchedule.from_schedule(jsched, mixing, **kw))
        w, beta = tgraph.schedule_matrices(tsched, mixing, **kw)
        w2, beta2 = got.to_dense()
        assert np.array_equal(w, w2) and np.array_equal(beta, beta2)


@pytest.mark.parametrize("name", DIRECTED)
def test_column_from_dense_round_trip_equals_reference(name):
    tsched, _ = _schedules(name, topology="directed_ring")
    w, beta = tgraph.schedule_matrices(tsched, "data_weighted", data_sizes=np.arange(1, K + 1),
                                       stochasticity="column")
    got = tgraph.SparseSchedule.from_dense(w, beta, stochasticity="column", name=name)
    _assert_sparse_equal(got, jgraph.SparseSchedule.from_dense(w, beta, stochasticity="column",
                                                               name=name))
    w2, beta2 = got.to_dense()
    assert np.array_equal(w, w2) and np.array_equal(beta, beta2)


def test_push_sum_operands_are_the_column_schedule_in_float32():
    """``schedule_operands`` of a push-sum config uploads the column-stochastic
    sparse schedule, cast to float32 once."""
    cfg = tp2p.P2PConfig(num_peers=K, topology="directed_ring", protocol="push_sum",
                         schedule="link_dropout", schedule_rounds=4)
    sizes = np.arange(2, 2 + K)
    ops_s = tp2p.schedule_operands(cfg, sizes, device="cpu")
    want = jgraph.SparseSchedule.from_schedule(jp2p.build_schedule(jp2p.P2PConfig(
        num_peers=K, topology="directed_ring", protocol="push_sum", schedule="link_dropout",
        schedule_rounds=4)), data_sizes=sizes, stochasticity="column")
    for field, t in zip(FIELDS, ops_s):
        np.testing.assert_array_equal(t.numpy(), getattr(want, field).astype(t.numpy().dtype),
                                      err_msg=field)

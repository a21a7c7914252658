"""Port parity, push-sum over directed graphs (the ``directed_k8`` slice).

- The plain versions of the three consensus kernels' mass mode
  (``ref.consensus_mix_push_sum_stacked_ref``, ``segment_mix_push_sum_*`` and
  ``dequant_mix_push_sum_stacked_ref``, the CPU paths of their wrappers)
  against the reference's Pallas push-sum path, run in interpret mode, on
  every round of a directed ring, a one-way matching and a directed dropout
  schedule; the compressed one against ``PushSumProtocol.mix_compressed``.
  Tolerance atol 5e-5 / rtol 1e-4, the mass included.
- The round (ROADMAP level 3): ``directed_k8`` reduced (T = 2, fp32) from
  exported parameters, 3 rounds, static, link dropout and one-way matching
  free-running, qint8 and top-k teacher-forced (see
  ``tests/test_torch_round.py``): params, d and mass allclose to the
  reference's after both phases.  The hierarchical runtimes' rounds are in
  ``tests/test_torch_hier_round.py``.
- Behaviour (level 4): the ports of the reference's push-sum invariants
  (``tests/test_protocols.py``) and of its ``directed_k8`` training test.
- The configuration, the protocol registry, the CLI.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.data import partition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels.consensus_mix import ops as jops  # noqa: E402
from repro.kernels.consensus_mix import ref as jref  # noqa: E402
from repro.kernels.consensus_mix import segment as jsegment  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import protocols as tprotocols  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant, ops, ref, segment  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
K = 8
T = 10
N = 40
ROUNDS = 3
DIRECTED = ("directed_ring", "one_way_matching", "directed_dropout")


def _schedules(name, graph_lib, k=K):
    if name == "one_way_matching":
        return graph_lib.one_way_matching_schedule(k, 5, seed=2)
    if name == "directed_dropout":
        return graph_lib.link_dropout_schedule(graph_lib.build_graph("directed_ring", k), 0.6,
                                               5, seed=2)
    return graph_lib.static_schedule(graph_lib.build_graph("directed_ring", k))


def _push_sum_inputs(name, seed=0):
    """The reference's dense constants and stacked sparse operands, the
    port's operands (``PushSumProtocol.operands``, CPU), data sizes, a
    (K, N) parameter buffer and the reference's initial mass."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 50, K)
    jsched, tsched = _schedules(name, jgraph), _schedules(name, tgraph)
    jproto = jprotocols.get_protocol("push_sum")
    consts = jproto.constants(jsched, "data_weighted", data_sizes=sizes)
    jsparse = jops.sparse_from_schedule(consts.w, consts.beta)
    tops = tprotocols.get_protocol("push_sum").operands(tsched, "data_weighted",
                                                         data_sizes=sizes, device="cpu")
    x = rng.normal(size=(K, N)).astype(np.float32)
    mass = np.array(jproto.init_state({"w": jnp.asarray(x)}, sizes).mass)
    return consts, jsparse, tops, sizes, x, mass


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=what)


@pytest.mark.parametrize("name", DIRECTED)
def test_consensus_mix_plain_version_matches_pallas_push_sum(name):
    """Every round of the schedule: the port's ``consensus_mix_push_sum_stacked``
    on CPU tensors (its plain version) against the reference's
    ``consensus_mix_push_sum_schedule`` (Pallas, interpret mode): mixed, d
    and the new mass, with sum y = K kept."""
    consts, jsparse, tops, _, x, mass = _push_sum_inputs(name)
    for r in range(consts.w.shape[0]):
        jm, jd, jmass = jops.consensus_mix_push_sum_schedule(
            {"w": jnp.asarray(x)}, jnp.asarray(mass), jnp.asarray(r, jnp.int32), *jsparse, T)
        tm, td, tmass = ops.consensus_mix_push_sum_stacked(
            torch.as_tensor(x), torch.as_tensor(mass), ops.select_round(tops, r), T)
        _close(tm, jm["w"], f"{name} round {r} mixed")
        _close(td, jd["w"], f"{name} round {r} d")
        _close(tmass, jmass, f"{name} round {r} mass")
        np.testing.assert_allclose(float(tmass.sum()), K, rtol=1e-5)
        assert bool((tmass > 0).all())
        x, mass = np.array(jm["w"]), np.array(jmass)


@pytest.mark.parametrize("name", DIRECTED)
def test_segment_mix_plain_version_matches_pallas_push_sum(name):
    """The segment kernel's push-sum mode: the port's schedule wrapper (its
    plain version on CPU) against the reference's ``segment_mix_push_sum_stacked``
    (interpret mode) on the round's slots, and the two dense oracles
    (``segment_mix_push_sum_ref``) against each other."""
    consts, jsparse, tops, _, x, mass = _push_sum_inputs(name, seed=1)
    for r in range(consts.w.shape[0]):
        jm, jd, jmass = jsegment.segment_mix_push_sum_stacked(
            {"w": jnp.asarray(x)}, jnp.asarray(mass), *(a[r] for a in jsparse), T)
        tm, td, tmass = segment.segment_mix_push_sum_schedule(
            torch.as_tensor(x), torch.as_tensor(mass), r, tops, T)
        _close(tm, jm["w"], f"{name} round {r} mixed")
        _close(td, jd["w"], f"{name} round {r} d")
        _close(tmass, jmass, f"{name} round {r} mass")
        dense_j = jref.segment_mix_push_sum_ref(jnp.asarray(x), jnp.asarray(mass),
                                                jnp.asarray(consts.w[r], jnp.float32),
                                                jnp.asarray(consts.beta[r], jnp.float32), T)
        dense_t = ref.segment_mix_push_sum_ref(
            torch.as_tensor(x), torch.as_tensor(mass),
            torch.as_tensor(consts.w[r]), torch.as_tensor(consts.beta[r]), T)
        for g, w, what in zip(dense_t, dense_j, ("mixed", "d", "mass")):
            _close(g, w, f"{name} round {r} dense {what}")
        x, mass = np.array(jm["w"]), np.array(jmass)


@pytest.mark.parametrize("payload", [True, False])
@pytest.mark.parametrize("name", DIRECTED)
def test_dequant_mix_plain_version_matches_mix_compressed(name, payload):
    """Compressed push-sum: ``dequant_mix_push_sum_stacked`` on CPU tensors
    against the reference's ``PushSumProtocol.mix_compressed`` on the
    advanced estimates (and d from them), every round; ``payload=False`` is
    top-k's call, estimates already advanced."""
    consts, _, tops, _, x, mass = _push_sum_inputs(name, seed=2)
    rng = np.random.default_rng(3)
    leaf_offsets = (0, 13, 30, N)
    jproto = jprotocols.get_protocol("push_sum")
    for r in range(consts.w.shape[0]):
        est = x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
        q = scale = None
        adv = est
        if payload:
            q = rng.integers(-127, 128, x.shape).astype(np.int8)
            scale = rng.uniform(0, 1e-3, (K, len(leaf_offsets) - 1)).astype(np.float32)
            cols = np.repeat(np.arange(len(leaf_offsets) - 1), np.diff(leaf_offsets))
            adv = est + q.astype(np.float32) * scale[:, cols]
        got = dequant.dequant_mix_push_sum_stacked(
            torch.as_tensor(x), torch.as_tensor(est),
            None if q is None else torch.as_tensor(q),
            None if scale is None else torch.as_tensor(scale),
            torch.as_tensor(mass), ops.select_round(tops, r), leaf_offsets, T)
        rc = jprotocols.round_constants(jprotocols.ProtocolConstants(
            jnp.asarray(consts.w, jnp.float32), jnp.asarray(consts.beta, jnp.float32)), r)
        jstate, jm = jproto.mix_compressed(jprotocols.PushSumState(jnp.asarray(mass)),
                                           {"w": jnp.asarray(x)}, {"w": jnp.asarray(adv)}, rc)
        beta = consts.beta[r].astype(np.float32)
        has = beta.sum(axis=1) > 0
        want_d = np.where(has[:, None], (beta @ adv - adv) / T, 0.0)
        _close(got[0], jm["w"], f"{name} round {r} mixed")
        _close(got[1], want_d, f"{name} round {r} d")
        _close(got[2], adv, f"{name} round {r} advanced estimates")
        _close(got[3], jstate.mass, f"{name} round {r} mass")
        x, mass = np.array(jm["w"]), np.array(jstate.mass)


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the three wrappers run their plain versions only."""
    _, _, tops, _, x, mass = _push_sum_inputs("directed_ring")
    for counter in (ops.launches, dequant.launches, segment.launches):
        counter.reset()
    xt, mt, one = torch.as_tensor(x), torch.as_tensor(mass), ops.select_round(tops, 0)
    ops.consensus_mix_push_sum_stacked(xt, mt, one, T)
    segment.segment_mix_push_sum_stacked(xt, mt, one, T)
    dequant.dequant_mix_push_sum_stacked(xt, xt.clone(), None, None, mt, one, (0, N), T)
    assert (ops.launches.count, dequant.launches.count, segment.launches.count) == (0, 0, 0)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrappers_reject_a_bad_mass(bad):
    _, _, tops, _, x, mass = _push_sum_inputs("directed_ring")
    m = torch.as_tensor(mass)
    m = m[:-1] if bad == "shape" else m.double()
    with pytest.raises(ValueError, match="mass"):
        ops.consensus_mix_push_sum_stacked(torch.as_tensor(x), m, ops.select_round(tops, 0), T)
    with pytest.raises(ValueError, match="mass"):
        segment.segment_mix_push_sum_schedule(torch.as_tensor(x), m, 0, tops, T)


# -- the configuration and the protocol ---------------------------------------


@pytest.mark.parametrize("kw", [
    dict(protocol="push_sum"),
    dict(topology="directed_ring"),
    dict(schedule="one_way_matching"),
    dict(schedule="round_robin", round_robin_topologies=("ring", "directed_ring")),
    dict(protocol="push_sum", topology="directed_ring", schedule="link_dropout"),
])
def test_directed_configs_construct_as_the_reference(kw):
    assert dataclasses.asdict(tp2p.P2PConfig(**kw)) == dataclasses.asdict(jp2p.P2PConfig(**kw))


def test_push_sum_is_registered():
    proto = tprotocols.get_protocol("push_sum")
    assert isinstance(proto, tprotocols.PushSumProtocol)
    assert (proto.name, proto.stochasticity, proto.directed_capable) == ("push_sum", "column",
                                                                         True)
    assert not tprotocols.get_protocol("gossip").directed_capable
    assert set(tprotocols.protocol_names()) == set(jprotocols.protocol_names())


@pytest.mark.parametrize("sizes", [None, np.array([3, 1, 4, 1, 5, 9, 2, 6])])
def test_init_mass_equals_reference(sizes):
    x = np.zeros((K, 3), np.float32)
    want = jprotocols.get_protocol("push_sum").init_state({"w": jnp.asarray(x)}, sizes).mass
    got = tprotocols.get_protocol("push_sum").init_state(torch.as_tensor(x), sizes).mass
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="positive"):
        tprotocols.get_protocol("push_sum").init_state(torch.as_tensor(x), np.zeros(K))


@pytest.mark.parametrize("schedule", ["static", "link_dropout", "one_way_matching"])
def test_directed_k8_experiment_and_constants_equal_reference(schedule):
    jexp = jconfigs.directed_k8(schedule=schedule)
    texp = tconfigs.directed_k8(schedule=schedule)
    assert texp.name == jexp.name
    assert (texp.batch_size, texp.samples_per_class, texp.rounds, texp.peer_classes) == (
        jexp.batch_size, jexp.samples_per_class, jexp.rounds, jexp.peer_classes)
    assert dataclasses.asdict(texp.p2p) == dataclasses.asdict(jexp.p2p)
    sizes = np.array([150, 150, 150, 150, 100, 100, 100, 100])
    tc, tsched = tp2p.protocol_constants(texp.p2p, sizes)
    jc, jsched = jp2p.protocol_constants(jexp.p2p, sizes)
    assert tsched.directed and jsched.directed
    np.testing.assert_array_equal(tc.w, jc.w)
    np.testing.assert_array_equal(tc.beta, jc.beta)
    np.testing.assert_allclose(tc.w.sum(axis=1), 1.0)  # every round column-stochastic


def test_gossip_on_a_directed_schedule_warns_as_the_reference():
    jcfg = jconfigs.directed_k8(protocol="gossip").p2p
    tcfg = tconfigs.directed_k8(protocol="gossip").p2p
    with pytest.warns(UserWarning) as want:
        jp2p.protocol_constants(jcfg)
    with pytest.warns(UserWarning) as got:
        tp2p.protocol_constants(tcfg)
    assert str(got[0].message) == str(want[0].message)
    with pytest.warns(UserWarning, match="row-stochastic consensus point is biased"):
        tp2p.schedule_operands(tcfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp2p.protocol_constants(tconfigs.directed_k8().p2p)  # push-sum: no warning


# -- the round (ROADMAP level 3) ------------------------------------------------


def _leaves(tree):
    return {f"{layer}.{leaf}": np.asarray(tree[layer][leaf])
            for layer in ("fc1", "fc2", "out") for leaf in ("w", "b")}


def assert_state_close(tstate, jstate, what, tol=TOL):
    """params, momentum, d, b (and the estimate stack of a compressed wire)
    and the push-sum mass, allclose; the mass also sums to K."""
    layout = tp2p.layout_of("mnist_mlp")
    fields = ["params", "momentum", "d_bias", "b_bias"]
    if jstate.compression != ():
        fields.append("compression")
    for field in fields:
        got = layout.views(getattr(tstate, field))
        for name, want in _leaves(getattr(jstate, field)).items():
            np.testing.assert_allclose(got[name].numpy(), want, **tol,
                                       err_msg=f"{what} {field} {name}")
    mass = tstate.protocol.mass
    np.testing.assert_allclose(mass.numpy(), np.asarray(jstate.protocol.mass), **tol,
                               err_msg=f"{what} mass")
    np.testing.assert_allclose(float(mass.sum()), mass.shape[0], rtol=1e-5)
    assert bool((mass > 0).all()) and tstate.round_idx == int(jstate.round_idx)


def directed_case(schedule="static", compressor="none", local_steps=2, **rep):
    """The reduced ``directed_k8`` configs of both packages (T = 2, period 4)."""
    kw = dict(schedule=schedule, local_steps=local_steps, schedule_rounds=4)
    rep = dict(compressor=compressor, topk_frac=0.05) | rep
    jexp, texp = jconfigs.directed_k8(**kw), tconfigs.directed_k8(**kw)
    return (dataclasses.replace(jexp.p2p, **rep), dataclasses.replace(texp.p2p, **rep),
            list(jexp.peer_classes))


def start(jcfg, tcfg, classes, mnist_small, seed=0):
    """Both packages' initial states from the same exported parameters."""
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, classes, samples_per_class=50)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(seed)
    exported = jax.tree.map(
        np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, jcfg.num_peers)))
    task = ttask.get_task("mnist_mlp")
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jcfg, data_sizes=sizes)
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    assert_state_close(tstate, jstate, "init")
    return task, parts, sizes, jstate, tstate


@pytest.mark.parametrize("schedule", ["static", "link_dropout", "one_way_matching"])
def test_directed_k8_round_parity(schedule, mnist_small):
    """Free-running uncompressed push-sum rounds, 3 of them."""
    jcfg, tcfg, classes = directed_case(schedule)
    task, parts, sizes, jstate, tstate = start(jcfg, tcfg, classes, mnist_small)
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    tround = tp2p.make_round_fn(task, tcfg, data_sizes=sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    tbatch = tpipeline.PeerBatcher(parts, 10, seed=0)
    for r in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        tx, ty = tbatch.round_batches_on(tcfg.local_steps, torch.device("cpu"))
        jl, jc, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tc, tloss = tround(tstate, (tx, ty))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        assert_state_close(tl, jl, f"{schedule} round {r} after local")
        assert_state_close(tc, jc, f"{schedule} round {r} after consensus")
        jstate, tstate = jc, tc
    assert not np.allclose(np.asarray(jstate.protocol.mass), 1.0)  # the mass moved


@pytest.mark.parametrize("compressor", ["qint8", "topk"])
def test_directed_k8_compressed_round_parity_teacher_forced(compressor, mnist_small):
    """Compressed push-sum over directed link dropout, teacher-forced: each
    round both phases start from the reference's state."""
    jcfg, tcfg, classes = directed_case("link_dropout", compressor)
    task, parts, sizes, jstate, _ = start(jcfg, tcfg, classes, mnist_small)
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    ops_r = tp2p.round_operands(tcfg, sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    for r in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        jl, jc, _ = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        export = lambda s: interop.state_from_jax(jax.tree.map(np.asarray, s), task)  # noqa: E731
        tl, _ = tp2p.local_phase(export(jstate), task,
                                 (torch.as_tensor(bx), torch.as_tensor(by)), tcfg)
        assert_state_close(tl, jl, f"{compressor} round {r} after local")
        tc = tp2p.consensus_phase(export(jl), tcfg, ops_r[r % len(ops_r)])
        assert_state_close(tc, jc, f"{compressor} round {r} after consensus")
        jstate = jc


# -- behaviour (ports of tests/test_protocols.py and test_train_integration.py)


def _quiet_cfg(k, **kw):
    """A consensus-only 2NN config: lr 0, so the local phase moves nothing."""
    return tp2p.P2PConfig(algorithm="p2pl_affinity", num_peers=k, local_steps=1,
                          consensus_steps=1, lr=0.0, eta_d=0.5, protocol="push_sum", **kw)


@pytest.mark.parametrize("schedule,extra", [
    ("one_way_matching", {}),
    ("link_dropout", {"topology": "directed_ring"}),
    ("peer_churn", {"topology": "ring"}),
])
def test_push_sum_mass_conservation(schedule, extra, mnist_small):
    """sum_k y_k == K and y > 0 after every round of the full round function
    (2NN, T = 1) over directed and churning schedules."""
    k = 6
    cfg = dataclasses.replace(_quiet_cfg(k, schedule=schedule, schedule_rounds=7, **extra),
                              lr=0.05)
    x, y, _, _ = mnist_small
    classes = [(2 * i % 10, 2 * i % 10 + 1) for i in range(k)]
    parts = partition.pathological_partition(x, y, classes, samples_per_class=20)
    task = ttask.get_task("mnist_mlp")
    sizes = np.arange(1, k + 1) * 7
    state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    fn = tp2p.make_round_fn(task, cfg, data_sizes=sizes, device="cpu")
    batcher = tpipeline.PeerBatcher(parts, 10, seed=0)
    for _ in range(9):
        _, state, _ = fn(state, batcher.round_batches_on(1, torch.device("cpu")))
        mass = state.protocol.mass
        np.testing.assert_allclose(float(mass.sum()), k, rtol=1e-5)
        assert bool((mass > 0).all())


def _mix_many(protocol, sched, sizes, x0, steps, mixing="data_weighted"):
    proto = tprotocols.get_protocol(protocol)
    ops_s = proto.operands(sched, mixing, data_sizes=sizes, device="cpu")
    st, x = proto.init_state(x0, sizes), x0
    for r in range(steps):
        st, x, _ = proto.mix(st, x, ops.select_round(ops_s, r), T)
    return st, x


def test_push_sum_reaches_the_data_weighted_average():
    """Repeated push-sum steps on a directed ring drive every de-biased
    estimate to sum_j n_j x_j / sum_j n_j, which gossip on the same directed
    graph misses."""
    sched = tgraph.static_schedule(tgraph.build_graph("directed_ring", K))
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 50, K)
    x0 = torch.as_tensor(rng.normal(size=(K, 5)).astype(np.float32))
    target = (torch.as_tensor(sizes, dtype=torch.float32)[:, None] * x0).sum(0) / sizes.sum()
    _, push = _mix_many("push_sum", sched, sizes, x0, 400)
    _, gossip = _mix_many("gossip", sched, sizes, x0, 400)
    assert float((push - target).abs().max()) < 1e-3
    assert float((gossip - target).abs().max()) > 1e-2


def test_push_sum_on_a_directed_ring_converges():
    """Pure consensus rounds (lr 0) of the round function on a directed ring
    drive the consensus error of the de-biased estimates below 1e-3 of its
    start, to the data-weighted average."""
    cfg = dataclasses.replace(_quiet_cfg(K, topology="directed_ring"), algorithm="local_dsgd")
    sizes = np.arange(1, K + 1).astype(np.float64)
    proto = tprotocols.get_protocol("push_sum")
    ops_r = tp2p.round_operands(cfg, sizes, device="cpu")
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor(rng.normal(size=(K, 16)).astype(np.float32))
    state = tp2p.P2PState(x0, torch.zeros_like(x0), torch.zeros_like(x0), torch.zeros_like(x0),
                          round_idx=0, protocol=proto.init_state(x0, sizes))
    target = (torch.as_tensor(sizes, dtype=torch.float32)[:, None] * x0).sum(0) / sizes.sum()
    err0 = float(tconsensus.consensus_error(state.params))
    for _ in range(120):
        state = tp2p.consensus_phase(state, cfg, ops_r[0])
    assert float(tconsensus.consensus_error(state.params)) < 1e-3 * err0
    torch.testing.assert_close(state.params, target.expand(K, -1), atol=1e-3, rtol=0)


def test_push_sum_with_metropolis_on_undirected_equals_gossip():
    """On an undirected ring with doubly stochastic (metropolis) weights the
    mass stays 1 and push-sum is gossip."""
    k = 5
    sched = tgraph.static_schedule(tgraph.build_graph("ring", k))
    x0 = torch.as_tensor(np.random.default_rng(3).normal(size=(k, 6)).astype(np.float32))
    st, push = _mix_many("push_sum", sched, None, x0, 3, "metropolis")
    _, gossip = _mix_many("gossip", sched, None, x0, 3, "metropolis")
    torch.testing.assert_close(st.mass, torch.ones(k), rtol=1e-6, atol=0)
    torch.testing.assert_close(push, gossip, atol=1e-6, rtol=0)


def test_push_sum_isolated_peer_untouched():
    """A peer with no in- or out-edges keeps its parameters and its mass, and
    its d stays 0."""
    k = 4
    a = tgraph.build_graph("directed_ring", k).adjacency.copy()
    a[2, :] = a[:, 2] = False
    sched = tgraph.static_schedule(tgraph.CommGraph(a, directed=True))
    proto = tprotocols.get_protocol("push_sum")
    ops_s = proto.operands(sched, "uniform_neighbor", device="cpu")
    x0 = torch.as_tensor(np.random.default_rng(4).normal(size=(k, 3)).astype(np.float32))
    st, x, d = proto.mix(proto.init_state(x0), x0, ops.select_round(ops_s, 0), T)
    torch.testing.assert_close(x[2], x0[2], rtol=1e-6, atol=0)
    torch.testing.assert_close(st.mass[2], torch.tensor(1.0), rtol=1e-6, atol=0)
    assert bool((d[2] == 0).all()) and bool((d[0] != 0).any())


def test_directed_k8_push_sum_trains_and_differs_from_gossip(mnist_small):
    """The directed-ring push-sum experiment runs end to end: finite losses,
    consensus pulls the peers together, and its numbers differ from
    gossip's on the same run."""
    exp = tconfigs.directed_k8(schedule="static", protocol="push_sum")
    log, state = train.run_paper_experiment(exp, rounds=6, data=mnist_small, device="cpu",
                                            return_state=True)
    assert np.isfinite(log.train_loss).all()
    assert np.asarray(log.consensus_error).mean() < np.asarray(log.drift).mean()
    np.testing.assert_allclose(float(state.protocol.mass.sum()), K, rtol=1e-5)
    with pytest.warns(UserWarning, match="biased"):
        gossip = train.run_paper_experiment(tconfigs.directed_k8(protocol="gossip"), rounds=6,
                                            data=mnist_small, device="cpu")
    assert not np.allclose(log.consensus_error, gossip.consensus_error)


# -- the CLI --------------------------------------------------------------------


def _small_runs(monkeypatch, mnist_small):
    runs = []
    real = train.run_paper_experiment

    def run(exp, rounds=None, **kw):
        runs.append(exp)
        return real(exp, rounds=1, data=mnist_small, **kw)

    monkeypatch.setattr(train, "run_paper_experiment", run)
    return runs


@pytest.mark.parametrize("argv,protocol,schedule", [
    ([], "push_sum", "static"),
    (["--schedule", "one_way_matching"], "push_sum", "one_way_matching"),
    (["--schedule", "link_dropout", "--compressor", "qint8"], "push_sum", "link_dropout"),
    (["--peer-axis", "pod", "--peers-per-device", "8", "--mix-mode", "segment"], "push_sum",
     "static"),
])
def test_cli_runs_directed_k8(argv, protocol, schedule, monkeypatch, mnist_small, capsys):
    runs = _small_runs(monkeypatch, mnist_small)
    train.main(["--device", "cpu", "--experiment", "directed_k8", "--rounds", "1", *argv])
    assert "done in" in capsys.readouterr().out
    assert (runs[0].p2p.protocol, runs[0].p2p.schedule) == (protocol, schedule)


def test_cli_protocol_flag_reaches_any_experiment(monkeypatch, mnist_small, capsys):
    runs = _small_runs(monkeypatch, mnist_small)
    train.main(["--device", "cpu", "--experiment", "timevarying_k2", "--schedule",
                "round_robin", "--round-robin-topologies", "complete,disconnected",
                "--protocol", "push_sum", "--rounds", "1"])
    assert "done in" in capsys.readouterr().out
    assert runs[0].p2p.protocol == "push_sum"


def test_cli_rejects_undirected_schedules_for_directed_k8(capsys):
    with pytest.raises(SystemExit) as ex:
        train.main(["--device", "cpu", "--experiment", "directed_k8", "--schedule",
                    "peer_churn"])
    assert ex.value.code == 2
    assert "directed_k8 supports --schedule static|link_dropout|one_way_matching" in (
        capsys.readouterr().err)

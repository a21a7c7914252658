"""The port's sharded runtime (one process per peer) against its vmap runtime
and against the reference's, on the CPU: eight ranks over the gloo group.

The reference's acceptance contract (tests/test_mesh_runtime.py) is float32
bit-identity between the sharded and the vmap runtime on every schedule
family and both protocols; the compressed wire only has to be allclose.  The
grid runs in ONE module-scoped spawn of eight ranks
(``launch.pod.round_cases_rank``); the parametrized cases read their
results from it.  Each case is also held to the reference's
``make_round_fn`` at the float32 tolerance.  The lanes and ``sharded_k8``
are held to the reference's with ``==``, the collectives to the reference's
``mix_stacked``, the multipod steps to the reference's on the 2NN and on
reduced smollm-135m.
"""
import dataclasses
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import peer_group  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.launch import pod  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

K = 8
ROUNDS = 3  # crosses the period boundary (R = 2)
TOL = dict(atol=5e-5, rtol=1e-4)
SIZES = tuple(range(1, K + 1))

# the reference's grid (tests/test_mesh_runtime.py:56)
SCHEDULE_GRID = [
    ("static", {}),
    ("link_dropout", {}),
    ("round_robin", {"round_robin_topologies": ("ring", "star")}),
    ("one_way_matching", {}),
    ("random_matching", {}),
    ("peer_churn", {}),
    ("adaptive", {"partner_rule": "loss_proximity"}),
    ("adaptive", {"partner_rule": "eps_greedy"}),
]
GRID_IDS = [f"{s}-{e.get('partner_rule', '')}".rstrip("-") for s, e in SCHEDULE_GRID]


def _cfg(pkg, protocol="gossip", schedule="static", **extra):
    """The reference test's round config (P2PConfig of ``pkg``), on the 2NN."""
    return pkg.P2PConfig(
        algorithm="p2pl_affinity", num_peers=K, local_steps=2, consensus_steps=2, lr=0.01,
        momentum=0.3, eta_d=0.5, eta_b=0.1, topology="ring", protocol=protocol,
        schedule=schedule, schedule_rounds=2, **extra)


def _exported_init(seed=0):
    key = jax.random.PRNGKey(seed)
    return jax.tree.map(np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, K)))


def _flat_leaves(tree):
    return {f"{layer}.{leaf}": np.asarray(tree[layer][leaf])
            for layer in ("fc1", "fc2", "out") for leaf in ("w", "b")}


EXPORTED = _flat_leaves(_exported_init())


def _case(name, protocol="gossip", schedule="static", rounds=ROUNDS, **extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = _cfg(tp2p, protocol, schedule, **extra)
    return pod.RoundCase(name, cfg, rounds, SIZES, batch=5, init_params=EXPORTED)


PARITY = {f"{proto}-{gid}": _case(f"{proto}-{gid}", proto, sched, **extra)
          for proto in ("gossip", "push_sum")
          for gid, (sched, extra) in zip(GRID_IDS, SCHEDULE_GRID)}
PARITY |= {
    f"{proto}-stale": _case(f"{proto}-stale", proto, "round_robin",
                            round_robin_topologies=("ring", "star"), staleness_bound=2,
                            steps_profile="straggler")
    for proto in ("gossip", "push_sum")}
PARITY["gossip-linear-budgets"] = _case("gossip-linear-budgets", steps_profile="linear")
COMPRESSED = {
    "gossip-qint8": _case("gossip-qint8", compressor="qint8", rounds=3),
    "push_sum-qint8": _case("push_sum-qint8", "push_sum", "one_way_matching",
                            compressor="qint8", rounds=3),
    "gossip-topk": _case("gossip-topk", "gossip", "link_dropout", compressor="topk",
                         topk_frac=0.1, rounds=3),
}
SCAN = {  # the pod scan driver: one chunk of every round
    f"scan-{proto}-{sched}": _case(
        f"scan-{proto}-{sched}", proto, sched, rounds=2,
        **({"partner_rule": "loss_proximity"} if sched == "adaptive" else
           {"round_robin_topologies": ("ring", "star")} if sched == "round_robin" else {}))
    for proto in ("gossip", "push_sum") for sched in ("static", "round_robin", "adaptive")}
LEGACY = "legacy-whole-block"  # a case of pod.WholeBlockGossip, made in the grid fixture
MASS = _case("push_sum-mass", "push_sum", "one_way_matching", rounds=5)
WIDTH = _case("gossip-width-k", "gossip", "link_dropout", rounds=2)


@pytest.fixture(scope="module")
def grid():
    """Every case of the file through eight gloo ranks, one spawn: each
    rank's results, and the vmap runtime's last state of the whole-block
    protocol's case (that protocol is registered only meanwhile: other
    files check the registry)."""
    with pod.whole_block_protocol() as name:
        legacy = _case(LEGACY, name, rounds=3)
        cases = [*PARITY.values(), *COMPRESSED.values(), legacy, MASS]
        ranks = peer_group.spawn_peers(pod.grid_rank, K, "cpu",
                                       args=(cases, list(SCAN.values()), [WIDTH]),
                                       deadline=240)
        legacy_want = pod.vmap_rounds(legacy, "cpu")[-1][1]
    return ranks, legacy_want


@pytest.fixture(scope="module")
def vmap_runs():
    """The port's vmap runs of the cases, memoized."""
    cache = {}

    def get(case):
        if case.name not in cache:
            cache[case.name] = pod.vmap_rounds(case, "cpu")
        return cache[case.name]

    return get


def _digest(state, rank):
    """The digest of ``rank``'s block of a stacked state."""
    return pod.state_digest(tp2p.shard_state(state, rank))


def _assert_rows_equal(case, ranks, want):
    for r, (w_local, w_cons, w_loss) in enumerate(want):
        for rank in range(K):
            got = ranks[rank][case.name][r]
            assert got.local == _digest(w_local, rank), f"{case.name} round {r} rank {rank} local"
            assert got.consensus == _digest(w_cons, rank), \
                f"{case.name} round {r} rank {rank} consensus"
            assert torch.equal(got.losses, w_loss), f"{case.name} round {r} rank {rank} losses"


def _gathered(ranks, name, field="params"):
    """Every rank's block of ``field`` after the last round's consensus, stacked."""
    return torch.cat([getattr(ranks[k][name][-1], field) for k in range(K)])


def _reference_last(case):
    """The reference's make_round_fn from the same exported init and batches:
    the last round's after-consensus params as the port's (K, row) layout."""
    jcfg = _cfg(jp2p, case.cfg.protocol, case.cfg.schedule,
                **{f: getattr(case.cfg, f) for f in (
                    "round_robin_topologies", "partner_rule", "staleness_bound",
                    "steps_profile", "compressor", "topk_frac")})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=np.asarray(SIZES))
    state = jp2p.init_state(jax.random.PRNGKey(0), jmlp.init_2nn, jcfg,
                            data_sizes=np.asarray(SIZES))
    layout = tp2p.ParamLayout.of(ttask.get_task("mnist_mlp"))
    for x, y in pod.case_batches(case, "cpu"):
        _, state, _ = fn(state, (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    return layout.flatten({k: torch.as_tensor(v) for k, v in
                           _flat_leaves(jax.tree.map(np.asarray, state.params)).items()})


# ---------------------------------------------------------------------------
# host side: lanes and the config, against the reference with ==
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule,extra", SCHEDULE_GRID, ids=GRID_IDS)
def test_lanes_equal_reference(schedule, extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg, tcfg = (_cfg(pkg, "gossip", schedule, **extra) for pkg in (jp2p, tp2p))
    if schedule == "adaptive":  # the complete graph's candidate lanes
        union = ~np.eye(K, dtype=bool)
        want, got = jgraph.edge_color_lanes(union), tgraph.edge_color_lanes(union)
    else:
        want = jgraph.schedule_lanes(jp2p.build_schedule(jcfg))
        got = tgraph.schedule_lanes(tp2p.build_schedule(tcfg))
    assert [(lane.perm, lane.src_for_dst) for lane in got] == \
        [(lane.perm, lane.src_for_dst) for lane in want]
    assert all(s == K or s >= 0 for lane in got for s in lane.src_for_dst)


@pytest.mark.parametrize("protocol", ["gossip", "push_sum"])
@pytest.mark.parametrize("schedule", ["static", "link_dropout", "round_robin",
                                      "one_way_matching", "adaptive"])
def test_sharded_k8_equals_reference(schedule, protocol):
    want = jconfigs.sharded_k8(schedule=schedule, protocol=protocol)
    got = tconfigs.sharded_k8(schedule=schedule, protocol=protocol)
    assert got.name == want.name
    assert (got.batch_size, got.samples_per_class, got.rounds, got.peer_classes) == \
        (want.batch_size, want.samples_per_class, want.rounds, want.peer_classes)
    for field in dataclasses.fields(got.p2p):
        assert getattr(got.p2p, field.name) == getattr(want.p2p, field.name), field.name


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def test_mix_sparse_equals_reference():
    rng = np.random.default_rng(3)
    w = jgraph.mixing_matrix(jgraph.build_graph("ring", K), "metropolis")
    self_w, nbr_idx, nbr_w = jconsensus.sparse_mixing(w)
    x = rng.normal(size=(K, 5, 3)).astype(np.float32)
    want = np.asarray(jconsensus.mix_sparse(self_w, nbr_idx, nbr_w, jnp.asarray(x)))
    got = tconsensus.mix_sparse(torch.as_tensor(self_w), torch.as_tensor(nbr_idx),
                                torch.as_tensor(nbr_w), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = tconsensus.mix_stacked(torch.as_tensor(w, dtype=torch.float32),
                                   torch.as_tensor(x).reshape(K, -1)).reshape(K, 5, 3)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("form", ["gather", "psum", "ring", "collective"])
def test_collectives_equal_mix_stacked(form, grid):
    ranks, _ = grid
    rng = np.random.default_rng(0)
    x = rng.normal(size=(K, 5, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    flat = torch.as_tensor(x).reshape(K, -1)
    if form == "gather":  # a ring's lanes: own row and both neighbors, zeros elsewhere
        for rank in range(K):
            got = ranks[rank]["collectives"]["gather"]
            keep = {rank, (rank - 1) % K, (rank + 1) % K}
            for j in range(K):
                want = x[j] if j in keep else np.zeros_like(x[j])
                assert np.array_equal(got[j].numpy(), want)
        return
    if form == "psum":
        mat = np.full((K, K), 0.5 / (K - 1), np.float32)
        np.fill_diagonal(mat, 0.5)
    elif form == "ring":
        mat = np.zeros((K, K), np.float32)
        for i in range(K):
            mat[i, i], mat[i, (i - 1) % K], mat[i, (i + 1) % K] = 0.5, 0.3, 0.2
    else:
        mat = w
    jwant = np.asarray(jconsensus.mix_stacked(jnp.asarray(mat), jnp.asarray(x)))
    want = tconsensus.mix_stacked(torch.as_tensor(mat), flat).reshape(K, 5, 3).numpy()
    got = np.concatenate([ranks[r]["collectives"][form].numpy() for r in range(K)])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jwant, **TOL)


# ---------------------------------------------------------------------------
# the sharded round against the port's vmap round (bits) and the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PARITY))
def test_sharded_round_bit_identical_to_vmap(name, grid, vmap_runs):
    case = PARITY[name]
    _assert_rows_equal(case, grid[0], vmap_runs(case))


@pytest.mark.parametrize("name", sorted(COMPRESSED))
def test_sharded_compressed_allclose_to_vmap(name, grid, vmap_runs):
    case = COMPRESSED[name]
    ranks, _ = grid
    want = vmap_runs(case)[-1][1]
    np.testing.assert_allclose(_gathered(ranks, name).numpy(), want.params.numpy(), **TOL)
    # every rank advanced the same replicated estimate stack, bit for bit
    est = 5 + len(want.protocol)  # round index, params, momentum, d, b, protocol, estimate
    for r in range(case.rounds):
        assert len({ranks[k][name][r].consensus[est] for k in range(K)}) == 1


# top-k's kept set is discontinuous in the difference: a float32 rounding
# apart, a near-tie at the boundary keeps another coordinate, so a top-k run
# is not held to the reference's free-running round here (it is held to the
# port's vmap round above, and test_torch_round.py holds that round to the
# reference's, teacher-forced, round by round)
@pytest.mark.parametrize("name", sorted(PARITY) + ["gossip-qint8", "push_sum-qint8"])
def test_sharded_round_close_to_reference(name, grid):
    case = PARITY.get(name) or COMPRESSED[name]
    np.testing.assert_allclose(_gathered(grid[0], name).numpy(),
                               _reference_last(case).numpy(), **TOL)


def test_sharded_push_sum_mass_conservation(grid):
    ranks, _ = grid
    for r in range(MASS.rounds):
        mass = torch.cat([ranks[k][MASS.name][r].protocol.mass for k in range(K)])
        np.testing.assert_allclose(float(mass.sum()), K, rtol=1e-5)
        assert (mass > 0).all()


@pytest.mark.parametrize("name", sorted(SCAN))
def test_pod_scan_driver_equals_python_loop(name, grid, vmap_runs):
    """One chunk of the pod scan driver: the python loop's bits, which are
    the vmap runtime's."""
    case = SCAN[name]
    ranks, _ = grid
    want = vmap_runs(case)
    for rank in range(K):
        got = ranks[rank]["scan"][name]
        assert got.local == _digest(want[-1][0], rank)
        assert got.consensus == _digest(want[-1][1], rank)
        assert torch.equal(got.losses, torch.stack([w[2] for w in want]))


def test_legacy_whole_block_protocol_runs_its_override(grid):
    """A protocol with only the whole-block ``mix_sharded`` runs through it
    (d from the kernel) and matches the stacked mix of its own ``mix``."""
    ranks, want = grid
    for field in ("params", "d_bias"):
        np.testing.assert_allclose(_gathered(ranks, LEGACY, field).numpy(),
                                   getattr(want, field).numpy(), atol=1e-6)


def test_local_width_k_equals_width_one(grid):
    """``local_width=K`` (the card's parity form) gives the bits of width 1
    on the CPU."""
    ranks, _ = grid
    for rank in range(K):
        for one, wide in zip(ranks[rank][WIDTH.name], ranks[rank]["width"][WIDTH.name]):
            assert (one.local, one.consensus) == (wide.local, wide.consensus)
            assert torch.equal(one.losses, wide.losses)


# ---------------------------------------------------------------------------
# entry points, multipod steps and failures
# ---------------------------------------------------------------------------


def test_run_paper_experiment_pod_matches_vmap(mnist_small):
    exp = tconfigs.sharded_k8(schedule="link_dropout", local_steps=2)
    log_v = train.run_paper_experiment(exp, rounds=2, data=mnist_small, device="cpu")
    log_p, state = train.run_paper_experiment(exp, rounds=2, data=mnist_small, device="cpu",
                                              peer_axis="pod", driver="python",
                                              return_state=True)
    for attr in ("after_local", "after_consensus"):
        want, got = getattr(log_v, attr), getattr(log_p, attr)
        assert want.keys() == got.keys()
        for group in want:
            assert np.array_equal(np.stack(want[group]), np.stack(got[group])), (attr, group)
    assert log_v.train_loss == log_p.train_loss
    assert log_v.drift == log_p.drift
    assert state.params.shape[0] == K and state.round_idx == 2


def test_cli_pod_one_process_per_peer(capfd):
    train.main(["--experiment", "sharded_k8", "--peer-axis", "pod", "--device", "cpu",
                "--rounds", "1", "--local-steps", "1", "--protocol", "push_sum"])
    out = capfd.readouterr().out  # rank 0 prints from its own process
    assert "round   0" in out and "8 ranks" in out


def _mlp_loss(params, batch):
    """The port's 2NN loss of one peer (``loss_2nn`` on a peer axis of 1)."""
    return tmlp.loss_2nn({k: v[None] for k, v in params.items()},
                         (batch[0][None], batch[1][None]))[0]


def test_multipod_train_step_equals_single_peer_steps():
    model = type("M", (), {"loss_fn": staticmethod(_mlp_loss)})
    rng = np.random.default_rng(0)
    params = {k: torch.as_tensor(v[:3]) for k, v in EXPORTED.items()}
    batch = (torch.as_tensor(rng.normal(size=(3, 10, 784)).astype(np.float32)),
             torch.as_tensor(rng.integers(0, 10, size=(3, 10))))
    opt = toptim.sgd(0.1, momentum=0.5)
    state = opt.init(params)
    d = {k: torch.full_like(v, 1e-2) for k, v in params.items()}
    got = tsteps.make_multipod_train_step(model, opt, eta_d=0.25)(params, state, d, batch, 0)
    one = tsteps.make_train_step(model, opt, eta_d=0.25)
    for k in range(3):
        want = one({n: v[k] for n, v in params.items()}, {n: v[k] for n, v in state.items()},
                   {n: v[k] for n, v in d.items()}, (batch[0][k], batch[1][k]), 0)
        for name in params:
            np.testing.assert_allclose(got[0][name][k].numpy(), want[0][name].numpy(), **TOL)
        np.testing.assert_allclose(float(got[2][k]), float(want[2]), **TOL)


def test_multipod_serve_step_equals_single_peer_steps():
    model = build_model(reduced(get_config("smollm-135m")))
    gen = torch.Generator().manual_seed(0)
    peers = [model.init(gen) for _ in range(2)]
    params = {k: torch.stack([p[k] for p in peers]) for k in peers[0]}
    batch = model.make_batch(gen, 2, 8)
    prefill = tsteps.make_prefill_step(model)
    toks, caches = zip(*(prefill(p, batch, model.init_cache(2, 16, "cpu")) for p in peers))
    cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    pos = torch.full((2, 2), 8)
    got = tsteps.make_multipod_serve_step(model)(params, cache, torch.stack(toks), pos)
    one = tsteps.make_serve_step(model)
    for k in range(2):
        want = one(peers[k], caches[k], toks[k], pos[k])
        assert torch.equal(got[0][k], want[0]) and torch.equal(got[1][k], want[1])
        for name in want[2]:
            np.testing.assert_allclose(got[2][name][k].numpy(), want[2][name].numpy(), **TOL)


@pytest.mark.parametrize("eta_d", [0.0, 0.25])
def test_multipod_train_step_matches_reference(eta_d):
    """The reference's ``make_multipod_train_step`` (``jax.vmap`` of its
    single-peer step) on the 2NN with its momentum SGD, from the same
    stacked params, d and batch: params, momentum and losses at the float32
    tolerance.  Without ``eta_d`` the port is given no d at all."""
    peers = 3
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(lambda a: jnp.asarray(a[:peers]), _exported_init())
    x = rng.normal(size=(peers, 10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=(peers, 10)).astype(np.int32)
    jd = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * 1e-2, jnp.float32),
                      jparams)
    jopt, topt = joptim.sgd(0.1, momentum=0.5), toptim.sgd(0.1, momentum=0.5)
    model = type("M", (), {"loss_fn": staticmethod(jmlp.loss_2nn)})
    jstep = jax.jit(jsteps.make_multipod_train_step(model, jopt, eta_d=eta_d))
    jstate = jopt.init(jparams)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    tstate = topt.init(tparams)
    td = interop.params_from_jax(jax.tree.map(np.asarray, jd)) if eta_d else None
    tstep = tsteps.make_multipod_train_step(type("M", (), {"loss_fn": staticmethod(_mlp_loss)}),
                                            topt, eta_d=eta_d)
    batch = (torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64))
    for step in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, jd, (jnp.asarray(x), jnp.asarray(y)),
                                       jnp.asarray(step))
        tparams, tstate, tloss = tstep(tparams, tstate, td, batch, step)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        for got, want in ((tparams, jparams), (tstate, jstate)):
            want = interop.params_from_jax(jax.tree.map(np.asarray, want))
            assert set(got) == set(want)
            for name in want:
                np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL,
                                           err_msg=f"step {step} {name}")


def test_multipod_serve_step_matches_reference():
    """The reference's ``make_multipod_serve_step`` on reduced smollm-135m,
    two peers of the reference's params, from the reference's prefill
    caches: the next tokens and positions equal, the caches at the float32
    tolerance; the reference's logits keep their top two apart by more
    than the tolerance allows, so the tokens cannot swap."""
    peers, prompt, cache_len = 2, 8, 16
    jmodel = jbuild_model(jreduced(jget_config("smollm-135m")))
    model = build_model(reduced(get_config("smollm-135m")))
    jparams = jax.jit(jax.vmap(jmodel.init))(jax.random.split(jax.random.PRNGKey(3), peers))
    tokens = np.random.default_rng(4).integers(0, 512, (peers, 2, prompt)).astype(np.int32)
    jprefill = jax.jit(jax.vmap(lambda p, t: jmodel.prefill(p, {"tokens": t},
                                                            jmodel.init_cache(2, cache_len))))
    logits, jcache = jprefill(jparams, jnp.asarray(tokens))
    jtok = jnp.argmax(logits[:, :, -1], axis=-1).astype(jnp.int32)
    jpos = jnp.full((peers, 2), prompt, jnp.int32)
    want_tok, want_pos, want_cache = jax.jit(jsteps.make_multipod_serve_step(jmodel))(
        jparams, jcache, jtok, jpos)
    jlogits, _ = jax.jit(jax.vmap(jmodel.decode_step))(jparams, jtok, jpos, jcache)
    top2 = np.sort(np.asarray(jlogits)[:, :, -1], axis=-1)[..., -2:]
    limit = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2).max())
    assert (top2[..., 1] - top2[..., 0] > limit).all()
    port = lambda tree: interop.params_from_jax(jax.tree.map(np.asarray, tree))  # noqa: E731
    got_tok, got_pos, got_cache = tsteps.make_multipod_serve_step(model)(
        port(jparams), port(jcache), torch.as_tensor(np.asarray(jtok), dtype=torch.int64),
        torch.as_tensor(np.asarray(jpos), dtype=torch.int64))
    assert np.array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert np.array_equal(got_pos.numpy(), np.asarray(want_pos))
    want_cache = port(want_cache)
    assert set(got_cache) == set(want_cache)
    for name, want in want_cache.items():
        np.testing.assert_allclose(got_cache[name].numpy(), want.numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b", "qwen3-moe-235b-a22b"])
def test_multipod_train_step_equals_single_peer_steps_on_lms(arch):
    """The multipod step on reduced LMs whose loss reaches a kernel's
    Function under ``torch.func.vmap`` (``wkv6``; ``ssd`` and attention; the
    MoE dispatch), AdamW on clipped gradients (the clip's norm each peer's
    own): each peer's params, state and loss as its single-peer step's."""
    model = build_model(reduced(get_config(arch)))
    gen = torch.Generator().manual_seed(0)
    peers = [model.init(gen) for _ in range(2)]
    batches = [model.make_batch(gen, 2, 8) for _ in peers]
    for b in batches:
        b["labels"] = torch.roll(b["tokens"], -1, dims=1)
    base = toptim.adamw(1e-2, weight_decay=0.01)
    opt = toptim.Optimizer(base.init, lambda g, st, p, step: base.update(
        toptim.clip_by_global_norm(g, 1.0), st, p, step))
    states = [opt.init(p) for p in peers]
    d = [{k: torch.full_like(v, 1e-3, dtype=torch.float32) for k, v in p.items()} for p in peers]
    stack = lambda trees: pytree.tree_map(lambda *xs: torch.stack(xs), *trees)  # noqa: E731
    got = tsteps.make_multipod_train_step(model, opt, eta_d=0.25)(
        stack(peers), stack(states), stack(d), stack(batches), 0)
    one = tsteps.make_train_step(model, opt, eta_d=0.25)
    for k in range(2):
        want = one(peers[k], states[k], d[k], batches[k], 0)
        np.testing.assert_allclose(float(got[2][k]), float(want[2]), **TOL)
        for g, w in zip(pytree.leaves(got[:2]), pytree.leaves(want[:2])):
            np.testing.assert_allclose(g[k].float().numpy(), w.float().numpy(), **TOL)


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_failing_rank_fails_the_launch_within_the_timeout(mode):
    start = time.perf_counter()
    with pytest.raises(Exception) as got:
        peer_group.spawn_peers(peer_group.check_rank, 2, "cpu", args=(mode,), timeout=8,
                               deadline=60)
    assert time.perf_counter() - start < 45
    # the launcher names every failed rank: the one that raised, or the one
    # whose barrier timed out waiting for the one that hangs
    assert ("rank 1 raises" if mode == "raise" else "-- rank 0") in str(got.value)

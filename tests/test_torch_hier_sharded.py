"""The port's hierarchical runtime over several ranks (a block of p peers a
rank: ``p2p.make_sharded_round_fn(..., peers_per_device=p)``) against its
vmap runtime, its one-slice runtime and the reference's, on the CPU: eight
gloo ranks.

The reference's contract (tests/test_hier_runtime.py) is bridge mode float32
bit-identical to the vmap runtime across slices, segment mode allclose at
1e-5, and a K = 4096 round on 8 slices with no (K, K) intermediate.  The
grid runs in ONE module-scoped spawn of eight ranks (``launch.pod.hier_rank``);
the parametrized cases read their results from it:

- bridge at K = 16 (p = 2) and K = 64 (p = 8), gossip and push-sum on the
  reference's three schedules, 6 rounds (crossing R = 5) of the reference
  test's config on its 6-16-4 tanh MLP (``pod.TANH_MLP``) from exported
  reference parameters: every rank's
  state after both phases and the losses equal the port's vmap runtime bit
  for bit, and the last params are allclose to the reference's
  ``make_round_fn`` at float32 5e-5 / 1e-4;
- segment at K = 16 over 8 ranks, both protocols, 4 rounds: equal to the
  port's one-slice segment runtime bit for bit (both sum the slots in slot
  order in float32), allclose at 1e-5 to the vmap runtime and to the
  reference's one-slice segment runtime;
- ``ring_gather_slots`` across the ranks against ``x[nbr_idx]`` (ragged
  degrees, padding slots, a 1-D and a 3-D block);
- K = 4096 over 8 ranks (p = 512) on the reference's (3, 2) model, both
  protocols, one round: finite, ``round_idx == 1``, and no tensor made in a
  rank's consensus phase has two dimensions, or the leading one, equal to K.

Outside the spawn: the slot form's plain version against the one-slice
``segment_mix`` plain version, ``run_paper_experiment(peer_axis="pod",
peers_per_device=2)`` against the vmap run and its scan driver against its
python driver, ``serve_fleet(peer_axis="pod")`` against the stacked fleet and
the reference's fleet step, both CLIs, and the refusals, message for
message.
"""
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tmnist  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import peer_group  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels.consensus_mix import ref, segment  # noqa: E402
from repro_torch.launch import pod, serve, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

RANKS = 8
ROUNDS = 6  # crosses the period boundary (R = 5)
SEGMENT_ROUNDS = 4
BIG_K = 4096
TOL = dict(atol=5e-5, rtol=1e-4)
SEGMENT_TOL = dict(atol=1e-5, rtol=1e-5)
SCHEDULE_GRID = [
    ("static", {}),
    ("link_dropout", {}),
    ("round_robin", {"round_robin_topologies": ("ring", "star")}),
]


def _cfg(pkg, k, protocol="gossip", schedule="static", **extra):
    """The reference test's round config (tests/test_hier_runtime.py:60) at
    K = ``k``."""
    return pkg.P2PConfig(
        algorithm="p2pl_affinity", num_peers=k, local_steps=3, consensus_steps=2, lr=0.1,
        momentum=0.3, eta_d=0.5, eta_b=0.1, topology="ring", protocol=protocol,
        schedule=schedule, schedule_rounds=5, **extra)


def _init_fn(key):  # the reference test's model (tests/test_hier_runtime.py:36)
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (6, 16)), "b1": jnp.zeros((16,)),
            "w2": jax.random.normal(k2, (16, 4))}


def _mlp_loss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean(jnp.sum(jnp.square(h @ p["w2"] - y), axis=-1))


def _exported(k):
    """The reference's initial params of K = ``k`` peers (its init_state)."""
    state = jp2p.init_state(jax.random.PRNGKey(0), _init_fn, _cfg(jp2p, k),
                            data_sizes=np.arange(1, k + 1))
    return {name: np.array(leaf) for name, leaf in state.params.items()}


EXPORTED = {k: _exported(k) for k in (16, 64)}


def _case(name, k, protocol, schedule, extra, rounds, mix_mode):
    return pod.RoundCase(name, _cfg(tp2p, k, protocol, schedule, **extra), rounds,
                         tuple(range(1, k + 1)), batch=10, init_params=EXPORTED[k],
                         peers_per_device=k // RANKS, mix_mode=mix_mode, task=pod.TANH_MLP)


BRIDGE = {f"bridge-k{k}-{proto}-{sched}": _case(f"bridge-k{k}-{proto}-{sched}", k, proto, sched,
                                                 extra, ROUNDS, "bridge")
          for k in (16, 64) for proto in ("gossip", "push_sum") for sched, extra in SCHEDULE_GRID}
SEGMENT = {f"segment-k16-{proto}": _case(f"segment-k16-{proto}", 16, proto, "static", {},
                                         SEGMENT_ROUNDS, "segment")
           for proto in ("gossip", "push_sum")}
AUTO = _case("auto-k64", 64, "gossip", "link_dropout", {}, 2, "auto")
TINY = [tp2p.P2PConfig(algorithm="p2pl_affinity", num_peers=BIG_K, local_steps=1,
                       consensus_steps=1, lr=0.1, eta_d=0.5, topology="ring", protocol=proto,
                       schedule="static") for proto in ("gossip", "push_sum")]


def _gathers():
    """Stacked (K, ...) rows and (K, D) global indices with ragged degrees
    (0 to D real slots a row, the rest padded with the row's own index)."""
    rng = np.random.default_rng(0)
    out = []
    for k, d, feat in ((16, 5, (5, 3)), (64, 3, ()), (24, 7, (4,))):
        idx = np.tile(np.arange(k, dtype=np.int32)[:, None], (1, d))
        for row in range(k):
            deg = rng.integers(0, d + 1)
            idx[row, :deg] = rng.choice(k, size=deg, replace=False)
        x = rng.normal(size=(k, *feat)).astype(np.float32)
        out.append((torch.as_tensor(x), torch.as_tensor(idx)))
    return out


GATHERS = _gathers()


@pytest.fixture(scope="module")
def grid():
    """Every in-spawn case of the file through eight gloo ranks, one spawn."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cases = [*BRIDGE.values(), *SEGMENT.values(), AUTO]
        return peer_group.spawn_peers(pod.hier_rank, RANKS, "cpu",
                                      args=(cases, False, (), TINY, (), None, GATHERS),
                                      deadline=240)


@pytest.fixture(scope="module")
def vmap_runs():
    """The port's vmap runs of the cases, memoized."""
    cache = {}

    def get(case):
        if case.name not in cache:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cache[case.name] = pod.vmap_rounds(case, "cpu")
        return cache[case.name]

    return get


def _digest(state, rank, p):
    return pod.state_digest(tp2p.shard_state(state, rank, p))


def _assert_rows_equal(case, ranks, want):
    p = case.peers_per_device
    for r, (w_local, w_cons, w_loss) in enumerate(want):
        for rank in range(RANKS):
            got = ranks[rank]["cases"][case.name][r]
            assert got.local == _digest(w_local, rank, p), f"{case.name} round {r} rank {rank}"
            assert got.consensus == _digest(w_cons, rank, p), \
                f"{case.name} round {r} rank {rank} consensus"
            assert torch.equal(got.losses, w_loss), f"{case.name} round {r} rank {rank} losses"


def _gathered(ranks, name, field="params"):
    """Every rank's block of ``field`` after the last round, stacked."""
    return torch.cat([getattr(ranks[k]["cases"][name][-1], field) for k in range(RANKS)])


def _reference_last(case, *, one_slice=False):
    """The reference's last-round params from the same exported init and
    batches: its ``make_round_fn``, or with ``one_slice`` its hierarchical
    runtime on a one-device mesh in the case's mode."""
    cfg = case.cfg
    jcfg = _cfg(jp2p, cfg.num_peers, cfg.protocol, cfg.schedule,
                round_robin_topologies=cfg.round_robin_topologies)
    sizes = np.asarray(case.data_sizes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if one_slice:
            mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("pod",))
            fn = jp2p.make_sharded_round_fn(_mlp_loss, jcfg, mesh, data_sizes=sizes,
                                            peers_per_device=cfg.num_peers,
                                            mix_mode=case.mix_mode)
        else:
            fn = jp2p.make_round_fn(_mlp_loss, jcfg, data_sizes=sizes)
    state = jp2p.init_state(jax.random.PRNGKey(0), _init_fn, jcfg, data_sizes=sizes)
    if one_slice:
        state = jspecs.shard_peer_tree(state, mesh)
    for x, y in pod.case_batches(case, "cpu"):
        _, state, _ = fn(state, (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    layout = tp2p.ParamLayout.of(pod.TANH_MLP)
    return layout.flatten({k: torch.as_tensor(np.array(v)) for k, v in state.params.items()})


# ---------------------------------------------------------------------------
# bridge: the vmap runtime's bits across ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BRIDGE))
def test_bridge_rows_equal_vmap_runtime(grid, vmap_runs, name):
    case = BRIDGE[name]
    want = vmap_runs(case)
    _assert_rows_equal(case, grid, want)
    for rank in range(RANKS):  # the last round's blocks, beside the digests
        last = grid[rank]["cases"][name][-1]
        p = case.peers_per_device
        assert torch.equal(last.params, want[-1][1].params[rank * p:(rank + 1) * p])
    if case.cfg.protocol == "push_sum":
        mass = torch.cat([grid[k]["cases"][name][-1].protocol.mass for k in range(RANKS)])
        np.testing.assert_allclose(float(mass.sum()), case.cfg.num_peers, rtol=1e-5)


@pytest.mark.parametrize("name", list(BRIDGE))
def test_bridge_matches_reference_round(grid, name):
    case = BRIDGE[name]
    np.testing.assert_allclose(_gathered(grid, name).numpy(), _reference_last(case).numpy(),
                               **TOL, err_msg=name)


def test_auto_picks_bridge_up_to_64_peers(grid, vmap_runs):
    assert [tp2p.resolve_mix_mode("auto", k) for k in (16, 64, 65, 4096)] == [
        "bridge", "bridge", "segment", "segment"]
    _assert_rows_equal(AUTO, grid, vmap_runs(AUTO))
    for rank in range(RANKS):  # bridge all-gathers; segment would ring-shift
        stats = grid[rank]["cases"]["stats"][AUTO.name]
        assert stats["shifts"] == 0 and stats["gathers"] > 0
        seg = grid[rank]["cases"]["stats"]["segment-k16-gossip"]
        assert seg["shifts"] > 0


# ---------------------------------------------------------------------------
# segment: slot-ordered sums across ranks
# ---------------------------------------------------------------------------


def _one_slice_rounds(case):
    task = pod.TANH_MLP
    sizes = np.asarray(case.data_sizes)
    step = tp2p.make_hier_round_fn(task, case.cfg, sizes, peers_per_device=case.cfg.num_peers,
                                   mix_mode="segment", device="cpu")
    state, out = pod.case_state(case, "cpu"), []
    for batches in pod.case_batches(case, "cpu"):
        after_local, state, losses = step(state, batches)
        out.append((after_local, state, losses))
    return out


@pytest.mark.parametrize("name", list(SEGMENT))
def test_segment_rows_equal_one_slice_segment_runtime(grid, name):
    case = SEGMENT[name]
    _assert_rows_equal(case, grid, _one_slice_rounds(case))


@pytest.mark.parametrize("name", list(SEGMENT))
def test_segment_allclose_to_vmap_and_reference(grid, vmap_runs, name):
    case = SEGMENT[name]
    got = _gathered(grid, name).numpy()
    np.testing.assert_allclose(got, vmap_runs(case)[-1][1].params.numpy(), **SEGMENT_TOL)
    np.testing.assert_allclose(got, _reference_last(case, one_slice=True).numpy(),
                               **SEGMENT_TOL)
    d = _gathered(grid, name, "d_bias").numpy()
    np.testing.assert_allclose(d, vmap_runs(case)[-1][1].d_bias.numpy(), **SEGMENT_TOL)


@pytest.mark.parametrize("i", range(len(GATHERS)))
def test_ring_gather_slots_across_ranks(grid, i):
    x, idx = GATHERS[i]
    got = torch.cat([grid[rank]["gathers"][i] for rank in range(RANKS)])
    assert torch.equal(got, x[idx.long()])


@pytest.mark.parametrize("j", range(len(TINY)))
def test_large_k_round_over_8_ranks_builds_no_k_tensor(grid, j):
    cfg = TINY[j]
    for rank in range(RANKS):
        got = grid[rank]["tiny"][j]
        assert got["finite"] and got["round_idx"] == 1, (cfg.protocol, rank)
        assert bool(torch.isfinite(got["losses"]).all())
        assert got["shapes"] > 0, "the dispatch mode saw no operation"
        assert got["kk_shapes"] == [], (cfg.protocol, rank, got["kk_shapes"][:5])
    assert all(torch.equal(grid[0]["tiny"][j]["losses"], grid[r]["tiny"][j]["losses"])
               for r in range(RANKS))


# ---------------------------------------------------------------------------
# the slot form's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mass", [False, True])
def test_slot_form_plain_equals_one_slice_plain(mass):
    """On slots that hold the rows ``nbr_idx`` names, the slot form's plain
    version gives the one-slice plain version's rows bit for bit, gossip
    and mass, block by block (and through the wrappers' CPU path)."""
    rng = np.random.default_rng(1)
    k, d, n, p = 24, 4, 37, 6
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, k, size=(k, d)).astype(np.int32))
    nbr_w = torch.as_tensor(rng.random((k, d)).astype(np.float32) / d)
    beta = torch.as_tensor(rng.random((k, d)).astype(np.float32))
    beta[3] = 0.0  # an isolated peer: d = 0
    self_w = 1.0 - nbr_w.sum(dim=1)
    y = torch.as_tensor(rng.uniform(0.5, 1.5, size=k).astype(np.float32))
    if mass:
        want = ref.segment_mix_push_sum_stacked_ref(x, y, self_w, idx, nbr_w, beta, 3)
    else:
        want = ref.segment_mix_stacked_ref(x, self_w, idx, nbr_w, beta, 3)
    for r0 in range(0, k, p):
        rows = slice(r0, r0 + p)
        slots = x[idx[rows].long()]
        ops = segment.SparseOperands(self_w[rows], idx[rows], nbr_w[rows], beta[rows])
        if mass:
            got = ref.segment_mix_push_sum_slots_ref(x[rows], slots, y[rows], y[idx[rows].long()],
                                                     self_w[rows], nbr_w[rows], beta[rows], 3)
            wrapped = segment.segment_mix_push_sum_slots(x[rows], slots, y[rows],
                                                         y[idx[rows].long()], ops, 3)
        else:
            got = ref.segment_mix_slots_ref(x[rows], slots, self_w[rows], nbr_w[rows],
                                            beta[rows], 3)
            wrapped = segment.segment_mix_slots(x[rows], slots, ops, 3)
        for g, w, v in zip(got, want, wrapped):
            assert torch.equal(g, w[rows]) and torch.equal(v, w[rows])
    assert bool((want[1][3] == 0).all())


def test_slot_form_refuses_bad_operands():
    x = torch.zeros(4, 8)
    ops = segment.SparseOperands(torch.ones(4), torch.zeros(4, 2, dtype=torch.int32),
                                 torch.zeros(4, 2), torch.zeros(4, 2))
    with pytest.raises(TypeError, match="float32"):
        segment.segment_mix_slots(x.to(torch.bfloat16), torch.zeros(4, 2, 8), ops, 1)
    with pytest.raises(ValueError, match="slots must be"):
        segment.segment_mix_slots(x, torch.zeros(4, 3, 8), ops, 1)
    with pytest.raises(ValueError, match="local_steps"):
        segment.segment_mix_slots(x, torch.zeros(4, 2, 8), ops, 0)
    with pytest.raises(ValueError, match="slot_mass"):
        segment.segment_mix_push_sum_slots(x, torch.zeros(4, 2, 8), torch.ones(4),
                                           torch.ones(4), ops, 1)


# ---------------------------------------------------------------------------
# the entry points: run_paper_experiment, the CLIs, serve_fleet
# ---------------------------------------------------------------------------


def test_run_paper_experiment_over_four_ranks(mnist_small):
    """``timevarying_k8`` on 4 ranks of 2 peers (auto: bridge): the vmap
    run's accuracies, and the scan driver's final state is the python
    driver's bit for bit."""
    exp = tmnist.timevarying_k8()
    kw = dict(rounds=2, data=mnist_small, device="cpu")
    log_s, state_s = train.run_paper_experiment(exp, peer_axis="pod", peers_per_device=2,
                                                return_state=True, **kw)
    log_p, state_p = train.run_paper_experiment(exp, peer_axis="pod", peers_per_device=2,
                                                driver="python", return_state=True, **kw)
    log_v = train.run_paper_experiment(exp, **kw)
    assert len(log_s.ranks) == 4 and np.isfinite(log_s.train_loss).all()
    for log in (log_s, log_p):
        for phase in ("after_local", "after_consensus"):
            for group, want in getattr(log_v, phase).items():
                assert np.array_equal(np.stack(getattr(log, phase)[group]), np.stack(want))
    for a, b in zip(tp2p.state_leaves(state_s), tp2p.state_leaves(state_p)):
        assert torch.equal(a, b)


def test_train_cli_runs_several_slices(capfd):
    train.main(["--device", "cpu", "--experiment", "directed_k8", "--peer-axis", "pod",
                "--peers-per-device", "4", "--mix-mode", "segment", "--rounds", "1",
                "--driver", "python"])
    out = capfd.readouterr().out  # rank 0 prints the rounds from its own process
    assert "round   0" in out and "2 ranks)" in out


def test_serve_fleet_pod_equals_stacked_fleet():
    kw = dict(num_peers=2, batch=2, prompt_len=6, gen_tokens=4, device="cpu")
    pod_out = serve.serve_fleet("smollm-135m", peer_axis="pod", **kw)
    stacked = serve.serve_fleet("smollm-135m", **kw)
    assert pod_out["tokens"].shape == (2, 2, 4)
    assert torch.equal(pod_out["tokens"], stacked["tokens"])
    assert len(pod_out["ranks"]) == 2 and pod_out["tokens_per_s"] > 0


def test_pod_fleet_rank_gives_reference_fleet_tokens():
    """The ranks serving exported reference parameters and prompts give the
    reference's fleet step's tokens, as the stacked fleet does."""
    arch, gen, prompt_len = "smollm-135m", 4, 6
    jmodel = jbuild_model(jconfigs.reduced(jconfigs.get_config(arch)))
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config(arch)))
    jpeers = [jax.jit(jmodel.init)(jax.random.PRNGKey(s)) for s in (0, 1)]
    stacked = jax.tree.map(lambda *leaves: jnp.stack(leaves), *jpeers)
    prompts = np.random.default_rng(8).integers(0, 512, (2, 2, prompt_len))
    caches = jserve.stack_request_caches(jmodel.init_cache(2, prompt_len + gen), 2)
    want, _ = jax.jit(jserve.make_fleet_generate_fn(jmodel, gen))(
        stacked, {"tokens": jnp.asarray(prompts, jnp.int32)}, caches, jnp.arange(2))
    tstacked = interop.params_from_jax(jax.tree.map(np.asarray, stacked))
    tprompts = {"tokens": torch.as_tensor(prompts)}
    ranks = peer_group.spawn_peers(serve.fleet_rank, 2, "cpu",
                                   args=(arch, True, 2, prompt_len, gen, 0, tstacked, tprompts),
                                   inbox_bytes=16)
    got = torch.stack([r["tokens"] for r in ranks])
    fleet, _ = serve.make_fleet_generate_fn(tmodel, gen)(
        tstacked, tprompts, serve.stack_request_caches(tmodel.init_cache(2, prompt_len + gen,
                                                                         "cpu"), 2),
        torch.arange(2))
    assert torch.equal(got, fleet)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("argv,want", [
    (["--peer-axis", "pod"], "peer_axis=pod (2 processes)"),
    (["--peer-axis", "vmap"], "peer_axis=vmap"),
])
def test_serve_cli_peer_axis(argv, want, capsys):
    serve.main(["--device", "cpu", "--peers", "2", "--batch", "2", "--gen", "3",
                "--prompt-len", "6", *argv])
    assert want in capsys.readouterr().out


def test_serve_cli_rejects_unknown_peer_axis(capsys):
    with pytest.raises(SystemExit) as ex:
        serve.main(["--device", "cpu", "--peers", "2", "--peer-axis", "mesh"])
    assert ex.value.code == 2 and "invalid choice" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the refusals, as the reference's
# ---------------------------------------------------------------------------


def _group(size):
    return types.SimpleNamespace(rank=0, size=size, device=torch.device("cpu"))


def _mesh(n=1):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("pod",))


def test_layout_error_reads_as_the_reference():
    task = ttask.get_task("mnist_mlp")
    with pytest.raises(ValueError) as want:
        jspecs.hierarchical_layout(8, _mesh(), peers_per_device=2)
    with pytest.raises(ValueError) as got:
        tp2p.make_sharded_round_fn(task, _cfg(tp2p, 8), _group(1), peers_per_device=2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jspecs.hierarchical_layout(8, _mesh(), peers_per_device=1)
    with pytest.raises(ValueError) as got:
        tp2p.check_hierarchical_layout(8, 1, 8)
    assert str(got.value) == str(want.value)
    assert tp2p.check_hierarchical_layout(64, 8, 8) == 8


def test_bad_mix_mode_reads_as_the_reference():
    task = ttask.get_task("mnist_mlp")
    with pytest.raises(ValueError) as want:
        jp2p.make_sharded_round_fn(jmlp.loss_2nn, _cfg(jp2p, 8), _mesh(), peers_per_device=8,
                                   mix_mode="dense")
    with pytest.raises(ValueError) as got:
        tp2p.make_sharded_round_fn(task, _cfg(tp2p, 8), _group(4), peers_per_device=2,
                                   mix_mode="dense")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra,model", [
    (dict(schedule="adaptive"), "mnist_mlp"),
    (dict(compressor="qint8"), "mnist_mlp"),
    (dict(staleness_bound=2, steps_profile="straggler"), "mnist_mlp"),
    ({}, "rwkv6_seqmnist"),
])
def test_feature_refusals_read_as_the_reference(extra, model):
    jcfg = dataclasses.replace(_cfg(jp2p, 8, **extra), model=model)
    tcfg = dataclasses.replace(_cfg(tp2p, 8, **extra), model=model)
    with pytest.raises(ValueError) as want:
        jfeatures.check_config(jcfg, peers_per_device=2)
    with pytest.raises(ValueError) as got:
        tp2p.make_sharded_round_fn(ttask.get_task(model), tcfg, _group(4), peers_per_device=2)
    assert str(got.value) == str(want.value)


def test_several_slices_without_a_group_point_to_it():
    task = ttask.get_task("mnist_mlp")
    for make in (tp2p.make_hier_round_fn, tp2p.make_scan_driver):
        with pytest.raises(ValueError, match="needs a group"):
            make(task, _cfg(tp2p, 8), peers_per_device=2, device="cpu")

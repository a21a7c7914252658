"""Port parity, asynchronous rounds: per-peer step budgets and bounded-staleness
consensus (``repro_torch.core.p2p`` against ``repro.core.p2p``), on the CPU at
the 2NN's width with ``mnist_small`` shards.

* Host side, exact: ``compute_profile`` for every profile and several
  (K, T, period, fraction); the delivery rule's (delivered, age) sequence
  over two full publication periods (``array_equal``, decay allclose).
* Operands: the port's age-decayed slot operands against the reference's
  dense ``age_decayed_constants``, row (gossip) and column (push-sum),
  allclose at 1e-6; with decay 1 they equal the synchronous operands up to
  the rounding of the rebuilt diagonal.
* The snapshot mode's plain version against the reference's
  ``mix_compressed`` with the published snapshots for the estimates, and d
  from the decayed beta.
* The masked local phase against the reference's; capped peers equal a
  T = s run bit for bit within the port.
* Rounds shaped like ``straggler_k8`` (period 4, bound 2: stale snapshots
  and a forced delivery within 4 rounds): gossip on the static ring free
  running, push-sum on the round robin teacher-forced through
  ``interop.state_from_jax``; allclose at float32 atol 5e-5 / rtol 1e-4 after
  local and after consensus on params, d, mass and published, ages equal.
* Invariants in the port: ages never above the bound, published rows frozen
  between publications, push-sum's sum of mass = K within 1e-6 at maximal
  staleness; the scan driver equal to the python driver on every leaf.
* The reference's config, feature-table and CLI errors, message for message.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.data import partition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import protocols as tprotocols  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as cm_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
CPU = torch.device("cpu")
ROUNDS = 4


# ---------------------------------------------------------------------------
# config, profiles, delivery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(steps_profile="straggler"), dict(steps_profile="linear"),
    dict(staleness_bound=3), dict(steps_profile="straggler", staleness_bound=2,
                                  staleness_decay=1.0, protocol="push_sum"),
    dict(steps_profile="linear", compressor="topk"),
])
def test_async_configs_build_as_in_reference(kw):
    tcfg, jcfg = tp2p.P2PConfig(num_peers=8, **kw), jp2p.P2PConfig(num_peers=8, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.use_async == jcfg.use_async is True
    assert not tp2p.P2PConfig(num_peers=8).use_async


@pytest.mark.parametrize("kw", [
    dict(steps_profile="warp"), dict(staleness_bound=-1),
    dict(staleness_decay=0.0), dict(staleness_decay=1.5),
    dict(straggler_frac=0.0), dict(straggler_frac=1.01), dict(straggler_period=0),
    dict(compressor="topk", staleness_bound=2),
    dict(compressor="qint8", staleness_bound=1, steps_profile="linear"),
])
def test_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jp2p.P2PConfig(num_peers=8, **kw)
    with pytest.raises(ValueError) as got:
        tp2p.P2PConfig(num_peers=8, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("profile", ["uniform", "straggler", "linear"])
@pytest.mark.parametrize("k,t,period,frac", [
    (8, 8, 4, 0.25), (2, 10, 3, 0.5), (7, 5, 2, 0.3), (16, 1, 5, 1.0), (100, 60, 4, 0.25),
    (3, 4, 8, 0.1),
])
def test_compute_profile_equals_reference(profile, k, t, period, frac):
    kw = dict(num_peers=k, local_steps=t, steps_profile=profile, straggler_period=period,
              straggler_frac=frac)
    for got, want in zip(tp2p.compute_profile(tp2p.P2PConfig(**kw)),
                         jp2p.compute_profile(jp2p.P2PConfig(**kw))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(steps_profile="straggler", straggler_period=4, staleness_bound=2),
    dict(steps_profile="straggler", straggler_period=4, staleness_bound=3,
         staleness_decay=0.3),
    dict(steps_profile="straggler", straggler_period=6, staleness_bound=1, straggler_frac=0.5),
    dict(steps_profile="linear", staleness_bound=2, staleness_decay=0.7),
    dict(steps_profile="uniform", staleness_bound=5),
])
def test_delivery_sequence_equals_reference(kw):
    """(delivered, age) round by round over two full publication periods,
    from the port's device rule on a row of ``publication_table`` and the
    reference's ``_staleness_delivery`` on the round index."""
    tcfg, jcfg = tp2p.P2PConfig(num_peers=8, **kw), jp2p.P2PConfig(num_peers=8, **kw)
    table = tp2p.publication_table(tcfg)
    p = table.shape[0]
    t_age = torch.zeros(8, dtype=torch.int32)
    j_age = jnp.zeros((8,), jnp.int32)
    forced = stale = 0
    for r in range(2 * max(p, tcfg.staleness_bound + 1)):
        got = tp2p.staleness_delivery(tcfg, torch.as_tensor(table[r % p]), t_age)
        want = jp2p._staleness_delivery(jcfg, jnp.int32(r), j_age)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32 and got[2].dtype == torch.float32
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=0)
        assert int(got[1].max()) <= tcfg.staleness_bound
        forced += int((got[0] & ~torch.as_tensor(table[r % p])).sum())
        stale += int((got[1] > 0).sum())
        t_age, j_age = got[1], want[1]
    if kw["steps_profile"] == "straggler":
        assert stale > 0
    if kw.get("staleness_bound", 0) < kw.get("straggler_period", 1) - 1:
        assert forced > 0  # the bound, not the schedule, delivered


# ---------------------------------------------------------------------------
# age-decayed operands and the snapshot mode's plain version
# ---------------------------------------------------------------------------


def _dense(ops: tprotocols.SparseRoundOps) -> tuple[np.ndarray, np.ndarray]:
    """(W, Beta) of one round's slot operands, float64 from their float32."""
    k = ops.self_w.shape[0]
    w = np.diag(ops.self_w.double().numpy())
    beta = np.zeros((k, k))
    idx = ops.nbr_idx.long().numpy()
    for row in range(k):
        np.add.at(w[row], idx[row], ops.nbr_w[row].double().numpy())
        np.add.at(beta[row], idx[row], ops.beta[row].double().numpy())
    return w, beta


SCHEDULES = {
    "ring_static": dict(schedule="static", topology="ring"),
    "round_robin": dict(schedule="round_robin", round_robin_topologies=("ring", "star")),
    "peer_churn": dict(schedule="peer_churn", topology="complete", peer_online_prob=0.5,
                       schedule_rounds=3),  # offline peers: zero beta rows
    "directed_dropout": dict(schedule="link_dropout", topology="directed_ring",
                             link_survival_prob=0.6, schedule_rounds=3),
}


@pytest.mark.parametrize("protocol", ["gossip", "push_sum"])
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_age_decayed_operands_equal_reference(protocol, sched):
    kw = dict(num_peers=8, protocol=protocol, staleness_bound=3, steps_profile="straggler",
              **SCHEDULES[sched])
    tcfg, jcfg = tp2p.P2PConfig(**kw), jp2p.P2PConfig(**kw)
    sizes = np.arange(1, 9) * 7
    pick, _ = tp2p.round_picker(tcfg, sizes, device="cpu")
    jconsts, jsched = jp2p.protocol_constants(jcfg, data_sizes=sizes)
    jproto = jprotocols.get_protocol(protocol)
    rng = np.random.default_rng(0)
    for r in range(jsched.period):
        stale = pick(r)
        one = jprotocols.round_constants(jconsts, r)
        for decay in (rng.uniform(0.05, 1.0, 8), 0.5 ** rng.integers(0, 4, 8)):
            decay = decay.astype(np.float32)
            got = tprotocols.age_decayed_operands(stale, torch.as_tensor(decay),
                                                  jproto.stochasticity)
            want = jprotocols.age_decayed_constants(one, jnp.asarray(decay),
                                                    jproto.stochasticity)
            w, beta = _dense(got)
            np.testing.assert_allclose(w, np.asarray(want.w), atol=1e-6, rtol=0)
            np.testing.assert_allclose(beta, np.asarray(want.beta), atol=1e-6, rtol=0)
            axis = 1 if jproto.stochasticity == "row" else 0
            np.testing.assert_allclose(w.sum(axis=axis), 1.0, atol=1e-6)
        # decay 1: the round's own operands, but for the rebuilt diagonal's rounding
        ones = tprotocols.age_decayed_operands(stale, torch.ones(8), jproto.stochasticity)
        assert torch.equal(ones.nbr_w, stale.nbr_w) and torch.equal(ones.nbr_idx, stale.nbr_idx)
        torch.testing.assert_close(ones.self_w, stale.self_w, atol=1e-6, rtol=0)
        torch.testing.assert_close(ones.beta, stale.beta, atol=1e-6, rtol=1e-6)


def test_column_sums_are_the_off_diagonal_column_sums():
    cfg = tp2p.P2PConfig(num_peers=8, protocol="push_sum", **SCHEDULES["directed_dropout"])
    sched, proto = tp2p._protocol_schedule(cfg)
    sparse = proto.sparse_schedule(sched, cfg.mixing)
    cols = tprotocols.column_sums(sparse)
    for r in range(sparse.period):
        w, _ = _dense(cm_ops.select_round(cm_ops.upload_schedule(sparse), r))
        np.testing.assert_allclose(cols[r], w.sum(axis=0) - np.diag(w), atol=1e-7)
        np.testing.assert_allclose(cols[r] + sparse.self_w[r], 1.0, atol=1e-6)


@pytest.mark.parametrize("protocol", ["gossip", "push_sum"])
def test_snapshot_plain_version_equals_reference_mix_compressed(protocol):
    """The snapshot mode's plain version (the CPU path of the wrappers) on
    age-decayed operands: the mix equals the reference's ``mix_compressed``
    with the published snapshots for the estimates, d equals
    ``(Beta_decayed P - x) / T`` where the raw beta row is nonzero, 0
    elsewhere."""
    kw = dict(num_peers=8, protocol=protocol, staleness_bound=3, steps_profile="straggler",
              **SCHEDULES["peer_churn"])
    tcfg, jcfg = tp2p.P2PConfig(**kw), jp2p.P2PConfig(**kw)
    t = 6
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 1001)).astype(np.float32)
    pub = (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    mass = rng.uniform(0.3, 2.0, 8).astype(np.float32)
    mass *= 8 / mass.sum()
    decay = (0.5 ** rng.integers(0, 4, 8)).astype(np.float32)
    pick, _ = tp2p.round_picker(tcfg, device="cpu")
    jconsts, jsched = jp2p.protocol_constants(jcfg)
    jproto = jprotocols.get_protocol(protocol)
    for r in range(jsched.period):
        a_ops = tprotocols.age_decayed_operands(pick(r), torch.as_tensor(decay),
                                                jproto.stochasticity)
        raw = jprotocols.round_constants(jconsts, r)
        a_consts = jprotocols.age_decayed_constants(raw, jnp.asarray(decay),
                                                    jproto.stochasticity)
        if protocol == "push_sum":
            mixed, d, y_new = cm_ops.consensus_mix_push_sum_snapshot_stacked(
                torch.as_tensor(x), torch.as_tensor(pub), torch.as_tensor(mass), a_ops, t)
            jstate, jmixed = jproto.mix_compressed(
                jprotocols.PushSumState(mass=jnp.asarray(mass)), {"w": jnp.asarray(x)},
                {"w": jnp.asarray(pub)}, a_consts)
            np.testing.assert_allclose(y_new.numpy(), np.asarray(jstate.mass), **TOL)
            np.testing.assert_allclose(float(y_new.double().sum()), 8.0, rtol=1e-6)
        else:
            mixed, d = cm_ops.consensus_mix_snapshot_stacked(
                torch.as_tensor(x), torch.as_tensor(pub), a_ops, t)
            _, jmixed = jproto.mix_compressed((), {"w": jnp.asarray(x)}, {"w": jnp.asarray(pub)},
                                              a_consts)
        np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed["w"]), **TOL)
        has = np.asarray(raw.beta).sum(axis=1) > 0
        want_d = np.where(has[:, None], (np.asarray(a_consts.beta, np.float64) @ pub - x) / t,
                          0.0)
        np.testing.assert_allclose(d.numpy(), want_d, **TOL)
        assert not has.all()  # an offline peer: its d is 0, its raw beta row empty


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------


def _straggler(schedule="static", protocol="gossip", **kw):
    """straggler_k8 at period 4 and bound 2: ages 1, 2, a forced delivery,
    then a scheduled one, within 4 rounds."""
    rep = dict(schedule=schedule, protocol=protocol, staleness_bound=2) | kw
    return jconfigs.straggler_k8(**rep), tconfigs.straggler_k8(**rep)


def _setup(jexp, data, seed=0):
    x, y, _, _ = data
    parts = partition.pathological_partition(x, y, list(jexp.peer_classes),
                                             samples_per_class=jexp.samples_per_class)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(seed)
    exported = jax.tree.map(
        np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, jexp.p2p.num_peers)))
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jexp.p2p, data_sizes=sizes)
    return parts, sizes, exported, jstate


def _assert_state_close(tstate, jstate, task, what):
    layout = tp2p.ParamLayout.of(task)
    pairs = [(getattr(tstate, f), getattr(jstate, f))
             for f in ("params", "momentum", "d_bias", "b_bias")]
    assert (tstate.staleness == ()) == (jstate.staleness == ())
    if jstate.staleness != ():
        pairs.append((tstate.staleness.published, jstate.staleness.published))
        np.testing.assert_array_equal(tstate.staleness.age.numpy(),
                                      np.asarray(jstate.staleness.age), err_msg=what)
        assert tstate.staleness.age.dtype == torch.int32
    for got_flat, want_tree in pairs:
        got = layout.views(got_flat)
        for layer in ("fc1", "fc2", "out"):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(got[f"{layer}.{leaf}"].numpy(),
                                           np.asarray(want_tree[layer][leaf]), **TOL,
                                           err_msg=f"{what} {layer}.{leaf}")
    if jstate.protocol != ():
        np.testing.assert_allclose(tstate.protocol.mass.numpy(),
                                   np.asarray(jstate.protocol.mass), **TOL, err_msg=what)
    assert tstate.round_idx == int(jstate.round_idx), what


def test_masked_local_phase_equals_reference(mnist_small):
    jexp, texp = _straggler()
    jcfg = dataclasses.replace(jexp.p2p, momentum=0.5)
    tcfg = dataclasses.replace(texp.p2p, momentum=0.5)
    parts, sizes, exported, jstate = _setup(jexp, mnist_small, seed=1)
    task = ttask.get_task("mnist_mlp")
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    d = np.random.default_rng(2).normal(scale=1e-3, size=tstate.params.shape).astype(np.float32)
    d[:, task_size(task):] = 0.0
    tstate = tstate._replace(d_bias=torch.as_tensor(d))
    jstate = jstate._replace(d_bias=jax.tree.map(
        jnp.asarray, interop.params_to_jax(tp2p.ParamLayout.of(task).views(tstate.d_bias))))
    bx, by = jpipeline.PeerBatcher(parts, 10, seed=0).round_batches(tcfg.local_steps)
    steps = tp2p.compute_profile(tcfg)[0]
    assert steps.tolist() == [8] * 6 + [2, 2]
    jl, jloss = jp2p.local_phase(jstate, jmlp.loss_2nn, (jnp.asarray(bx), jnp.asarray(by)),
                                 jcfg, steps_k=jnp.asarray(steps))
    tl, tloss = tp2p.local_phase(tstate, task, (torch.as_tensor(bx), torch.as_tensor(by)),
                                 tcfg, steps_k=steps)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
    _assert_state_close(tl, jl, task, "masked local phase")


def task_size(task) -> int:
    return tp2p.ParamLayout.of(task).size


def test_capped_peers_equal_a_short_run_bit_for_bit(mnist_small):
    """Peer k with budget s ends the local phase where a T = s run ends,
    bit for bit (momentum and the affinity step included)."""
    _, texp = _straggler()
    tcfg = dataclasses.replace(texp.p2p, momentum=0.3, local_steps=6)
    task = ttask.get_task("mnist_mlp")
    parts = train.mnist_parts(texp, mnist_small[0], mnist_small[1])
    state = tp2p.init_state(task, tcfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    state = state._replace(d_bias=torch.as_tensor(
        rng.normal(scale=1e-3, size=state.params.shape).astype(np.float32)))
    bx, by = task.make_peer_batches(parts, 10, seed=0).round_batches_on(6, CPU)
    s = 2
    steps_k = np.array([6, s, 6, s, 6, 6, s, 1], dtype=np.int32)  # held rows in 3 runs
    capped, _ = tp2p.local_phase(state, task, (bx, by), tcfg, steps_k=steps_k)
    for budget in (s, 1):
        short, _ = tp2p.local_phase(state, task, (bx[:budget], by[:budget]),
                                    dataclasses.replace(tcfg, local_steps=budget))
        for k in np.flatnonzero(steps_k == budget):
            assert torch.equal(capped.params[k], short.params[k]), k
            assert torch.equal(capped.momentum[k], short.momentum[k]), k
    full, _ = tp2p.local_phase(state, task, (bx, by), tcfg)
    for k in np.flatnonzero(steps_k == 6):
        assert torch.equal(capped.params[k], full.params[k]), k


@pytest.mark.parametrize("schedule,protocol", [("static", "gossip"),
                                               ("round_robin", "push_sum")])
def test_straggler_rounds_equal_reference(schedule, protocol, mnist_small):
    """straggler_k8-shaped rounds (gossip on the static ring, push-sum on the
    ring/star round robin), each round started from the reference's state
    (``interop.state_from_jax``: published buffer and ages included).

    Teacher-forced, as the compressed rounds of tests/test_torch_round.py
    are: from one state the two packages' first local phase already
    differs by up to 3.8e-5 (a few coordinates, the summation orders of
    the two backends), and the affinity bias feeds such differences back
    through the neighbors, to 3e-4 by the third free-running round; from
    the reference's state each later round agrees to about 1.5e-8."""
    jexp, texp = _straggler(schedule, protocol)
    parts, sizes, exported, jstate = _setup(jexp, mnist_small)
    task = ttask.get_task("mnist_mlp")
    tstate = tp2p.init_state(task, texp.p2p, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    _assert_state_close(tstate, jstate, task, "init")
    assert tstate.staleness.published is not tstate.params
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jexp.p2p, data_sizes=sizes)
    tround = tp2p.make_round_fn(task, texp.p2p, sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    ages = []
    for r in range(ROUNDS):
        tstate = interop.state_from_jax(jax.tree.map(np.asarray, jstate), task)
        _assert_state_close(tstate, jstate, task, f"round {r} start")
        bx, by = jbatch.round_batches(jexp.p2p.local_steps)
        jl, jc, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tc, tloss = tround(tstate, (torch.as_tensor(bx), torch.as_tensor(by)))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        _assert_state_close(tl, jl, task, f"round {r} after local")
        _assert_state_close(tc, jc, task, f"round {r} after consensus")
        if protocol == "push_sum":
            assert abs(float(tc.protocol.mass.double().sum()) - 8.0) <= 1e-6 * 8
        ages.append(tc.staleness.age.tolist())
        jstate = jc
    assert [a[6:] for a in ages] == [[1, 1], [2, 2], [0, 0], [0, 0]]  # stale, forced, scheduled
    assert int(jstate.round_idx) == ROUNDS


# ---------------------------------------------------------------------------
# invariants of the port's rounds
# ---------------------------------------------------------------------------


def _port_rounds(texp, data, rounds, *, t=None):
    cfg = texp.p2p if t is None else dataclasses.replace(texp.p2p, local_steps=t)
    task = ttask.get_task("mnist_mlp")
    parts = train.mnist_parts(texp, data[0], data[1])
    sizes = partition.data_sizes(parts)
    state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    round_fn = tp2p.make_round_fn(task, cfg, sizes, device="cpu")
    batcher = task.make_peer_batches(parts, 10, seed=0)
    for _ in range(rounds):
        prev = state
        after_local, state, losses = round_fn(state, batcher.round_batches_on(cfg.local_steps,
                                                                              CPU))
        assert bool(torch.isfinite(losses).all())
        yield cfg, prev, after_local, state


def test_ages_within_bound_and_published_rows_frozen(mnist_small):
    _, texp = _straggler("round_robin", straggler_period=6, staleness_bound=3)
    seen = set()
    for cfg, prev, after_local, state in _port_rounds(texp, mnist_small, 8, t=2):
        age = state.staleness.age
        assert int(age.max()) <= cfg.staleness_bound
        seen |= set(age.tolist())
        for k in range(cfg.num_peers):
            want = (after_local.params[k] if int(age[k]) == 0
                    else prev.staleness.published[k])
            assert torch.equal(state.staleness.published[k], want), k
    assert seen == {0, 1, 2, 3}


@pytest.mark.parametrize("schedule", ["static", "round_robin"])
def test_push_sum_mass_conserved_under_maximal_staleness(schedule, mnist_small):
    _, texp = _straggler(schedule, "push_sum", straggler_frac=0.5, straggler_period=8,
                         staleness_bound=7)
    ages = []
    for cfg, _, _, state in _port_rounds(texp, mnist_small, 8, t=2):
        assert abs(float(state.protocol.mass.double().sum()) - 8.0) <= 1e-6 * 8
        ages.append(state.staleness.age.tolist())
    assert ages[6] == [0] * 4 + [7] * 4  # every straggler at the bound
    assert ages[7] == [0] * 8  # then its scheduled publication


SCAN_CASES = {
    "gossip_static": lambda: _straggler()[1],
    "push_sum_round_robin": lambda: _straggler("round_robin", "push_sum")[1],
    # the publication period 4 and the schedule's R = 2: the driver's period 4
    "linear_no_staleness": lambda: _straggler(steps_profile="linear", staleness_bound=0)[1],
    "momentum_eta_b_s2": lambda: dataclasses.replace(
        _straggler(straggler_period=3)[1], p2p=dataclasses.replace(
            _straggler(straggler_period=3)[1].p2p, momentum=0.5, eta_b=0.1,
            consensus_steps=2)),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_driver_bit_identical_to_python_driver(case, mnist_small):
    """Two chunks of C = 3 rounds == 6 python-driver rounds, bit for bit on
    every leaf (published snapshots and ages included) and on the losses."""
    texp = SCAN_CASES[case]()
    cfg = dataclasses.replace(texp.p2p, local_steps=2)
    texp = dataclasses.replace(texp, p2p=cfg)
    task = ttask.get_task("mnist_mlp")
    parts = train.mnist_parts(texp, mnist_small[0], mnist_small[1])
    sizes = partition.data_sizes(parts)
    round_fn = tp2p.make_round_fn(task, cfg, sizes, device="cpu")
    state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    batcher = task.make_peer_batches(parts, 10, seed=0)
    want_losses = []
    for _ in range(6):
        want_local, state, loss = round_fn(state, batcher.round_batches_on(2, CPU))
        want_losses.append(loss)
    drive = tp2p.make_scan_driver(task, cfg, sizes, device="cpu")
    got = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    batcher = task.make_peer_batches(parts, 10, seed=0)
    got_losses = []
    for _ in range(2):
        got_local, got, loss = drive(got, batcher.chunk_batches_on(2, 3, CPU))
        got_losses.append(loss)
    assert torch.equal(torch.cat(got_losses), torch.stack(want_losses))
    for g, w in ((got, state), (got_local, want_local)):
        assert g.round_idx == w.round_idx
        leaves = list(zip(tp2p.state_leaves(g), tp2p.state_leaves(w)))
        assert len(leaves) == (6 if cfg.staleness_bound else 4) + (cfg.protocol == "push_sum")
        for i, (a, b) in enumerate(leaves):
            assert a.dtype == b.dtype and torch.equal(a, b), i


# ---------------------------------------------------------------------------
# feature table, runtimes and CLI errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(steps_profile="straggler", staleness_bound=3),
    dict(steps_profile="linear"),
    dict(staleness_bound=2),
])
def test_async_rejected_by_hierarchical_runtime_with_reference_message(kw):
    jcfg = jp2p.P2PConfig(num_peers=8, **kw)
    tcfg = tp2p.P2PConfig(num_peers=8, **kw)
    with pytest.raises(ValueError) as want:
        jfeatures.check_config(jcfg, peers_per_device=8)
    assert "asynchronous rounds" in str(want.value)
    task = ttask.get_task("mnist_mlp")
    for build in (lambda: tp2p.make_hier_round_fn(task, tcfg, peers_per_device=8, device="cpu"),
                  lambda: tp2p.make_scan_driver(task, tcfg, peers_per_device=8, device="cpu")):
        with pytest.raises(ValueError) as got:
            build()
        assert str(got.value) == str(want.value)
    exp = dataclasses.replace(tconfigs.timevarying_k8(), p2p=dataclasses.replace(
        tconfigs.timevarying_k8().p2p, **kw))
    with pytest.raises(ValueError) as got:
        train.run_paper_experiment(exp, rounds=1, device="cpu", peer_axis="pod",
                                   peers_per_device=8)
    assert str(got.value) == str(want.value)


def _cli_error(main, argv) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ex:
        main(argv)
    assert ex.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["--experiment", "straggler_k8", "--compressor", "topk"],
    ["--experiment", "straggler_k8", "--peer-axis", "pod", "--peers-per-device", "2"],
    ["--experiment", "straggler_k8", "--peer-axis", "pod", "--peers-per-device", "8"],
    ["--experiment", "straggler_k8", "--schedule", "link_dropout"],
    ["--experiment", "timevarying_k8", "--compressor", "topk", "--staleness-bound", "2"],
    ["--experiment", "timevarying_k8", "--staleness-decay", "0"],
    ["--experiment", "iid_k100", "--steps-profile", "linear", "--peer-axis", "pod",
     "--peers-per-device", "100"],
])
def test_cli_errors_match_reference(argv):
    assert _cli_error(train.main, ["--device", "cpu", *argv]) == _cli_error(jtrain.main, argv)


def test_cli_trains_straggler_k8_both_drivers(mnist_small, monkeypatch, capsys):
    """``--experiment straggler_k8`` end to end on the CPU under both drivers
    (push-sum on the round robin), on the small synthetic data: the same
    logged losses and accuracies."""
    from repro_torch.data import synthetic

    monkeypatch.setattr(synthetic, "mnist_like", lambda *a, **k: mnist_small)
    lines = {}
    for driver in ("python", "scan"):
        train.main(["--device", "cpu", "--experiment", "straggler_k8", "--schedule",
                    "round_robin", "--protocol", "push_sum", "--rounds", "3", "--local-steps",
                    "2", "--driver", driver])
        out = capsys.readouterr().out
        lines[driver] = [ln.split(" (")[0] for ln in out.splitlines() if ln.startswith("round")]
    assert len(lines["python"]) == 3 and lines["python"] == lines["scan"]


def test_run_paper_experiment_async_overrides_apply():
    """``--steps-profile`` / ``--staleness-bound`` / ``--staleness-decay``
    reach any experiment's config, as the reference's ``async_overrides``."""
    seen = {}

    def fake_run(exp, **kw):
        seen["cfg"] = exp.p2p
        return type("Log", (), {"capture_seconds": 0.0})()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "run_paper_experiment", fake_run)
        train.main(["--device", "cpu", "--experiment", "iid_k100", "--steps-profile",
                    "straggler", "--staleness-bound", "3", "--staleness-decay", "0.25",
                    "--rounds", "1"])
    cfg = seen["cfg"]
    assert (cfg.steps_profile, cfg.staleness_bound, cfg.staleness_decay) == (
        "straggler", 3, 0.25)
    assert cfg.num_peers == 100 and cfg.use_async


def test_decay_underflow_departs_from_reference():
    """A reference quirk the port departs from: when ``staleness_decay **
    age`` underflows float32 (below 2^-149: age >= 150 at decay 0.5) for
    every in-neighbor of a peer, the reference's renormalised beta row is
    0 while its raw row is not, so its d = (0 - x) / T drags the peer to
    the origin; the snapshot mode reads the peer's support from the
    decayed row and keeps d = 0, as for a peer with nothing received.
    Everything else of the phase agrees."""
    kw = dict(num_peers=2, topology="complete", local_steps=5, eta_d=0.5,
              steps_profile="straggler", straggler_frac=0.5, straggler_period=400,
              staleness_bound=300)
    tcfg, jcfg = tp2p.P2PConfig(**kw), jp2p.P2PConfig(**kw)
    rng = np.random.default_rng(5)
    x, pub = (rng.normal(size=(2, 6)).astype(np.float32) for _ in range(2))
    age = np.array([0, 160], np.int32)  # peer 1 stale past float32's range
    zeros = np.zeros_like(x)
    tstate = tp2p.P2PState(*(torch.as_tensor(a) for a in (x, zeros, zeros, zeros)), 0,
                           staleness=tp2p.StalenessState(torch.as_tensor(pub),
                                                         torch.as_tensor(age)))
    tree = lambda a: {"w": jnp.asarray(a)}  # noqa: E731
    jstate = jp2p.P2PState(tree(x), tree(zeros), tree(zeros), tree(zeros), jnp.int32(0), (), (),
                           (), jp2p.StalenessState(tree(pub), jnp.asarray(age)))
    jconsts, _ = jp2p.protocol_constants(jcfg)
    got = tp2p.consensus_phase(tstate, tcfg, tp2p.round_operands(tcfg, device="cpu")[0])
    want = jp2p.consensus_phase(jstate, jcfg, jprotocols.round_constants(jconsts, 0))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params["w"]), **TOL)
    np.testing.assert_array_equal(got.staleness.age.numpy(), np.asarray(want.staleness.age))
    np.testing.assert_allclose(got.d_bias[1].numpy(), np.asarray(want.d_bias["w"][1]), **TOL)
    assert torch.equal(got.d_bias[0], torch.zeros(6))
    np.testing.assert_allclose(np.asarray(want.d_bias["w"][0]), -x[0] / 5, **TOL)

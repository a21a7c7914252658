"""Port parity, adaptive partner selection (``schedule="adaptive"``):
``repro_torch`` against ``repro`` on the CPU, the 2NN at ``mnist_small``
shards for the rounds.

* The threefry stream (``repro_torch.core.prng``): ``prng_key``, ``split``,
  ``random_bits32``, ``uniform`` and ``bernoulli`` ``array_equal`` to
  ``jax.random`` for several keys and shapes.
* Selection: ``partner_scores``, ``greedy_matching`` and
  ``matching_matrices`` for every rule and K in {2, 5, 8}, given the same
  losses and key: scores, partner and Beta ``array_equal``, W allclose at
  rtol 1e-6 and in fact exact (every entry is one float32 division or
  remainder on either side), rows (gossip) or columns (push-sum) summing to 1.
* The dense-dynamic entry points' plain path against the reference's
  ``consensus_mix_dense`` / ``consensus_mix_push_sum_dense`` (Pallas in
  interpret mode on the CPU) at atol 5e-5 / rtol 1e-4.
* Rounds shaped like ``timevarying_k8`` / ``directed_k8`` with
  ``schedule="adaptive"``, 3 rounds each started from the reference's state
  (``interop.state_from_jax``, the key and the last losses included):
  gossip and push-sum under ``loss_proximity`` and ``eps_greedy``, and one
  qint8 case; allclose after local and after consensus, the key equal.
  Teacher-forced, as the async and compressed rounds are: the packages'
  local phases differ by summation order, the affinity bias feeds that back,
  and a near tie of two losses would then pick another partner.
* In the port: the scan driver equal to the python driver on every leaf;
  push-sum's mass summing to K; round 0's tie-break pairing.
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
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.data import partition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels.consensus_mix import ops as jops  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import features as tfeatures  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as cm_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
CPU = torch.device("cpu")
ROUNDS = 3


def _tkey(jkey) -> torch.Tensor:
    return interop.key_from_jax(jkey)


# ---------------------------------------------------------------------------
# the threefry stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -3, 2**32 + 5])
def test_prng_key_split_bits_uniform_equal_jax(seed):
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey).astype(np.int64))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(tkey, n).numpy(),
                                      np.asarray(jax.random.split(jkey, n)).astype(np.int64))
    for shape in ((), (1,), (5, 5), (8, 8), (3, 7)):
        np.testing.assert_array_equal(prng.random_bits32(tkey, shape).numpy(),
                                      np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
        got, want = prng.uniform(tkey, shape), np.asarray(jax.random.uniform(jkey, shape))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.3333, 0.5, 0.9, 1.0])
def test_bernoulli_equals_jax(p):
    base = jax.random.PRNGKey(11)
    draws = []
    for s in range(40):
        jkey = jax.random.fold_in(base, s)
        got = prng.bernoulli(_tkey(jkey), p)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == bool(jax.random.bernoulli(jkey, p)), s
        draws.append(bool(got))
    if 0.0 < p < 1.0:
        assert 0 < sum(draws) < len(draws)


def test_key_interop_round_trip():
    jkey = jax.random.split(jax.random.PRNGKey(3), 4)
    tkey = interop.key_from_jax(np.asarray(jkey))
    assert tkey.dtype == torch.int64 and tuple(tkey.shape) == (4, 2)
    back = interop.key_to_jax(tkey)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, np.asarray(jkey))
    with pytest.raises(ValueError, match="uint32"):
        interop.key_from_jax(np.zeros(2, np.int32))


# ---------------------------------------------------------------------------
# the selection: scores, matching, matrices
# ---------------------------------------------------------------------------


def _losses(k, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=k).astype(np.float32)


@pytest.mark.parametrize("rule", jgraph.ADAPTIVE_RULES)
@pytest.mark.parametrize("k", [2, 5, 8])
def test_selection_equals_reference(rule, k):
    sizes = np.arange(1, k + 1, dtype=np.float32) * 10
    for seed in range(4):
        losses = _losses(k, seed)
        jkey = jax.random.PRNGKey(seed + 5)
        want_s = np.asarray(jgraph.partner_scores(jnp.asarray(losses), jkey, rule, 0.5))
        got_s = tgraph.partner_scores(torch.as_tensor(losses), _tkey(jkey), rule, 0.5)
        assert got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_s.numpy(), want_s)
        want_p = np.asarray(jgraph.greedy_matching(jnp.asarray(want_s)))
        got_p = tgraph.greedy_matching(got_s).numpy()
        np.testing.assert_array_equal(got_p, want_p)
        assert (got_p[got_p] == np.arange(k)).all()
        assert (got_p == np.arange(k)).sum() == k % 2
        for stochasticity, axis in (("row", 1), ("column", 0)):
            for eps in (1.0, 0.3):
                jw, jb = jgraph.matching_matrices(
                    jnp.asarray(want_p), data_sizes=jnp.asarray(sizes),
                    consensus_step_size=eps, stochasticity=stochasticity)
                tw, tb = tgraph.matching_matrices(
                    torch.as_tensor(got_p), data_sizes=torch.as_tensor(sizes),
                    consensus_step_size=eps, stochasticity=stochasticity)
                assert tw.dtype == tb.dtype == torch.float32
                np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
                np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))  # exact
                np.testing.assert_allclose(tw.double().sum(dim=axis).numpy(), 1.0, atol=1e-6)
                assert bool((tw >= 0).all())


@pytest.mark.parametrize("rule", jgraph.ADAPTIVE_RULES)
@pytest.mark.parametrize("stochasticity", ["row", "column"])
def test_adaptive_round_matrices_equal_reference(rule, stochasticity):
    k = 9  # one peer left unmatched: its W row / column is e_k, its Beta row 0
    losses = _losses(k, 3)
    sizes = np.arange(3, 3 + k, dtype=np.float32)
    jkey = jax.random.PRNGKey(2)
    jw, jb = jgraph.adaptive_round_matrices(
        jnp.asarray(losses), jkey, rule=rule, eps=0.4, data_sizes=jnp.asarray(sizes),
        stochasticity=stochasticity)
    tw, tb = tgraph.adaptive_round_matrices(
        torch.as_tensor(losses), _tkey(jkey), rule=rule, eps=0.4,
        data_sizes=torch.as_tensor(sizes), stochasticity=stochasticity)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    lone = np.flatnonzero(tb.sum(dim=1).numpy() == 0)
    assert lone.size == 1
    assert tw[lone[0], lone[0]] == 1.0


def test_zero_losses_give_the_tie_break_pairing():
    """Round 0 (every loss 0): every pair ties and the first flat index wins,
    (0, 1), (2, 3), ...; the reference pairs the same."""
    for k in (2, 7, 8):
        got = tgraph.greedy_matching(tgraph.partner_scores(torch.zeros(k), prng.prng_key(0)))
        want = np.asarray(jgraph.greedy_matching(jgraph.partner_scores(
            jnp.zeros(k), jax.random.PRNGKey(0))))
        np.testing.assert_array_equal(got.numpy(), want)
        pairs = [(i, i + 1) for i in range(0, k - 1, 2)]
        assert all(int(got[i]) == j and int(got[j]) == i for i, j in pairs)


def test_builders_reject_unknown_names():
    with pytest.raises(ValueError) as want:
        jgraph.partner_scores(jnp.zeros(3), jax.random.PRNGKey(0), "nearest")
    with pytest.raises(ValueError) as got:
        tgraph.partner_scores(torch.zeros(3), prng.prng_key(0), "nearest")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jgraph.matching_matrices(jnp.arange(2), stochasticity="doubly")
    with pytest.raises(ValueError) as got:
        tgraph.matching_matrices(torch.arange(2), stochasticity="doubly")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the dense-dynamic entry points (the kernels' plain path on the CPU)
# ---------------------------------------------------------------------------


def test_consensus_mix_dense_equals_reference(rng):
    k, n, t = 8, 37, 3
    x = rng.normal(size=(k, n)).astype(np.float32)
    losses = rng.normal(size=(k,)).astype(np.float32)
    sizes = np.arange(1, k + 1, dtype=np.float32)
    w, beta = tgraph.adaptive_round_matrices(torch.as_tensor(losses), prng.prng_key(6),
                                             data_sizes=torch.as_tensor(sizes))
    mixed, d = cm_ops.consensus_mix_dense(torch.as_tensor(x), w, beta, t)
    jmixed, jd = jops.consensus_mix_dense({"a": jnp.asarray(x)}, jnp.asarray(w.numpy()),
                                          jnp.asarray(beta.numpy()), t)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed["a"]), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd["a"]), **TOL)
    # and the runtime's einsum mix
    want = np.asarray(jconsensus.mix_stacked(jnp.asarray(w.numpy()), {"a": jnp.asarray(x)})["a"])
    np.testing.assert_allclose(mixed.numpy(), want, **TOL)
    ops = cm_ops.dense_operands(w, beta, cm_ops.complete_candidates(k, CPU))
    assert tuple(ops.nbr_idx.shape) == (k, k - 1) and ops.nbr_idx.dtype == torch.int32
    assert int((ops.beta != 0).sum()) == k  # one partner a peer, every slot read


def test_consensus_mix_push_sum_dense_equals_reference(rng):
    k, n, t = 8, 29, 4
    x = rng.normal(size=(k, n)).astype(np.float32)
    losses = rng.normal(size=(k,)).astype(np.float32)
    w, beta = tgraph.adaptive_round_matrices(
        torch.as_tensor(losses), prng.prng_key(7), rule="random", stochasticity="column",
        data_sizes=torch.arange(1.0, k + 1))
    mass = (k * rng.dirichlet(np.ones(k))).astype(np.float32)
    mixed, d, y = cm_ops.consensus_mix_push_sum_dense(torch.as_tensor(x), torch.as_tensor(mass),
                                                      w, beta, t)
    jmixed, jd, jy = jops.consensus_mix_push_sum_dense(
        {"a": jnp.asarray(x)}, jnp.asarray(mass), jnp.asarray(w.numpy()),
        jnp.asarray(beta.numpy()), t)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed["a"]), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd["a"]), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    jstate, jproto_mixed = jprotocols.get_protocol("push_sum").mix(
        jprotocols.PushSumState(mass=jnp.asarray(mass)), {"a": jnp.asarray(x)},
        jprotocols.ProtocolConstants(w=jnp.asarray(w.numpy()), beta=jnp.asarray(beta.numpy())))
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jproto_mixed["a"]), **TOL)
    np.testing.assert_allclose(float(y.double().sum()), k, rtol=1e-6)


def test_dense_candidates_reject_a_single_peer():
    for call in (lambda: cm_ops.consensus_mix_dense(torch.ones(1, 4), torch.ones(1, 1),
                                                    torch.zeros(1, 1), 3),
                 lambda: jops.consensus_mix_dense({"a": jnp.ones((1, 4))}, jnp.ones((1, 1)),
                                                  jnp.zeros((1, 1)), 3)):
        with pytest.raises(ValueError, match="dense-dynamic consensus needs at least two peers"):
            call()


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------


def _adaptive_exp(kind, rule):
    """The two packages' experiment of one kind: timevarying_k8 (gossip),
    directed_k8 (push-sum) or timevarying_k8 with qint8, at T = 4; eps 0.5,
    so under eps_greedy the seed-0 key explores in round 0 only."""
    kw = dict(schedule="adaptive", partner_rule=rule, adaptive_eps=0.5, local_steps=4)
    if kind == "push_sum":
        return jconfigs.directed_k8(**kw), tconfigs.directed_k8(**kw)
    extra = dict(compressor="qint8") if kind == "qint8" else {}
    return (jconfigs.timevarying_k8(**kw, **extra), tconfigs.timevarying_k8(**kw, **extra))


def _setup(jexp, data, seed=0):
    x, y, _, _ = data
    parts = partition.pathological_partition(x, y, list(jexp.peer_classes),
                                             samples_per_class=jexp.samples_per_class)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(seed)
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jexp.p2p, data_sizes=sizes)
    return parts, sizes, jstate


def _assert_state_close(tstate, jstate, task, what):
    layout = tp2p.ParamLayout.of(task)
    trees = [(getattr(tstate, f), getattr(jstate, f))
             for f in ("params", "momentum", "d_bias", "b_bias")]
    if jstate.compression != ():
        trees.append((tstate.compression, jstate.compression))
    for got_flat, want_tree in trees:
        got = layout.views(got_flat)
        for layer in ("fc1", "fc2", "out"):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(got[f"{layer}.{leaf}"].numpy(),
                                           np.asarray(want_tree[layer][leaf]), **TOL,
                                           err_msg=f"{what} {layer}.{leaf}")
    if jstate.protocol != ():
        np.testing.assert_allclose(tstate.protocol.mass.numpy(),
                                   np.asarray(jstate.protocol.mass), **TOL, err_msg=what)
    np.testing.assert_array_equal(interop.key_to_jax(tstate.adaptive.key),
                                  np.asarray(jstate.adaptive.key), err_msg=what)
    np.testing.assert_allclose(tstate.adaptive.last_losses.numpy(),
                               np.asarray(jstate.adaptive.last_losses), **TOL, err_msg=what)
    assert tstate.round_idx == int(jstate.round_idx), what


def test_init_state_equals_reference(mnist_small):
    jexp, texp = _adaptive_exp("gossip", "loss_proximity")
    jexp = dataclasses.replace(jexp, p2p=dataclasses.replace(jexp.p2p, adaptive_seed=9))
    texp = dataclasses.replace(texp, p2p=dataclasses.replace(texp.p2p, adaptive_seed=9))
    _, sizes, jstate = _setup(jexp, mnist_small)
    tstate = tp2p.init_state(ttask.get_task("mnist_mlp"), texp.p2p, data_sizes=sizes,
                             device="cpu")
    assert tstate.adaptive.key.dtype == torch.int64
    np.testing.assert_array_equal(interop.key_to_jax(tstate.adaptive.key),
                                  np.asarray(jstate.adaptive.key))
    assert tstate.adaptive.last_losses.dtype == torch.float32
    assert not bool(tstate.adaptive.last_losses.any())
    assert tp2p.init_state(ttask.get_task("mnist_mlp"), tp2p.P2PConfig(num_peers=4),
                           device="cpu").adaptive == ()


@pytest.mark.parametrize("kind,rule", [
    ("gossip", "loss_proximity"), ("gossip", "eps_greedy"), ("push_sum", "loss_proximity"),
    ("push_sum", "eps_greedy"), ("qint8", "random"),
])
def test_adaptive_rounds_equal_reference(kind, rule, mnist_small):
    jexp, texp = _adaptive_exp(kind, rule)
    parts, sizes, jstate = _setup(jexp, mnist_small)
    task = ttask.get_task("mnist_mlp")
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jexp.p2p, data_sizes=sizes)
    tround = tp2p.make_round_fn(task, texp.p2p, sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    partners = []
    for r in range(ROUNDS):
        tstate = interop.state_from_jax(jax.tree.map(np.asarray, jstate), task)
        _assert_state_close(tstate, jstate, task, f"round {r} start")
        bx, by = jbatch.round_batches(jexp.p2p.local_steps)
        jl, jc, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tc, tloss = tround(tstate, (torch.as_tensor(bx), torch.as_tensor(by)))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        _assert_state_close(tl, jl, task, f"round {r} after local")
        _assert_state_close(tc, jc, task, f"round {r} after consensus")
        if kind == "push_sum":
            assert abs(float(tc.protocol.mass.double().sum()) - 8.0) <= 1e-6 * 8
        ops, _ = tp2p.adaptive_operands(tstate.adaptive, texp.p2p, tp2p.round_operands(
            texp.p2p, sizes, device="cpu")[0])
        partners.append(ops.nbr_idx.gather(1, ops.beta.argmax(dim=1, keepdim=True)).ravel())
        jstate = jc
    if rule == "loss_proximity":  # round 0: every loss 0, the tie-break pairing
        assert partners[0].tolist() == [1, 0, 3, 2, 5, 4, 7, 6]
    assert any(not torch.equal(partners[0], p) for p in partners[1:]), "matching never moved"
    assert int(jstate.round_idx) == ROUNDS


# ---------------------------------------------------------------------------
# invariants of the port's rounds
# ---------------------------------------------------------------------------


def _port_setup(texp, data):
    task = ttask.get_task("mnist_mlp")
    parts = train.mnist_parts(texp, data[0], data[1])
    sizes = partition.data_sizes(parts)
    return task, parts, sizes


def test_push_sum_mass_conserved(mnist_small):
    _, texp = _adaptive_exp("push_sum", "random")
    cfg = dataclasses.replace(texp.p2p, local_steps=2)
    task, parts, sizes = _port_setup(texp, mnist_small)
    state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    round_fn = tp2p.make_round_fn(task, cfg, sizes, device="cpu")
    batcher = task.make_peer_batches(parts, 10, seed=0)
    for _ in range(6):
        _, state, losses = round_fn(state, batcher.round_batches_on(2, CPU))
        assert bool(torch.isfinite(losses).all())
        assert abs(float(state.protocol.mass.double().sum()) - 8.0) <= 1e-6 * 8
        assert bool((state.protocol.mass > 0).all())


SCAN_CASES = {
    "gossip_loss_proximity": ("gossip", "loss_proximity", {}),
    "push_sum_random": ("push_sum", "random", {}),
    "qint8_eps_greedy": ("qint8", "eps_greedy", {}),
    # a step-budget profile (no staleness), momentum, eta_b and S = 2
    "linear_momentum_s2": ("gossip", "eps_greedy", dict(
        steps_profile="linear", momentum=0.5, eta_b=0.1, consensus_steps=2)),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_driver_bit_identical_to_python_driver(case, mnist_small):
    """Two chunks of C = 3 rounds == 6 python-driver rounds, bit for bit on
    every leaf (the key and the last losses included) and on the losses."""
    kind, rule, extra = SCAN_CASES[case]
    _, texp = _adaptive_exp(kind, rule)
    cfg = dataclasses.replace(texp.p2p, local_steps=2, **extra)
    task, parts, sizes = _port_setup(texp, mnist_small)
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
        assert len(leaves) == 6 + (kind == "push_sum") + (kind == "qint8")
        for i, (a, b) in enumerate(leaves):
            assert a.dtype == b.dtype and torch.equal(a, b), i
    assert got.adaptive.key.dtype == torch.int64 and bool((got.adaptive.key[0] != 0).any())


def test_round_picker_gives_static_operands():
    cfg = tp2p.P2PConfig(num_peers=5, schedule="adaptive")
    pick, period = tp2p.round_picker(cfg, np.arange(1, 6), device="cpu")
    assert period == 1 and pick(0) is pick(7)
    ops = pick(0)
    assert isinstance(ops, tp2p.AdaptiveRoundOps)
    assert ops.nbr_idx.dtype == torch.int32 and tuple(ops.nbr_idx.shape) == (5, 4)
    assert ops.data_sizes.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert tp2p.round_operands(cfg, device="cpu")[0].data_sizes.tolist() == [1.0] * 5


# ---------------------------------------------------------------------------
# config, feature table, runtimes and CLI errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(partner_rule="nope"), dict(adaptive_eps=1.5), dict(adaptive_eps=-0.1),
    dict(schedule="adaptive", num_peers=1), dict(schedule="adaptve"),
    dict(schedule="adaptive", staleness_bound=2),
    dict(schedule="adaptive", staleness_bound=1, steps_profile="straggler"),
])
def test_config_errors_match_reference(kw):
    kw = dict(num_peers=8) | kw
    with pytest.raises(ValueError) as want:
        jp2p.P2PConfig(**kw)
    with pytest.raises(ValueError) as got:
        tp2p.P2PConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(protocol="push_sum", partner_rule="random"),
    dict(compressor="qint8", partner_rule="eps_greedy", adaptive_eps=0.0),
    dict(steps_profile="linear", adaptive_seed=4),
])
def test_adaptive_configs_build_as_in_reference(kw):
    kw = dict(num_peers=8, schedule="adaptive") | kw
    assert dataclasses.asdict(tp2p.P2PConfig(**kw)) == dataclasses.asdict(jp2p.P2PConfig(**kw))


def test_build_schedule_raises_for_adaptive():
    cfg, jcfg = (mod.P2PConfig(schedule="adaptive", num_peers=2) for mod in (tp2p, jp2p))
    with pytest.raises(ValueError) as want:
        jp2p.build_schedule(jcfg)
    for call in (lambda: tp2p.build_schedule(cfg),
                 lambda: tp2p.schedule_operands(cfg, device="cpu")):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_feature_table_follows_reference():
    """The port's pairs are the reference's pairs over the features it runs,
    in the reference's order and words."""
    ported = set(tfeatures.FEATURES)
    want = [(i.a, i.b, i.reason, i.workaround) for i in jfeatures.INCOMPATIBILITIES
            if i.a in ported and i.b in ported]
    got = [(i.a, i.b, i.reason, i.workaround) for i in tfeatures.INCOMPATIBILITIES]
    assert got == want
    assert {"adaptive", "staleness", "hierarchical"} <= ported
    ctx = dict(schedule="adaptive", staleness_bound=2, peers_per_device=8)
    for name in ported:
        assert (tfeatures.FEATURES[name].describe(tfeatures.FeatureContext(**ctx))
                == jfeatures.FEATURES[name].describe(jfeatures.FeatureContext(**ctx)))


def test_adaptive_rejected_by_hierarchical_runtime_with_reference_message():
    jcfg = jp2p.P2PConfig(num_peers=8, schedule="adaptive")
    tcfg = tp2p.P2PConfig(num_peers=8, schedule="adaptive")
    with pytest.raises(ValueError) as want:
        jfeatures.check_config(jcfg, peers_per_device=8)
    assert "schedule='adaptive'" in str(want.value)
    task = ttask.get_task("mnist_mlp")
    exp = tconfigs.timevarying_k8(schedule="adaptive")
    for build in (lambda: tp2p.make_hier_round_fn(task, tcfg, peers_per_device=8, device="cpu"),
                  lambda: tp2p.make_scan_driver(task, tcfg, peers_per_device=8, device="cpu"),
                  lambda: train.run_paper_experiment(exp, rounds=1, device="cpu",
                                                     peer_axis="pod", peers_per_device=8)):
        with pytest.raises(ValueError) as got:
            build()
        assert str(got.value) == str(want.value)


def _cli_error(main, argv) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ex:
        main(argv)
    assert ex.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["--experiment", "timevarying_k8", "--schedule", "adaptive", "--adaptive-eps", "2"],
    ["--experiment", "timevarying_k8", "--adaptive-eps", "-0.5"],
    ["--experiment", "timevarying_k8", "--schedule", "adaptive", "--partner-rule", "nearest"],
    ["--experiment", "timevarying_k8", "--schedule", "adaptive", "--staleness-bound", "2"],
    ["--experiment", "timevarying_k8", "--schedule", "adaptive", "--peer-axis", "pod",
     "--peers-per-device", "8"],
])
def test_cli_errors_match_reference(argv):
    assert _cli_error(train.main, ["--device", "cpu", *argv]) == _cli_error(jtrain.main, argv)


def test_cli_passes_the_selection_flags():
    seen = {}

    def fake_run(exp, **kw):
        seen["cfg"] = exp.p2p
        return type("Log", (), {"capture_seconds": 0.0})()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "run_paper_experiment", fake_run)
        train.main(["--device", "cpu", "--experiment", "directed_k8", "--schedule", "adaptive",
                    "--partner-rule", "eps_greedy", "--adaptive-eps", "0.25",
                    "--adaptive-seed", "3", "--rounds", "1"])
    cfg = seen["cfg"]
    assert (cfg.schedule, cfg.protocol, cfg.partner_rule, cfg.adaptive_eps,
            cfg.adaptive_seed) == ("adaptive", "push_sum", "eps_greedy", 0.25, 3)


def test_cli_trains_adaptive_both_drivers(mnist_small, monkeypatch, capsys):
    """``--schedule adaptive`` end to end on the CPU under both drivers, on
    the small synthetic data: the same logged losses and accuracies."""
    from repro_torch.data import synthetic

    monkeypatch.setattr(synthetic, "mnist_like", lambda *a, **k: mnist_small)
    lines = {}
    for driver in ("python", "scan"):
        train.main(["--device", "cpu", "--experiment", "timevarying_k8", "--schedule",
                    "adaptive", "--partner-rule", "eps_greedy", "--rounds", "3",
                    "--local-steps", "2", "--driver", driver])
        out = capsys.readouterr().out
        lines[driver] = [ln.split(" (")[0] for ln in out.splitlines() if ln.startswith("round")]
    assert len(lines["python"]) == 3 and lines["python"] == lines["scan"]

"""Port parity, ``rwkv6_seqmnist``: RWKV6 run as a recurrent network over the
196-token pixel stream of sequential MNIST, trained by P2PL (the reference's
``core/task.py``, ``configs/p2pl_mnist.py:seqmnist_k8``).

Held to the reference at its four levels:

1. exact: ``images_to_tokens`` and ``TokenSequenceBatcher``'s batches;
2. allclose: the classifier's logits, loss and per-leaf gradients (against
   ``jax.grad``) from exported reference parameters, ``rwkv6_features`` in
   both forms, ``rwkv6_loss_fn`` and its gradient;
3. allclose rounds, teacher-forced: each round the port's local phase from
   the reference's state and its consensus phase from the reference's
   post-local state (``interop.state_from_jax``), for ``seqmnist_k8``
   gossip, push-sum (with the mass) and one qint8 round;
4. behaviour: the reference's ``test_rwkv6_seqmnist_trains_vmap`` claims.

Plus both drivers bit for bit, the chunked and subsampled evaluation, the
configs, the CLI, the feature table's ``real_model`` row, and the
attention wrapper's path through its ``autograd.Function`` (the WKV's and
the SSD's are tests/test_torch_ssm_train.py's).

Tolerance: float32 atol 5e-5 / rtol 1e-4 (tests/test_kernels.py's float32
tolerance) everywhere, the 196-step recurrence included: TF32 is off and the
two packages differ only in summation order; the measured differences are
about 1e-6 on the features and logits and 1e-7 on the gradients, so the
recurrence needs no wider tolerance.  Batches are kept small (K = 8 with B
= 4, or K = 2) to keep the CPU's token loop short.
"""
import dataclasses
import inspect

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
from repro.data import partition, synthetic  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import features as tfeatures  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
NAME = "rwkv6_seqmnist"
CPU = torch.device("cpu")


def _flat(tree) -> dict[str, np.ndarray]:
    """A reference tree as the port's flat dotted names, numpy values."""
    return {n: t.numpy() for n, t in interop.params_from_jax(jax.tree.map(np.asarray,
                                                                          tree)).items()}


# ---------------------------------------------------------------------------
# level 1: tokens and batches, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool,bins", [(2, 16), (1, 16), (4, 8)])
def test_images_to_tokens_equal_reference(pool, bins, mnist_small):
    x = np.concatenate([mnist_small[0][:64], np.full((1, 784), 9.0, np.float32),
                        np.full((1, 784), -9.0, np.float32)])  # + both edge bins
    got = tpipeline.images_to_tokens(x, num_bins=bins, pool=pool)
    want = jpipeline.images_to_tokens(x, num_bins=bins, pool=pool)
    assert got.dtype == want.dtype and got.shape == (66, (28 // pool) ** 2)
    np.testing.assert_array_equal(got, want)
    assert got[-2].min() == bins - 1 and got[-1].max() == 0


def test_images_to_tokens_rejects_bad_pool_as_reference():
    x = np.zeros((2, 784), np.float32)
    with pytest.raises(ValueError) as want:
        jpipeline.images_to_tokens(x, pool=3)
    with pytest.raises(ValueError) as got:
        tpipeline.images_to_tokens(x, pool=3)
    assert str(got.value) == str(want.value)


def test_token_batcher_equals_reference(mnist_small):
    """Round batches and a scan chunk equal the reference's, int64 tokens on
    the device; the image batcher's device copy stays float32."""
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, [(0, 1), (2, 3), (4, 5)],
                                             samples_per_class=20)
    jb = jpipeline.TokenSequenceBatcher(parts, 4, seed=7)
    tb = tpipeline.TokenSequenceBatcher(parts, 4, seed=7)
    assert tb.num_peers == 3
    for _ in range(3):  # the third round crosses an epoch: a reshuffle
        bx, by = jb.round_batches(5)
        tx, ty = tb.round_batches_on(5, CPU)
        assert tx.dtype == ty.dtype == torch.int64 and tuple(tx.shape) == (5, 3, 4, 196)
        np.testing.assert_array_equal(tx.numpy(), bx)
        np.testing.assert_array_equal(ty.numpy(), by)
    bx, by = jb.round_batches(2 * 3)
    chunk = tb.chunk_batches_on(2, 3, CPU)
    assert tuple(chunk.idx.shape) == (3, 2, 3, 4)
    np.testing.assert_array_equal(chunk.x_all[chunk.idx].numpy(), bx.reshape(3, 2, 3, 4, 196))
    np.testing.assert_array_equal(chunk.y_all[chunk.idx].numpy(), by.reshape(3, 2, 3, 4))
    assert tpipeline.PeerBatcher(parts, 4).resident(CPU)[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# level 2: the classifier, the features and the loss, allclose
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jinit():
    """The reference task's init, jitted once (an eager draw of the 31
    leaves, vmapped over peers, takes tens of seconds on the CPU)."""
    return jax.jit(jtask.get_task(NAME).init_params)


@pytest.fixture(scope="module")
def exported(jinit):
    """Eight peers' parameters drawn by the reference (key 0), as numpy."""
    return jax.tree.map(np.asarray, jax.vmap(jinit)(jax.random.split(jax.random.PRNGKey(0), 8)))


@pytest.fixture(scope="module")
def classifier(exported):
    """(reference task, reference params, port params, tokens (4, 196),
    labels (4,)): one model, its parameters exported from the reference."""
    jt = jtask.get_task(NAME)
    jparams = jax.tree.map(lambda a: jnp.asarray(a[3]), exported)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 16, (4, 196)).astype(np.int32)
    labels = rng.integers(0, 10, (4,)).astype(np.int32)
    return jt, jparams, tparams, tokens, labels


def test_task_registry_and_shapes(classifier):
    """The registry follows the reference's; the task's 31 leaves and their
    shapes equal the reference's tree and the port's own draw, with no draw
    needed for them; the flat row pads 100,234 to 100,236 floats."""
    _, _, tparams, _, _ = classifier
    assert ttask.task_names() == jtask.task_names()
    assert ttask.get_task(NAME) is ttask.get_task(NAME)
    with pytest.raises(ValueError, match="already registered"):
        ttask.register_task(NAME, lambda: None)
    with pytest.raises(ValueError, match="unknown model.*mnist_mlp"):
        ttask.get_task("vit_b16")
    task = ttask.get_task(NAME)
    ref = jtask.get_task(NAME)
    assert (task.eval_batch_size, task.eval_set_size) == (ref.eval_batch_size,
                                                           ref.eval_set_size)
    assert (ttask.SEQMNIST_POOL, ttask.SEQMNIST_BINS) == (jtask.SEQMNIST_POOL,
                                                          jtask.SEQMNIST_BINS)
    assert dataclasses.asdict(ttask.seqmnist_model_config()) == dataclasses.asdict(
        jtask.seqmnist_model_config())
    assert task.param_shapes == {n: tuple(t.shape) for n, t in tparams.items()}
    drawn = task.init_params(torch.Generator().manual_seed(0))
    assert list(drawn) == list(task.param_shapes)
    assert {n: tuple(t.shape) for n, t in drawn.items()} == task.param_shapes
    assert all(t.dtype == torch.float32 for t in drawn.values())
    assert torch.equal(drawn["cls_head.b"], torch.zeros(10))
    layout = tp2p.layout_of(NAME)
    assert (len(layout.shapes), layout.size, layout.row) == (31, 100_234, 100_236)


def test_classifier_logits_loss_and_gradients_match_reference(classifier):
    jt, jparams, tparams, tokens, labels = classifier
    jloss, jgrad = jax.jit(jax.value_and_grad(jt.loss_fn))(
        jparams, (jnp.asarray(tokens), jnp.asarray(labels)))
    jlogits = jax.jit(jt.apply_fn)(jparams, jnp.asarray(tokens))
    _, apply, loss = registry.build_sequence_classifier(ttask.seqmnist_model_config(), 10)
    leaves = {n: t.clone().requires_grad_(True) for n, t in tparams.items()}
    tok, lab = torch.as_tensor(tokens).long(), torch.as_tensor(labels).long()
    tloss = loss(leaves, (tok, lab))
    grads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    with torch.no_grad():
        tlogits = apply(tparams, tok)
    assert tlogits.shape == (4, 10) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = _flat(jgrad)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)


def test_build_sequence_classifier_rejects_other_families_as_reference():
    from repro.models import registry as jregistry
    from repro_torch import configs as tconfigs_lib
    from repro import configs as jconfigs_lib

    jcfg = jconfigs_lib.reduced(jconfigs_lib.get_config("smollm-135m"))
    tcfg = tconfigs_lib.reduced(tconfigs_lib.get_config("smollm-135m"))
    with pytest.raises(ValueError) as want:
        jregistry.build_sequence_classifier(jcfg, 10)
    with pytest.raises(ValueError) as got:
        registry.build_sequence_classifier(tcfg, 10)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("chunked", [False, True])
def test_features_match_reference(classifier, chunked):
    """``rwkv6_features``: the token loop, and the chunked form (chunk 49,
    four chunks of the 196 tokens; the ``wkv6`` wrapper's plain version)."""
    _, jparams, tparams, tokens, _ = classifier
    cfg_j = jtask.seqmnist_model_config()
    want = jax.jit(lambda p, t: jtf.rwkv6_features(p, cfg_j, t, chunked=chunked))(
        jparams, jnp.asarray(tokens))
    got = ttf.rwkv6_features(tparams, ttask.seqmnist_model_config(),
                             torch.as_tensor(tokens).long(), chunked=chunked)
    assert got.shape == (4, 196, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_fn_and_gradient_match_reference(classifier):
    """``rwkv6_loss_fn`` (the language-model loss through the chunked trunk)
    on the task's trunk, some labels ignored, and its gradient."""
    _, jparams, tparams, tokens, _ = classifier
    cfg_j, cfg_t = jtask.seqmnist_model_config(), ttask.seqmnist_model_config()
    labels = np.roll(tokens[:2], -1, axis=1)
    labels[:, -1] = -100
    trunk = [n for n in tparams if not n.startswith("cls_head.")]
    jtrunk = {k: v for k, v in jparams.items() if k != "cls_head"}
    batch = {"tokens": jnp.asarray(tokens[:2]), "labels": jnp.asarray(labels)}
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: jtf.rwkv6_loss_fn(p, cfg_j, batch)))(
        jtrunk)
    leaves = {n: tparams[n].clone().requires_grad_(True) for n in trunk}
    tloss = ttf.rwkv6_loss_fn(leaves, cfg_t, {"tokens": torch.as_tensor(tokens[:2]).long(),
                                              "labels": torch.as_tensor(labels).long()})
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = _flat(jgrad)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (3, 5)).astype(np.int32)
    labels[0, :2] = -100
    for lab in (labels, np.full_like(labels, -100)):
        want = jcommon.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(lab))
        got = tcommon.cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(lab).long())
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_stacked_loss_and_apply_are_each_peers_own(classifier):
    """The task's K-batched functions (``torch.func.vmap`` of the one-model
    classifier) equal the one-model functions peer by peer, and one backward
    of the summed losses gives each peer its own gradient."""
    _, _, tparams, tokens, labels = classifier
    task = ttask.get_task(NAME)
    _, apply, loss = registry.build_sequence_classifier(ttask.seqmnist_model_config(), 10)
    gen = torch.Generator().manual_seed(5)
    stacked = {n: torch.stack([t + 0.01 * k * torch.randn(t.shape, generator=gen)
                               for k in range(3)]) for n, t in tparams.items()}
    leaves = {n: t.clone().requires_grad_(True) for n, t in stacked.items()}
    tok = torch.as_tensor(np.stack([tokens, tokens[::-1], np.roll(tokens, 3)])).long()
    lab = torch.as_tensor(np.stack([labels, labels[::-1], labels])).long()
    losses = task.loss_fn(leaves, (tok, lab))
    assert losses.shape == (3,)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    with torch.no_grad():
        logits = task.apply_fn(stacked, tok[0])
    for k in range(3):
        one = {n: t[k].detach().clone().requires_grad_(True) for n, t in leaves.items()}
        lk = loss(one, (tok[k], lab[k]))
        torch.testing.assert_close(losses[k], lk, **TOL)
        for g, gk, name in zip(grads, torch.autograd.grad(lk, list(one.values())), one):
            torch.testing.assert_close(g[k], gk, **TOL, msg=name)
        with torch.no_grad():
            torch.testing.assert_close(logits[k], apply({n: t[k] for n, t in stacked.items()},
                                                        tok[0]), **TOL)


# ---------------------------------------------------------------------------
# level 3: teacher-forced seqmnist_k8 rounds, allclose
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seqmnist_setup(mnist_small, jinit, exported):
    """seqmnist_k8 at T = 2 on ``mnist_small``: shards, sizes, the jitted
    reference init (``init_state`` draws through it: the same draws as
    ``exported``) and one jitted reference local phase (it reads params,
    momentum and the biases only, so every protocol's and wire's state goes
    through one compile)."""
    jexp = jconfigs.seqmnist_k8(local_steps=2)
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, list(jexp.peer_classes),
                                             samples_per_class=50)
    sizes = partition.data_sizes(parts)
    jt = jtask.get_task(NAME)
    jlocal = jax.jit(lambda st, b: jp2p.local_phase(st, jt.loss_fn, b, jexp.p2p))
    return parts, sizes, jax.random.PRNGKey(0), jinit, exported, jlocal


def _assert_state_close(tstate, jstate, what):
    task = ttask.get_task(NAME)
    layout = tp2p.ParamLayout.of(task)
    fields = ["params", "momentum", "d_bias", "b_bias"]
    assert (tstate.compression == ()) == (jstate.compression == ())
    if jstate.compression != ():
        fields.append("compression")
    for field in fields:
        got = layout.views(getattr(tstate, field))
        want = _flat(getattr(jstate, field))
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name], **TOL,
                                       err_msg=f"{what} {field} {name}")
    assert (tstate.protocol == ()) == (jstate.protocol == ())
    if jstate.protocol != ():
        np.testing.assert_allclose(tstate.protocol.mass.numpy(),
                                   np.asarray(jstate.protocol.mass), **TOL,
                                   err_msg=f"{what} mass")
    assert tstate.round_idx == int(jstate.round_idx)


ROUND_CASES = {"gossip": (dict(), 2), "push_sum": (dict(protocol="push_sum"), 2),
               "qint8": (dict(compressor="qint8"), 1)}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_parity_teacher_forced(case, seqmnist_setup):
    """From the same exported init (max-norm synced by both), each round: the
    port's local phase from the reference's state, then its consensus phase
    (through the ``consensus_mix`` / ``dequant_mix`` wrappers' plain
    versions) from the reference's post-local state."""
    parts, sizes, key, jinit, exported, jlocal = seqmnist_setup
    rep, rounds = ROUND_CASES[case]
    jcfg = dataclasses.replace(jconfigs.seqmnist_k8(local_steps=2).p2p, **rep)
    tcfg = dataclasses.replace(tconfigs.seqmnist_k8(local_steps=2).p2p, **rep)
    task = ttask.get_task(NAME)
    jstate = jp2p.init_state(key, jinit, jcfg, data_sizes=sizes)
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    _assert_state_close(tstate, jstate, f"{case} init")
    consts_np, _ = jp2p.protocol_constants(jcfg, sizes)
    consts = jprotocols.ProtocolConstants(w=jnp.asarray(consts_np.w, jnp.float32),
                                          beta=jnp.asarray(consts_np.beta, jnp.float32))
    jconsensus = jax.jit(jp2p.consensus_phase, static_argnums=1)
    ops = tp2p.round_operands(tcfg, sizes, device="cpu")
    batcher = jpipeline.TokenSequenceBatcher(parts, 4, seed=0)
    for r in range(rounds):
        bx, by = batcher.round_batches(2)
        jl, jloss = jlocal(jstate._replace(protocol=(), compression=()),
                           (jnp.asarray(bx), jnp.asarray(by)))
        jl = jl._replace(protocol=jstate.protocol, compression=jstate.compression)
        jc = jconsensus(jl, jcfg, jprotocols.round_constants(consts, r % consts.w.shape[0]))
        tl, tloss = tp2p.local_phase(interop.state_from_jax(jax.tree.map(np.asarray, jstate),
                                                            task),
                                     task, (torch.as_tensor(bx).long(),
                                            torch.as_tensor(by).long()), tcfg)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        _assert_state_close(tl, jl, f"{case} round {r} after local")
        tc = tp2p.consensus_phase(interop.state_from_jax(jax.tree.map(np.asarray, jl), task),
                                  tcfg, ops[r % len(ops)])
        _assert_state_close(tc, jc, f"{case} round {r} after consensus")
        if case == "push_sum":
            np.testing.assert_allclose(float(tc.protocol.mass.double().sum()), 8.0,
                                       rtol=1e-6)
        jstate = jc
    assert not torch.equal(tc.params, tl.params), "consensus moved nothing"


def test_interop_round_trips_the_stacked_classifier_tree(seqmnist_setup):
    """A stacked (K = 8) reference tree, ``cls_head`` nested, -> the port's
    flat leaves -> the tree, bit for bit; through ``state_from_jax`` too."""
    _, sizes, key, jinit, exported, _ = seqmnist_setup
    flat = interop.params_from_jax(exported)
    assert flat["cls_head.w"].shape == (8, 64, 10)
    back = interop.params_to_jax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(exported)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(exported)):
        np.testing.assert_array_equal(got, want)
    jcfg = jconfigs.seqmnist_k8().p2p
    jstate = jax.tree.map(np.asarray, jp2p.init_state(key, jinit, jcfg, data_sizes=sizes))
    tstate = interop.state_from_jax(jstate, ttask.get_task(NAME))
    assert tuple(tstate.params.shape) == (8, 100_236)
    assert torch.equal(tstate.params[:, 100_234:], torch.zeros(8, 2))
    views = tp2p.param_views(tstate, ttask.get_task(NAME))
    for name, want in _flat(jstate.params).items():
        np.testing.assert_array_equal(views[name].numpy(), want)


# ---------------------------------------------------------------------------
# level 4 and the drivers: the port's own runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_data():
    # the reference test's mnist_like(2000, 300) training set (the train
    # split is drawn first), a 40-example test set to keep the CPU eval short
    return synthetic.mnist_like(2000, 40)


def _smoke_exp(mod, protocol):
    """The reference's ``_rwkv6_smoke_exp`` (tests/test_task.py)."""
    return mod.PaperExperiment(
        name=f"rwkv6_smoke_{protocol}",
        p2p=mod.P2PConfig(algorithm="p2pl", num_peers=2, local_steps=2, consensus_steps=1,
                          lr=0.05, topology="complete", mixing="data_weighted",
                          protocol=protocol, model=NAME),
        batch_size=8, samples_per_class=20, peer_classes=((0, 1), (2, 3)))


@pytest.mark.parametrize("protocol", ["gossip", "push_sum"])
def test_seqmnist_trains(protocol, smoke_data):
    """The reference's claims (``test_rwkv6_seqmnist_trains_vmap``): finite
    losses that fall over 3 rounds, finite accuracies; push-sum's mass sums
    to K after every round."""
    sums = []
    log = ttrain.run_paper_experiment(
        _smoke_exp(tconfigs, protocol), rounds=3, data=smoke_data, device="cpu",
        on_round=lambda r, st: sums.append(float(st.protocol.mass.double().sum()))
        if protocol == "push_sum" else None)
    losses = np.asarray(log.train_loss, np.float64)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"rwkv6 loss did not decrease under {protocol}: {losses}"
    assert np.isfinite(log.after_consensus["all"][-1]).all()
    if protocol == "push_sum":
        np.testing.assert_allclose(sums, [2.0] * 3, rtol=1e-6)


@pytest.mark.parametrize("protocol", ["gossip", "push_sum"])
def test_both_drivers_bit_for_bit(protocol, smoke_data):
    """The scan driver (on the CPU, the round body run eagerly) and the
    python one: the same state leaves, losses and accuracies, bit for bit."""
    runs = {}
    for driver in ("python", "scan"):
        runs[driver] = ttrain.run_paper_experiment(
            _smoke_exp(tconfigs, protocol), rounds=2, eval_every=2, data=smoke_data,
            device="cpu", driver=driver, return_state=True)
    (plog, pstate), (slog, sstate) = runs["python"], runs["scan"]
    for a, b in zip(tp2p.state_leaves(pstate), tp2p.state_leaves(sstate), strict=True):
        assert torch.equal(a, b)
    assert pstate.round_idx == sstate.round_idx == 2
    assert plog.train_loss == slog.train_loss
    for group in plog.after_local:
        for phase in ("local", "consensus"):
            np.testing.assert_array_equal(plog.series(group, phase), slog.series(group, phase))


COMPOSED = {
    "adaptive_eps_greedy": dict(schedule="adaptive", partner_rule="eps_greedy",
                                adaptive_eps=0.5),
    "link_dropout_topk": dict(schedule="link_dropout", compressor="topk", topk_frac=0.05),
    "straggler_bound2_push_sum": dict(protocol="push_sum", steps_profile="straggler",
                                      staleness_bound=2),
}


@pytest.mark.parametrize("case", sorted(COMPOSED))
def test_seqmnist_composes_with_the_other_features(case, smoke_data):
    """The task runs under the features the 2NN's tests hold to the
    reference (adaptive selection, a time-varying schedule over a top-k
    wire, async rounds under push-sum): 2 rounds of the default driver,
    finite losses, accuracies and parameters, peers apart after the local
    phase, push-sum's mass at K."""
    exp = _smoke_exp(tconfigs, "gossip")
    exp = dataclasses.replace(exp, p2p=dataclasses.replace(exp.p2p, **COMPOSED[case]))
    log, state = ttrain.run_paper_experiment(exp, rounds=2, eval_every=2, data=smoke_data,
                                             device="cpu", return_state=True)
    assert state.round_idx == 2 and np.isfinite(log.train_loss).all()
    assert bool(torch.isfinite(state.params).all())
    assert np.isfinite(log.series("all")).all() and log.drift[-1] > 0.0
    if exp.p2p.protocol == "push_sum":
        np.testing.assert_allclose(float(state.protocol.mass.double().sum()), 2.0, rtol=1e-6)


def test_chunked_subsampled_eval_equals_reference(monkeypatch, jinit):
    """The eval dict on the same parameters: the reference's
    ``run_paper_experiment`` evaluates its state, the port's
    ``make_eval_fn`` that state exported.  The reference's round is
    replaced by one that returns the state it is given, so both evaluate
    the seed's init (``seqmnist_k8`` with ``local_dsgd``: no max-norm sync,
    every peer its own); both tasks' eval sizes are cut (40 of the 300 test
    examples, chunks of 16, the last one ragged) so the subsample and the
    chunking both act."""
    data = synthetic.mnist_like(2000, 300)
    for lib in (jtask, ttask):
        monkeypatch.setitem(lib._CACHE, NAME, dataclasses.replace(
            lib.get_task(NAME), eval_set_size=40, eval_batch_size=16))
    monkeypatch.setitem(jtask._CACHE, NAME, dataclasses.replace(jtask.get_task(NAME),
                                                                init_params=jinit))

    def unchanged(*args, **kwargs):
        return lambda state, batches: (state, state, jnp.zeros(batches[0].shape[:2]))

    monkeypatch.setattr(jp2p, "make_scan_driver", unchanged)
    exps = [dataclasses.replace(e, p2p=dataclasses.replace(e.p2p, algorithm="local_dsgd"))
            for e in (jconfigs.seqmnist_k8(), tconfigs.seqmnist_k8())]
    jlog, jstate = jtrain.run_paper_experiment(exps[0], rounds=1, data=data, seed=3,
                                               return_state=True)
    task = ttask.get_task(NAME)
    eval_fn = ttrain.make_eval_fn(exps[1], task, data[2], data[3], seed=3, device=CPU)
    got = eval_fn(interop.state_from_jax(jax.tree.map(np.asarray, jstate), task))
    assert set(got) == set(jlog.after_consensus) == {f"peer{k}_seen" for k in range(8)} | {
        "all"}
    for name, want in jlog.after_consensus.items():
        np.testing.assert_array_equal(got[name], want[-1], err_msg=name)
    assert len(set(got["all"].tolist())) > 1  # the peers' predictions differ


# ---------------------------------------------------------------------------
# configs, CLI, feature table
# ---------------------------------------------------------------------------


def test_seqmnist_k8_equals_reference():
    assert (inspect.signature(tconfigs.seqmnist_k8).parameters.keys()
            == inspect.signature(jconfigs.seqmnist_k8).parameters.keys())
    for kw in ({}, dict(schedule="round_robin", protocol="push_sum", local_steps=2)):
        t, j = tconfigs.seqmnist_k8(**kw), jconfigs.seqmnist_k8(**kw)
        assert dataclasses.asdict(t.p2p) == dataclasses.asdict(j.p2p)
        assert (t.name, t.batch_size, t.samples_per_class, t.rounds, t.peer_classes,
                t.model) == (j.name, j.batch_size, j.samples_per_class, j.rounds,
                             j.peer_classes, j.model)
    assert tconfigs.seqmnist_k8().p2p.model == "rwkv6_seqmnist"


def test_experiment_model_propagates_and_conflicts_as_reference():
    for mod in (tconfigs, jconfigs):
        p2p_mod = tp2p if mod is tconfigs else jp2p
        exp = mod.PaperExperiment(name="x", p2p=p2p_mod.P2PConfig(num_peers=2), model=NAME)
        assert exp.p2p.model == NAME
        exp = mod.PaperExperiment(name="x", p2p=p2p_mod.P2PConfig(num_peers=2, model=NAME))
        assert exp.model == NAME
    with pytest.raises(ValueError) as want:
        jconfigs.PaperExperiment(name="x", p2p=jp2p.P2PConfig(model=NAME), model="other")
    with pytest.raises(ValueError) as got:
        tconfigs.PaperExperiment(name="x", p2p=tp2p.P2PConfig(model=NAME), model="other")
    assert str(got.value) == str(want.value)


def test_p2p_config_takes_every_registered_task():
    for name in ttask.task_names():
        assert tp2p.P2PConfig(model=name).model == name
    with pytest.raises(ValueError) as want:
        jp2p.P2PConfig(model="resnet")
    with pytest.raises(ValueError) as got:
        tp2p.P2PConfig(model="resnet")
    assert str(got.value) == str(want.value)


def test_real_model_hierarchical_refused_word_for_word(smoke_data):
    ctx = dict(model=NAME, peers_per_device=2)
    tinc = [i for i in tfeatures.INCOMPATIBILITIES if i.a == "real_model"]
    jinc = [i for i in jfeatures.INCOMPATIBILITIES if i.a == "real_model"]
    assert [(i.b, i.reason, i.workaround) for i in tinc] == [
        (i.b, i.reason, i.workaround) for i in jinc]
    assert tfeatures.format_violation(tinc[0], tfeatures.FeatureContext(**ctx)) == \
        jfeatures.format_violation(jinc[0], jfeatures.FeatureContext(**ctx))
    tcfg, jcfg = tp2p.P2PConfig(num_peers=2, model=NAME), jp2p.P2PConfig(num_peers=2,
                                                                         model=NAME)
    with pytest.raises(ValueError) as want:
        jfeatures.check_config(jcfg, peers_per_device=2)
    assert "model='rwkv6_seqmnist'" in str(want.value)
    with pytest.raises(ValueError) as got:
        tfeatures.check_config(tcfg, peers_per_device=2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        ttrain.run_paper_experiment(_smoke_exp(tconfigs, "gossip"), rounds=1, data=smoke_data,
                                    device="cpu", peer_axis="pod", peers_per_device=2)
    assert str(got.value) == str(want.value)
    tfeatures.check_config(tcfg)  # one peer per device composes


def _cli_exp(monkeypatch, argv):
    """The experiment ``main(argv)`` would run (the run itself replaced)."""
    seen = {}

    def fake_run(exp, **kw):
        seen["exp"], seen["kw"] = exp, kw
        return ttrain.metrics_lib.RoundLog()

    monkeypatch.setattr(ttrain, "run_paper_experiment", fake_run)
    ttrain.main(argv)
    return seen["exp"], seen["kw"]


def test_cli_model_and_seqmnist_experiment(monkeypatch, capsys):
    exp, kw = _cli_exp(monkeypatch, ["--device", "cpu", "--experiment", "seqmnist_k8",
                                     "--rounds", "2", "--driver", "python"])
    want = jconfigs.seqmnist_k8()
    assert dataclasses.asdict(exp.p2p) == dataclasses.asdict(want.p2p)
    assert (exp.name, exp.model) == (want.name, want.model)
    assert (kw["rounds"], kw["driver"], kw["device"]) == (2, "python", "cpu")
    exp, _ = _cli_exp(monkeypatch, ["--experiment", "seqmnist_k8", "--schedule", "round_robin",
                                    "--protocol", "push_sum", "--local-steps", "2"])
    want = jconfigs.seqmnist_k8(schedule="round_robin", protocol="push_sum", local_steps=2)
    assert dataclasses.asdict(exp.p2p) == dataclasses.asdict(want.p2p)
    exp, _ = _cli_exp(monkeypatch, ["--experiment", "noniid_affinity", "--model", NAME])
    assert exp.model == exp.p2p.model == NAME
    exp, _ = _cli_exp(monkeypatch, ["--experiment", "seqmnist_k8", "--model", "mnist_mlp"])
    assert exp.model == exp.p2p.model == "mnist_mlp"
    argv = ["--experiment", "seqmnist_k8", "--peer-axis", "pod", "--peers-per-device", "8"]
    for main in (jtrain.main, ttrain.main):
        with pytest.raises(SystemExit):
            main(argv)
    ref_msg, port_msg = [line.split("error: ", 1)[1]
                         for line in capsys.readouterr().err.splitlines() if "error: " in line]
    assert "model='rwkv6_seqmnist'" in ref_msg and port_msg == ref_msg
    with pytest.raises(SystemExit):
        ttrain.main(["--model", "resnet"])
    assert "invalid choice" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# every kernel on the card has its backward: no silent gradient cut
# ---------------------------------------------------------------------------


def test_flash_attention_cuda_path_goes_through_its_function():
    """``flash_attention`` has its backward kernel: the wrapper no longer
    guards; it calls ``FlashAttention.apply``, whose forward launches the
    kernel on a CUDA tensor, with the row log-sum-exp where autograd will
    flow, and whose backward launches the backward kernel
    (``attention_bwd``: the plain backward on CPU tensors only), so the
    graph is never cut."""
    src = inspect.getsource(flash_ops.gqa_flash_attention)
    assert "check_no_grad" not in src
    assert src.index("torch.is_grad_enabled()") < src.index("FlashAttention.apply(")
    fwd = inspect.getsource(flash_ops._forward)
    assert fwd.index('device.type == "cpu"') < fwd.index("launch(") and "lse=lse" in fwd
    bwd = inspect.getsource(flash_ops.FlashAttention.backward)
    assert "attention_bwd(" in bwd
    dispatch = inspect.getsource(flash_ops.attention_bwd)
    assert dispatch.index('device.type == "cpu"') < dispatch.index("launch_bwd(")
    q = torch.zeros(1, 4, 2, 32, requires_grad=True)
    out = flash_ops.gqa_flash_attention(q, q.detach(), q.detach())
    assert type(out.grad_fn).__name__.startswith("FlashAttention")


def test_cpu_wkv6_stays_differentiable():
    rng = np.random.default_rng(2)
    shape = (1, 8, 2, 16)
    r, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    logd = torch.as_tensor(-np.exp(rng.normal(size=shape)).astype(np.float32))
    u = torch.as_tensor(rng.normal(size=(2, 16)).astype(np.float32))
    out, _ = wkv6_ops.wkv6(r, k, v, logd, u, chunk=4)
    grads = torch.autograd.grad(out.sum(), [r, k, v])
    assert all(bool(g.abs().sum() > 0) for g in grads)

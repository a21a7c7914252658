"""Port parity, P2P training of the language models: the port's
``decoder_loss_fn``, ``rwkv6_loss_fn``, ``hybrid_loss_fn``,
``core.task.from_model``, the bf16 flat layout and ``launch.train.run_p2p_lm``
against the reference's, on the CPU.

- ``decoder_param_shapes`` equals the leaves ``decoder_init`` draws and the
  reference's tree, at every decoder family's reduced config, and
  ``rwkv6_param_shapes`` / ``hybrid_param_shapes`` at rwkv6-7b's and
  zamba2-2.7b's;
- ``decoder_loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's, from exported parameters, on reduced smollm-135m,
  qwen3-moe-235b-a22b (the MoE aux loss) and internvl2-2b (image patches),
  and ``rwkv6_loss_fn`` and ``hybrid_loss_fn`` on reduced rwkv6-7b and
  zamba2-2.7b (the WKV's and the SSD's backward through the plain
  backwards of their kernels), float32 (atol 5e-5 / rtol 1e-4 on the loss,
  1e-5 / 1e-3 on gradients: sums over many tokens in another order);
- ``run_p2p_lm`` against the reference's from the reference's exported
  initial state, at smollm-135m, rwkv6-7b and zamba2-2.7b: the token batches
  equal, the losses and the final drift allclose;
- one round of reduced smollm-135m in bfloat16 (the flat buffer bf16, its
  row a multiple of 8) against the reference's round, at the bf16
  tolerance of tests/test_kernels.py (5e-2);
- a bf16 model's float32 leaves (rwkv6's decay base and bonus, Mamba2's dt
  bias, A_log and D, a MoE router) in a float32 block of their own
  (``ParamLayout.wide``): float32 through ``init_state``, a local phase and a
  round, each move lr times its float32 gradient with no entry lost; one
  bf16 round of reduced rwkv6-7b, zamba2-2.7b and qwen3-moe-235b-a22b
  against the reference's ``make_round_fn`` round from its exported initial
  leaves, every leaf in the reference's type; a task of one type keeps one
  buffer; the modes a mixed task cannot run yet raise;
- the reference's claim (the loss falls by more than 0.3 over 25 rounds) on
  the port; the CLI; ``resolve_loss_fn`` / ``resolve_init_fn``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as task_lib  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
DECODERS = ["smollm-135m", "minitron-8b", "phi4-mini-3.8b", "qwen1.5-32b", "deepseek-v2-236b",
            "qwen3-moe-235b-a22b", "internvl2-2b"]
SSM_ARCHS = ["rwkv6-7b", "zamba2-2.7b"]  # the rwkv6 and hybrid families
SSM_SHAPES = {"rwkv6": tf.rwkv6_param_shapes, "hybrid": tf.hybrid_param_shapes}
SSM_INITS = {"rwkv6": tf.rwkv6_init_model, "hybrid": tf.hybrid_init}


def _flat_names(tree, prefix=""):
    out = {}
    for key, child in tree.items():
        if isinstance(child, dict):
            out.update(_flat_names(child, f"{prefix}{key}."))
        else:
            out[prefix + key] = tuple(child.shape)
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_param_shapes_match_init_and_reference(arch):
    cfg = reduced(get_config(arch))
    shapes = tf.decoder_param_shapes(cfg)
    drawn = tf.decoder_init(torch.Generator().manual_seed(0), cfg)
    assert list(shapes) == list(drawn)
    assert shapes == {name: tuple(t.shape) for name, t in drawn.items()}
    jshapes = jax.eval_shape(jbuild_model(jreduced(jget_config(arch))).init,
                             jax.random.PRNGKey(0))
    assert shapes == _flat_names(jshapes)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_param_shapes_match_init_and_reference(arch):
    cfg = reduced(get_config(arch))
    shapes = SSM_SHAPES[cfg.family](cfg)
    drawn = SSM_INITS[cfg.family](torch.Generator().manual_seed(0), cfg)
    assert list(shapes) == list(drawn)
    assert shapes == {name: tuple(t.shape) for name, t in drawn.items()}
    jshapes = jax.eval_shape(jbuild_model(jreduced(jget_config(arch))).init,
                             jax.random.PRNGKey(0))
    assert shapes == _flat_names(jshapes)
    # the full config's leaves, nothing drawn, against the reference's tree
    full = get_config(arch)
    assert SSM_SHAPES[full.family](full) == _flat_names(jax.eval_shape(
        jbuild_model(jget_config(arch)).init, jax.random.PRNGKey(0)))


def _decoder_case(arch, seed=0):
    jcfg = jreduced(jget_config(arch))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, jcfg.num_prefix_embeddings,
                                            jcfg.frontend_dim)).astype(np.float32)
    return jmodel, jparams, batch


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b", "internvl2-2b"])
def test_decoder_loss_and_grads_match_reference(arch):
    jmodel, jparams, batch = _decoder_case(arch)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = reduced(get_config(arch))
    params = {k: v.requires_grad_(True) for k, v in
              interop.params_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    tbatch = {k: torch.as_tensor(v, dtype=torch.int64 if k != "patches" else torch.float32)
              for k, v in batch.items()}
    loss = tf.decoder_loss_fn(params, cfg, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    want = interop.params_from_jax(jax.tree.map(np.asarray, jgrads))
    for (name, g) in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)
    if cfg.moe is not None:  # the aux loss is in: without it the loss differs
        no_aux = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_aux_coef=0.0))
        assert float(tf.decoder_loss_fn(params, no_aux, tbatch).detach()) < float(loss.detach())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_loss_and_grads_match_reference(arch):
    """``rwkv6_loss_fn`` (chunked, chunk 4 over 16 tokens) and
    ``hybrid_loss_fn`` (4 Mamba2 layers, the shared block twice) and their
    gradients against ``jax.value_and_grad`` of the reference's: every leaf,
    the WKV's and the SSD's through the plain backwards of the kernels."""
    jmodel, jparams, batch = _decoder_case(arch)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = reduced(get_config(arch))
    params = {k: v.requires_grad_(True) for k, v in
              interop.params_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    tbatch = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()}
    loss = build_model(cfg).loss_fn(params, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    want = interop.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(params)
    for (name, g) in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)


def test_model_loss_fn_reaches_decoder_loss():
    """The registry's dense, MoE and vlm ``Model.loss_fn`` is
    ``decoder_loss_fn``, rwkv6's ``rwkv6_loss_fn``, the hybrid's
    ``hybrid_loss_fn`` and the encoder-decoder's ``encdec_loss_fn``, which
    ``from_model`` trains on its batch tree (held to the reference in
    tests/test_torch_vlm_encdec.py)."""
    for arch in ("smollm-135m", "qwen3-moe-235b-a22b", "internvl2-2b"):
        _, jparams, batch = _decoder_case(arch, seed=1)
        cfg = reduced(get_config(arch))
        params = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
        tbatch = {k: torch.as_tensor(v, dtype=torch.int64 if k != "patches" else torch.float32)
                  for k, v in batch.items()}
        assert torch.equal(build_model(cfg).loss_fn(params, tbatch),
                           tf.decoder_loss_fn(params, cfg, tbatch))
    for arch, loss_fn in (("rwkv6-7b", tf.rwkv6_loss_fn), ("zamba2-2.7b", tf.hybrid_loss_fn)):
        _, jparams, batch = _decoder_case(arch, seed=1)
        cfg = reduced(get_config(arch))
        params = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
        tbatch = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()}
        assert torch.equal(build_model(cfg).loss_fn(params, tbatch), loss_fn(params, cfg, tbatch))
    model = build_model(reduced(get_config("seamless-m4t-medium")))
    gen = torch.Generator().manual_seed(1)
    params, batch = model.init(gen), model.make_batch(gen, 2, 16)
    assert torch.equal(model.loss_fn(params, batch), tf.encdec_loss_fn(params, model.cfg, batch))
    task = task_lib.from_model(model)
    assert task.param_shapes == tf.encdec_param_shapes(model.cfg)
    assert task.param_shapes == {name: tuple(v.shape) for name, v in params.items()}
    stacked = {name: torch.stack([v, v]) for name, v in params.items()}
    losses = task.loss_fn(stacked, {name: torch.stack([v, v]) for name, v in batch.items()})
    assert losses.shape == (2,) and torch.equal(losses[0], losses[1])
    torch.testing.assert_close(losses[0], model.loss_fn(params, batch))


def test_from_model_task_and_bf16_layout():
    """``from_model``: the model's leaves and type; a bf16 row padded to 8
    elements (16 bytes), a float32 one to 4; a bf16 MoE's float32 router in
    a float32 block of its own."""
    cfg = reduced(get_config("smollm-135m"))
    task = task_lib.from_model(build_model(cfg))
    assert task.param_shapes == tf.decoder_param_shapes(cfg) and task.dtype == torch.float32
    assert task.init_on_device
    size = sum(int(np.prod(s)) for s in task.param_shapes.values())
    layout = tp2p.ParamLayout.of(task)
    assert (layout.size, layout.row, layout.dtype) == (size, -(-size // 4) * 4, torch.float32)
    task16 = task_lib.from_model(build_model(cfg.replace(dtype="bfloat16")))
    layout16 = tp2p.ParamLayout.of(task16)
    assert layout16.dtype == torch.bfloat16 and layout16.row % 8 == 0
    assert layout16.row == -(-size // 8) * 8 and tp2p.row_align(torch.bfloat16) == 8
    state = tp2p.init_state(task16, ttrain.lm_config(
        num_peers=2, local_steps=1, algorithm="p2pl_affinity", lr=1e-2, momentum=0.5,
        eta_d=0.25), seed=0, device="cpu")
    for buf in (state.params, state.momentum, state.d_bias, state.b_bias):
        assert buf.dtype == torch.bfloat16 and buf.shape == (2, layout16.row)
    assert torch.equal(state.params[0], state.params[1])  # max-norm sync
    full = get_config("smollm-135m")
    full_shapes = tf.decoder_param_shapes(full)
    assert sum(int(np.prod(s)) for s in full_shapes.values()) == 134_515_008
    moe = task_lib.from_model(build_model(reduced(get_config("qwen3-moe-235b-a22b")).replace(
        dtype="bfloat16")))
    moe_layout = tp2p.ParamLayout.of(moe)
    assert list(moe_layout.wide.shapes) == ["layers.moe.router"]
    assert moe_layout.wide.dtype == torch.float32 and moe_layout.dtype == torch.bfloat16
    assert moe_layout.names == tuple(moe.param_shapes)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_from_model_takes_rwkv6_and_hybrid(arch):
    """``from_model`` of rwkv6 and the hybrid: the family's leaves, float32
    at the reduced config; in bf16 the flat buffer is bf16 and the layers'
    float32 leaves (rwkv6's decay base and bonus, Mamba2's dt bias, A_log
    and D) sit in a float32 block beside it, their types the init's, and
    the stacked loss runs on the views of both."""
    cfg = reduced(get_config(arch))
    task = task_lib.from_model(build_model(cfg))
    assert task.param_shapes == SSM_SHAPES[cfg.family](cfg) and task.dtype == torch.float32
    assert task.init_on_device and task.name == cfg.name
    cfg16 = cfg.replace(dtype="bfloat16")
    model16 = build_model(cfg16)
    task16 = task_lib.from_model(model16)
    layout16 = tp2p.ParamLayout.of(task16)
    assert layout16.dtype == torch.bfloat16 and layout16.row % 8 == 0
    mixed = {n for n, t in model16.init(torch.Generator().manual_seed(0)).items()
             if t.dtype == torch.float32}
    want_mixed = ({"layers.time_mix.decay_base", "layers.time_mix.bonus_u"}
                  if cfg.family == "rwkv6" else
                  {"layers.mamba.dt_bias", "layers.mamba.A_log", "layers.mamba.D"})
    assert mixed == want_mixed
    assert {n for n, t in task16.param_dtypes.items() if t == torch.float32} == want_mixed
    assert set(layout16.wide.shapes) == want_mixed and layout16.wide.row % 4 == 0
    state = tp2p.init_state(task16, ttrain.lm_config(
        num_peers=2, local_steps=1, algorithm="p2pl_affinity", lr=1e-2, momentum=0.5,
        eta_d=0.25), seed=0, device="cpu")
    assert state.params.dtype == torch.bfloat16 and state.params.shape == (2, layout16.row)
    assert state.wide.params.dtype == torch.float32
    assert state.wide.params.shape == (2, layout16.wide.row)
    views = tp2p.param_views(state, task16)
    assert {n for n, v in views.items() if v.dtype == torch.float32} == want_mixed
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 2, 8)))
    losses = task16.loss_fn(views, (toks, toks))
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())


MIXED_CASES = [("rwkv6-7b", "layers.time_mix.decay_base"), ("zamba2-2.7b", "layers.mamba.D"),
               ("qwen3-moe-235b-a22b", "layers.moe.router")]


def _bf16_task(arch):
    cfg = reduced(get_config(arch)).replace(dtype="bfloat16")
    return cfg, task_lib.from_model(build_model(cfg))


@pytest.mark.parametrize("arch,leaf", MIXED_CASES)
def test_bf16_model_keeps_float32_leaves_float32(arch, leaf):
    """The reference keeps a bf16 model's float32 leaves float32 (rwkv6's
    decay base at -4, where a bf16 step is 2**-5; Mamba2's D at 1, 2**-7;
    the MoE router), and so does the port: the leaf is float32 through
    ``init_state``, one local phase and one round, and the local step moves
    it by lr times its float32 gradient (momentum and d start at 0), every
    entry whose move is above float32 rounding moved."""
    cfg, task = _bf16_task(arch)
    layout = tp2p.ParamLayout.of(task)
    pcfg = ttrain.lm_config(num_peers=2, local_steps=1, algorithm="p2pl_affinity", lr=1e-2,
                            momentum=0.5, eta_d=0.25)
    state = tp2p.init_state(task, pcfg, seed=0, device="cpu")
    tokens, labels = ttrain.lm_token_batches(np.random.default_rng(0), cfg.vocab_size,
                                             num_peers=2, local_steps=1, batch=2, seq=16)
    batches = tuple(torch.as_tensor(a, dtype=torch.int64) for a in (tokens, labels))
    before = tp2p.param_views(state, task)[leaf].clone()
    assert before.dtype == torch.float32 and leaf in layout.wide.shapes
    wide = {name: v.detach() for name, v in tp2p.param_views(state, task).items()}
    wide[leaf] = before.clone().requires_grad_(True)
    loss = task.loss_fn(wide, (batches[0][0], batches[1][0]))
    (grad,) = torch.autograd.grad(loss.sum(), [wide[leaf]])
    moved = pcfg.lr * grad
    after, _ = tp2p.local_phase_stats(state, task, batches, pcfg)
    got = tp2p.param_views(after, task)[leaf]
    assert got.dtype == torch.float32
    eps = float(np.finfo(np.float32).eps)
    torch.testing.assert_close(before - got, moved, rtol=1e-4,
                               atol=2 * eps * float(before.abs().max()))
    lost = (got == before) & (moved.abs() > eps * before.abs())
    assert not bool(lost.any())
    _, after_round, _ = tp2p.make_round_fn(task, pcfg, device="cpu")(state, batches)
    assert tp2p.param_views(after_round, task)[leaf].dtype == torch.float32
    for buf in (after_round.wide.momentum, after_round.wide.d_bias, after_round.wide.b_bias):
        assert buf.dtype == torch.float32


# The float32 leaves' moves in a bf16 round against the reference's: the
# relative norm of (port - start) - (reference - start), start the initial
# leaf (params) or 0 (d), after the local phase and after consensus.  Read on
# the CPU at these inputs: at most 0.033 for rwkv6's and Mamba2's leaves and
# 0.091 for the MoE router, whose top-k choices follow bf16 activations that
# the two frameworks round apart.  A block left unchanged reads 1, one left
# unmixed 0.89 to 1.09, so each bound sits between the two.
FLOAT32_MOVE_REL = {"rwkv6-7b": 5e-2, "zamba2-2.7b": 5e-2, "qwen3-moe-235b-a22b": 0.2}


def _check_move(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor, rel: float,
                what: str) -> None:
    """``got`` moved from ``start`` as ``want`` did, within ``rel`` of the
    move's norm (float64); a move of nothing must be nothing."""
    moved, want_moved = got.double() - start.double(), want.double() - start.double()
    if not bool(want_moved.any()):
        assert not bool(moved.any()), what
        return
    err = float(torch.linalg.vector_norm(moved - want_moved)
                / torch.linalg.vector_norm(want_moved))
    assert err <= rel, f"{what}: moved {err:.3g} of its norm off the reference's"


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b", "qwen3-moe-235b-a22b"])
def test_bf16_mixed_round_matches_reference(arch):
    """One bf16 round of the reduced model from the reference's exported
    initial leaves (``interop.params_from_jax``) against the reference's
    ``p2p.make_round_fn`` round on the same token batches: after the local
    phase and after consensus, every leaf of params and d in the reference's
    type, each float32 leaf's move within ``FLOAT32_MOVE_REL`` of the
    reference's, the bf16 leaves within 5e-2; the losses within 5e-2."""
    k, t, b, s = 2, 2, 2, 16
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="bfloat16")
    jmodel = jbuild_model(jcfg)
    pcfg = jp2p.P2PConfig(algorithm="p2pl_affinity", num_peers=k, local_steps=t,
                          consensus_steps=1, lr=5e-2, momentum=0.5, eta_d=0.25,
                          topology="complete")
    jstate = jp2p.init_state(jax.random.PRNGKey(3), jmodel.init, pcfg)
    tokens, labels = ttrain.lm_token_batches(np.random.default_rng(3), jcfg.vocab_size,
                                             num_peers=k, local_steps=t, batch=b, seq=s)
    j_local, j_after, j_losses = jp2p.make_round_fn(jmodel.loss_fn, pcfg)(
        jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})

    _, task = _bf16_task(arch)
    tcfg = ttrain.lm_config(num_peers=k, local_steps=t, algorithm="p2pl_affinity", lr=5e-2,
                            momentum=0.5, eta_d=0.25)
    init = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert any(v.dtype == torch.float32 for v in init.values())
    state = tp2p.init_state(task, tcfg, device="cpu", init_params=init)
    t_local, t_after, t_losses = tp2p.make_round_fn(task, tcfg, device="cpu")(
        state, tuple(torch.as_tensor(a, dtype=torch.int64) for a in (tokens, labels)))
    np.testing.assert_allclose(t_losses.float().numpy(), np.asarray(j_losses, np.float32),
                               **BF16_TOL)
    layout = tp2p.ParamLayout.of(task)
    for phase, jst, tst in (("local", j_local, t_local), ("consensus", j_after, t_after)):
        for field in ("params", "d_bias"):
            want = interop.params_from_jax(jax.tree.map(np.asarray, getattr(jst, field)))
            got = layout.views(getattr(tst, field), getattr(tst.wide, field))
            assert set(got) == set(want)
            for name, g in got.items():
                what = f"{phase} {field} {name}"
                assert g.dtype == want[name].dtype, what
                if g.dtype == torch.float32:
                    start = init[name] if field == "params" else torch.zeros_like(g)
                    _check_move(g, want[name], start, FLOAT32_MOVE_REL[arch], what)
                else:
                    np.testing.assert_allclose(g.float().numpy(), want[name].float().numpy(),
                                               err_msg=what, **BF16_TOL)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b", "qwen3-moe-235b-a22b"])
def test_bf16_mixed_consensus_mixes_float32_block_in_float32(arch):
    """The float32 block after a bf16 round's consensus step is the gossip
    step (Eq. 4, and d from the incoming neighbors) of the port's own
    post-local float32 block, computed in float64, within two float32
    roundings of the block's largest entry (4.3e-8 to 9.5e-7 here; the
    readings on the CPU were at most a quarter of it).  A block left unmixed
    misses by the peers' difference, 1.1e-3 to 6.1e-3; one rounded to bf16
    by 4.9e-4 to 3.2e-3, its d by 2.9e-6 to 1.2e-5."""
    cfg, task = _bf16_task(arch)
    t = 2
    pcfg = ttrain.lm_config(num_peers=2, local_steps=t, algorithm="p2pl_affinity", lr=5e-2,
                            momentum=0.5, eta_d=0.25)
    state = tp2p.init_state(task, pcfg, seed=3, device="cpu")
    tokens, labels = ttrain.lm_token_batches(np.random.default_rng(3), cfg.vocab_size, num_peers=2,
                                             local_steps=t, batch=2, seq=16)
    local, after, _ = tp2p.make_round_fn(task, pcfg, device="cpu")(
        state, tuple(torch.as_tensor(a, dtype=torch.int64) for a in (tokens, labels)))
    ops = tp2p.round_operands(pcfg, device="cpu")[0]
    x = local.wide.params.double()
    mixed = ops.self_w.double()[:, None] * x
    nbr_sum = torch.zeros_like(x)
    for slot in range(ops.nbr_idx.shape[1]):
        nbr = x[ops.nbr_idx[:, slot].long()]
        mixed = mixed + ops.nbr_w.double()[:, slot, None] * nbr
        nbr_sum = nbr_sum + ops.beta.double()[:, slot, None] * nbr
    if pcfg.use_affinity_b:
        mixed = mixed + pcfg.eta_b * local.wide.b_bias.double()
    d = (nbr_sum - x) / t
    assert bool((x[0] != x[1]).any()) and bool(d.any())
    atol = 2 * float(np.finfo(np.float32).eps) * float(x.abs().max())
    for name, got, want in (("params", after.wide.params, mixed), ("d", after.wide.d_bias, d)):
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got.double(), want, rtol=0, atol=atol, msg=name)


def test_init_state_refuses_a_drawn_leaf_of_another_type():
    """The layout's types are the init's: a task whose ``param_dtypes``
    leave out float32 leaves that its init draws (a one-type bf16 layout for
    a bf16 rwkv6) is refused by ``init_state``, not cast into the bf16
    block."""
    _, task = _bf16_task("rwkv6-7b")
    wrong = dataclasses.replace(task, param_dtypes=None)
    assert tp2p.ParamLayout.of(wrong).wide is None
    pcfg = ttrain.lm_config(num_peers=2, local_steps=1, algorithm="p2pl_affinity", lr=1e-2,
                            momentum=0.5, eta_d=0.25)
    with pytest.raises(TypeError, match="decay_base.*float32.*bfloat16"):
        tp2p.init_state(wrong, pcfg, seed=0, device="cpu")


@pytest.mark.parametrize("arch,dtype", [("smollm-135m", "bfloat16"), ("rwkv6-7b", "float32"),
                                        ("zamba2-2.7b", "float32")])
def test_one_type_task_keeps_one_buffer(arch, dtype):
    """A task whose leaves share its type (smollm-135m in bf16, rwkv6 and the
    hybrid in float32) keeps a single (K, row) buffer: no float32 block, a
    state of the four buffers and nothing beside them, the views and flatten
    of one buffer."""
    cfg = reduced(get_config(arch)).replace(dtype=dtype)
    task = task_lib.from_model(build_model(cfg))
    assert task.param_dtypes is None
    layout = tp2p.ParamLayout.of(task)
    assert layout.wide is None and layout.names == ()
    size = sum(int(np.prod(sh)) for sh in task.param_shapes.values())
    align = tp2p.row_align(getattr(torch, dtype))
    assert (layout.size, layout.row, layout.dtype) == (size, -(-size // align) * align,
                                                       getattr(torch, dtype))
    state = tp2p.init_state(task, ttrain.lm_config(
        num_peers=2, local_steps=1, algorithm="p2pl_affinity", lr=1e-2, momentum=0.5,
        eta_d=0.25), seed=0, device="cpu")
    assert state.wide == () and tp2p.param_blocks(state) == [state.params]
    assert len(tp2p.state_leaves(state)) == 4
    for buf in tp2p.state_leaves(state):
        assert buf.dtype == layout.dtype and buf.shape == (2, layout.row)
    views = layout.views(state.params)
    assert torch.equal(layout.flatten(views), state.params)
    assert [b.data_ptr() for b in layout.flatten_blocks(views)] != [state.params.data_ptr()]


@pytest.mark.parametrize("field,value", [("protocol", "push_sum"), ("compressor", "qint8"),
                                         ("compressor", "topk"), ("staleness_bound", 2),
                                         ("schedule", "adaptive")])
def test_mixed_task_runs_every_mode(field, value):
    """A task of mixed leaf types runs push-sum's mass mode, a compressed
    wire, bounded staleness and adaptive selection, and the scan driver:
    the float32 block carries the mode's buffers (its estimates, its
    published snapshots) beside the bf16 block's, the protocol state and
    the snapshot ages are shared, each float32 leaf stays float32, and the
    scan driver's state carries every leaf of both blocks (``state_leaves``
    round-trips through ``with_leaves``).  Each mode is held to the
    reference in tests/test_torch_lm_modes.py."""
    cfg, task = _bf16_task("rwkv6-7b")
    pcfg = dataclasses.replace(ttrain.lm_config(
        num_peers=2, local_steps=1, algorithm="p2pl_affinity", lr=1e-2, momentum=0.5,
        eta_d=0.25), **{field: value})
    state = tp2p.init_state(task, pcfg, seed=0, device="cpu")
    wide = state.wide
    assert wide.params.dtype == torch.float32
    assert isinstance(wide.compression, torch.Tensor) == (field == "compressor")
    assert isinstance(wide.published, torch.Tensor) == (field == "staleness_bound")
    for extra in (wide.compression, wide.published):
        if isinstance(extra, torch.Tensor):
            assert torch.equal(extra, wide.params) and extra.data_ptr() != wide.params.data_ptr()
    leaves = tp2p.state_leaves(state)
    again = tp2p.with_leaves(state, leaves, 0)
    assert [t.data_ptr() for t in tp2p.state_leaves(again)] == [t.data_ptr() for t in leaves]
    tokens, labels = ttrain.lm_token_batches(np.random.default_rng(0), cfg.vocab_size,
                                             num_peers=2, local_steps=1, batch=2, seq=16)
    batches = tuple(torch.as_tensor(a, dtype=torch.int64) for a in (tokens, labels))
    _, after, _ = tp2p.make_round_fn(task, pcfg, device="cpu")(state, batches)
    for block in tp2p.param_blocks(after):
        assert bool(torch.isfinite(block.float()).all())
    assert after.wide.params.dtype == torch.float32
    assert not torch.equal(after.wide.params, state.wide.params)
    _, scan, _ = tp2p.make_scan_driver(task, pcfg, device="cpu", donate=False)(
        state, tuple(b[None] for b in batches))
    for a, b in zip(tp2p.state_leaves(after), tp2p.state_leaves(scan)):
        assert torch.equal(a, b)


def test_resolve_loss_and_init_fns():
    cfg = reduced(get_config("smollm-135m"))
    model = build_model(cfg)
    task = task_lib.from_model(model)
    assert tp2p.resolve_loss_fn(task) is task.loss_fn
    assert tp2p.resolve_init_fn(task) is task.init_params
    assert tp2p.resolve_init_fn(model.init) is model.init
    gen = torch.Generator().manual_seed(0)
    peers = [model.init(gen) for _ in range(2)]
    stacked = {n: torch.stack([p[n] for p in peers]) for n in peers[0]}
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 2, 8)))
    per_peer = lambda p, b: model.loss_fn(p, {"tokens": b[0], "labels": b[1]})  # noqa: E731
    bare = tp2p.resolve_loss_fn(per_peer)(stacked, (toks, toks))
    loop = torch.stack([per_peer({n: t[i] for n, t in stacked.items()}, (toks[i], toks[i]))
                        for i in range(2)])
    np.testing.assert_allclose(bare.numpy(), loop.numpy(), **TOL)
    np.testing.assert_allclose(task.loss_fn(stacked, (toks, toks)).numpy(), loop.numpy(), **TOL)


def _run_reference(monkeypatch, arch, **kw):
    """The reference's ``run_p2p_lm``, recording its initial state and the
    batches each round got."""
    seen = {"batches": []}
    real_init, real_round = jp2p.init_state, jp2p.make_round_fn

    def init_state(*a, **k):
        seen["state"] = real_init(*a, **k)
        return seen["state"]

    def make_round_fn(*a, **k):
        fn = real_round(*a, **k)

        def step(state, batch):
            seen["batches"].append({k: np.asarray(v) for k, v in batch.items()})
            return fn(state, batch)
        return step

    monkeypatch.setattr(jp2p, "init_state", init_state)
    monkeypatch.setattr(jp2p, "make_round_fn", make_round_fn)
    out = jtrain.run_p2p_lm(arch, **kw)
    monkeypatch.undo()
    return out, seen


def _run_port(monkeypatch, arch, init_params, **kw):
    seen = []
    real_round = tp2p.make_round_fn

    def make_round_fn(*a, **k):
        fn = real_round(*a, **k)

        def step(state, batches):
            seen.append(tuple(b.numpy() for b in batches))
            return fn(state, batches)
        return step

    monkeypatch.setattr(tp2p, "make_round_fn", make_round_fn)
    out = ttrain.run_p2p_lm(arch, device="cpu", init_params=init_params, **kw)
    monkeypatch.undo()
    return out, seen


@pytest.mark.parametrize("arch", ["smollm-135m", *SSM_ARCHS])
def test_run_p2p_lm_matches_reference(monkeypatch, arch):
    kw = dict(num_peers=2, local_steps=2, rounds=2, batch=2, seq=16)
    want, jseen = _run_reference(monkeypatch, arch, **kw)
    init = interop.params_from_jax(jax.tree.map(np.asarray, jseen["state"].params))
    got, tseen = _run_port(monkeypatch, arch, init, **kw)
    assert len(jseen["batches"]) == len(tseen) == 2
    for jb, (tokens, labels) in zip(jseen["batches"], tseen):
        np.testing.assert_array_equal(tokens, jb["tokens"])
        np.testing.assert_array_equal(labels, jb["labels"])
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    # After a complete graph's uniform mix every peer holds the same average,
    # so the drift is 0 in exact arithmetic; ``pairwise_drift`` expands
    # ||x_i - x_j||^2 = ||x_i||^2 + ||x_j||^2 - 2 x_i.x_j in float32, and both
    # packages return that expansion's cancellation noise (summed per leaf in
    # the reference, over the flat row in the port), held to its scale: a
    # float32 sum of N terms errs by about sqrt(N) eps of its size, so
    # sqrt(4 max ||x_k||^2 sqrt(N) eps)
    rows = [np.concatenate([np.asarray(x, np.float64)[i].ravel()
                            for x in jax.tree.leaves(jseen["state"].params)]) for i in range(2)]
    norm2 = max(float(np.sum(r ** 2)) for r in rows)
    noise = np.sqrt(4 * norm2 * np.sqrt(rows[0].size) * np.finfo(np.float32).eps)
    assert abs(got["final_drift"] - want["final_drift"]) <= noise
    assert 0.0 <= got["final_drift"] <= noise and 0.0 <= want["final_drift"] <= noise
    # the port's configuration is the reference's
    jcfg = jp2p.P2PConfig(algorithm="p2pl_affinity", num_peers=2, local_steps=2,
                          consensus_steps=1, lr=1e-2, momentum=0.5, eta_d=0.25,
                          topology="complete")
    tcfg = ttrain.lm_config(num_peers=2, local_steps=2, algorithm="p2pl_affinity", lr=1e-2,
                            momentum=0.5, eta_d=0.25)
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert {k: td[k] for k in jd if k in td} == {k: jd[k] for k in jd if k in td}


def test_bf16_round_matches_reference():
    """One round of reduced smollm-135m in bfloat16, from the reference's
    exported initial state: both packages' post-local and post-consensus
    parameters and d, and the losses, within bf16 tolerance."""
    k, t, b, s = 2, 2, 2, 16
    jcfg = dataclasses.replace(jreduced(jget_config("smollm-135m")), dtype="bfloat16")
    jmodel = jbuild_model(jcfg)
    pcfg = jp2p.P2PConfig(algorithm="p2pl_affinity", num_peers=k, local_steps=t,
                          consensus_steps=1, lr=5e-2, momentum=0.5, eta_d=0.25,
                          topology="complete")
    jstate = jp2p.init_state(jax.random.PRNGKey(3), jmodel.init, pcfg)
    assert jax.tree.leaves(jstate.params)[0].dtype == jnp.bfloat16
    tokens, labels = ttrain.lm_token_batches(np.random.default_rng(3), jcfg.vocab_size,
                                             num_peers=k, local_steps=t, batch=b, seq=s)
    j_local, j_after, j_losses = jp2p.make_round_fn(jmodel.loss_fn, pcfg)(
        jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})

    cfg = reduced(get_config("smollm-135m")).replace(dtype="bfloat16")
    task = task_lib.from_model(build_model(cfg))
    tcfg = ttrain.lm_config(num_peers=k, local_steps=t, algorithm="p2pl_affinity", lr=5e-2,
                            momentum=0.5, eta_d=0.25)
    init = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    state = tp2p.init_state(task, tcfg, device="cpu", init_params=init)
    assert state.params.dtype == torch.bfloat16
    t_local, t_after, t_losses = tp2p.make_round_fn(task, tcfg, device="cpu")(
        state, tuple(torch.as_tensor(a, dtype=torch.int64) for a in (tokens, labels)))
    np.testing.assert_allclose(t_losses.float().numpy(), np.asarray(j_losses, np.float32),
                               **BF16_TOL)
    for jst, tst in ((j_local, t_local), (j_after, t_after)):
        for field in ("params", "d_bias"):
            want = interop.flat_from_jax(jax.tree.map(np.asarray, getattr(jst, field)), task)
            got = getattr(tst, field)
            assert got.dtype == want.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(
        float(tconsensus.pairwise_drift(t_after.params)),
        float(jconsensus.pairwise_drift(j_after.params)), rtol=5e-2)


def test_loss_falls_claim():
    """The reference's claim (``tests/test_train_integration.py``) on the
    port: the loss falls by more than 0.3 over 25 rounds, drift finite."""
    out = ttrain.run_p2p_lm("smollm-135m", num_peers=2, local_steps=4, rounds=25, batch=8,
                            seq=16, lr=5e-2, momentum=0.5, device="cpu")
    assert min(out["losses"][-5:]) < out["losses"][0] - 0.3, out["losses"]
    assert np.isfinite(out["final_drift"])


def test_cli_p2p_lm(capsys):
    ttrain.main(["--experiment", "p2p_lm", "--device", "cpu", "--rounds", "1",
                 "--arch", "smollm-135m"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("round 0: loss")
    result = __import__("json").loads(out[-1])
    assert len(result["losses"]) == 1 and np.isfinite(result["final_drift"])
    argv = ["--experiment", "p2p_lm", "--peer-axis", "pod"]
    for main in (jtrain.main, ttrain.main):
        with pytest.raises(SystemExit):
            main(argv)
    ref_msg, port_msg = [line.split("error: ", 1)[1]
                         for line in capsys.readouterr().err.splitlines() if "error: " in line]
    assert port_msg == ref_msg


def test_bf16_drift_and_flat_export():
    """``pairwise_drift`` of a bf16 (K, row) buffer, in float32, against the
    reference's on the same bf16 leaves; ``interop.flat_from_jax`` carries
    the exported bf16 leaves into the bf16 layout bit for bit."""
    cfg = reduced(get_config("smollm-135m")).replace(dtype="bfloat16")
    task = task_lib.from_model(build_model(cfg))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=(3, *s.shape)), jnp.bfloat16),
                        jax.eval_shape(jbuild_model(dataclasses.replace(
                            jreduced(jget_config("smollm-135m")), dtype="bfloat16")).init,
                            jax.random.PRNGKey(0)))
    flat = interop.flat_from_jax(jax.tree.map(np.asarray, tree), task)
    layout = tp2p.ParamLayout.of(task)
    assert flat.dtype == torch.bfloat16 and flat.shape == (3, layout.row)
    for name, view in layout.views(flat).items():
        leaf = interop.params_from_jax(jax.tree.map(np.asarray, tree))[name]
        assert torch.equal(view.view(torch.int16), leaf.view(torch.int16))
    np.testing.assert_allclose(float(tconsensus.pairwise_drift(flat)),
                               float(jconsensus.pairwise_drift(tree)), rtol=1e-4)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_run_p2p_lm_runs_on_cuda_unless_asked(monkeypatch, device):
    """The entry point runs on the card unless the caller passes
    ``device="cpu"``: without CUDA it raises before it trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_p2p_lm("smollm-135m", rounds=1, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--experiment", "p2p_lm", "--rounds", "1"])

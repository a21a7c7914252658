"""The port's RWKV6 language model against the reference, on the CPU.

``reduced(get_config("rwkv6-7b"))`` (2 layers, d_model 128, head width 32,
chunk 4) with parameters exported from the reference: configs and parameter
counts equal, init shapes and types equal, and the time-mix (scan and
chunked), the block, ``rwkv6_prefill`` (logits and every state leaf) and
``rwkv6_decode_step`` allclose at prompt lengths 8 and 10 (10 leaves a ragged
chunk).  The chunked path's WKV goes through ``ops.wkv6``, whose CPU path is
the kernel's plain version.

Tolerances: float32 atol = rtol = 1e-4 (measured differences are ~3e-6:
the same arithmetic summed in another order).  The bf16 variant compares
at atol = rtol = 5e-2, the repository's bf16 kernel tolerance (the two
frameworks round bf16 at different places, one bf16 step is 1.6e-2 at the
logits' magnitude of 3), and asserts every output's type equals the
reference's, which a cast in the wrong place changes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
LENGTHS = [8, 10]


def _port_config(jcfg):
    """A reference ModelConfig rebuilt from the port's own dataclasses."""
    fields = dataclasses.asdict(jcfg)
    nested = {"attention": tbase.AttentionConfig, "moe": tbase.MoEConfig,
              "ssm": tbase.SSMConfig}
    for key, cls in nested.items():
        if fields[key] is not None:
            fields[key] = cls(**fields[key])
    return tbase.ModelConfig(**fields)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_equals_reference(size):
    jcfg, tcfg = jconfigs.get_config("rwkv6-7b"), tconfigs.get_config("rwkv6-7b")
    if size == "reduced":
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_config_module_equals_reference():
    assert tbase.FAMILIES == jbase.FAMILIES
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    for cls in ("AttentionConfig", "MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig"):
        tf_ = {f.name: f.default for f in dataclasses.fields(getattr(tbase, cls))}
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jbase, cls))}
        assert tf_ == jf, cls
    assert set(tconfigs.ARCHITECTURES) == set(jconfigs.ARCHITECTURES)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHITECTURES))
def test_param_count_and_reduced_equal_reference_for_every_architecture(arch):
    """The copied ``param_count`` / ``active_param_count`` / ``reduced`` on
    every reference architecture, at full and reduced size."""
    jcfg = jconfigs.get_config(arch)
    for j in (jcfg, jconfigs.reduced(jcfg)):
        t = _port_config(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert dataclasses.asdict(tconfigs.reduced(_port_config(jcfg))) == dataclasses.asdict(
        jconfigs.reduced(jcfg))


def test_rwkv6_7b_has_7_6_billion_parameters():
    assert tconfigs.get_config("rwkv6-7b").param_count() == 7_617_118_208


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHITECTURES))
def test_every_reference_architecture_is_registered(arch):
    """``get_config`` gives every reference architecture, with the
    reference's fields, and the registry builds its model."""
    assert dataclasses.asdict(tconfigs.get_config(arch)) == dataclasses.asdict(
        jconfigs.get_config(arch))
    model = build_model(tconfigs.reduced(tconfigs.get_config(arch)))
    assert model.cfg.family == jconfigs.get_config(arch).family


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    """(reference cfg, model, params; port cfg, model, params) at the reduced
    size in one dtype, the port's parameters exported from the reference's."""
    dtype = request.param
    jcfg = jconfigs.reduced(jconfigs.get_config("rwkv6-7b")).replace(dtype=dtype)
    tcfg = tconfigs.reduced(tconfigs.get_config("rwkv6-7b")).replace(dtype=dtype)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    return dtype, (jcfg, jmodel, jparams), (tcfg, tmodel, tparams)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _close(got, want, dtype, what=""):
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype),
                               err_msg=what)


def test_init_shapes_and_types_equal_reference(models):
    _, (_, _, jparams), (_, tmodel, tparams) = models
    mine = tmodel.init(torch.Generator().manual_seed(0))
    assert {n: (tuple(t.shape), t.dtype) for n, t in mine.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in tparams.items()}
    # truncated normals of the reference's scales: each drawn leaf's std
    # within 10% of the reference's (both are draws of ~1e4 values)
    flat_ref = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    for name in ("embed", "lm_head", "layers.time_mix.w_r", "layers.time_mix.bonus_u",
                 "layers.time_mix.mix_lora_b", "layers.channel_mix.wv_ff"):
        got, want = float(mine[name].float().std()), float(flat_ref[name].float().std())
        assert abs(got - want) < 0.1 * want, name
    for name in ("layers.time_mix.mix_mu", "layers.time_mix.decay_base", "ln0.scale",
                 "final_norm.bias"):
        assert torch.equal(mine[name], flat_ref[name]), name


def test_parameters_round_trip_exactly(models):
    """The nested, layer-stacked tree -> the port's flat dict -> the tree,
    bit for bit; bf16 leaves (``ml_dtypes.bfloat16`` arrays, which torch
    does not take as they are) included."""
    _, (_, _, jparams), (_, _, tparams) = models
    want = jax.tree.map(np.asarray, jparams)
    back = interop.params_to_jax(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _layer0(jparams, tparams, part):
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][part])
    tp = {name: p[0] for name, p in common.sub(tparams, f"layers.{part}.").items()}
    return jp, tp


def _inputs(cfg, length, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d, h, dk = cfg.d_model, cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    x = rng.normal(size=(2, length, d)).astype(np.float32)
    prev = rng.normal(size=(2, d)).astype(np.float32)
    wkv = rng.normal(size=(2, h, dk, dk)).astype(np.float32)
    jx = (jnp.asarray(x, dtype), jnp.asarray(prev, dtype), jnp.asarray(wkv))
    tx = (torch.as_tensor(x).to(getattr(torch, dtype)), torch.as_tensor(prev).to(
        getattr(torch, dtype)), torch.as_tensor(wkv))
    return jx, tx


@pytest.mark.parametrize("length", LENGTHS)
def test_time_mix_chunked_hands_rkv_over_in_the_model_type(models, length):
    """r, k and v reach the wkv6 wrapper in the model's type, uncast, and the
    layer's outputs are, bit for bit, those of the former path, which cast
    them to float32 first (bf16 -> float32 is exact and the output is
    rounded to the model's type once either way)."""
    dtype, (jcfg, _, jparams), (tcfg, _, tparams) = models
    _, ttm = _layer0(jparams, tparams, "time_mix")
    _, (x, prev, wkv) = _inputs(jcfg, length, dtype)
    got = tssm.rwkv6_time_mix_chunked(ttm, tcfg.ssm, x, prev, wkv)
    r, k, v, g, logd, new_prev = tssm._tm_projections(ttm, x, prev)
    dk = tcfg.ssm.head_dim
    o, wkv_final = wkv6_ops.wkv6(*(tssm._heads(t, dk).float() for t in (r, k, v)),
                                 tssm._heads(logd, dk), ttm["bonus_u"], state=wkv,
                                 chunk=min(tcfg.ssm.chunk, length))
    want = (tssm._tm_output(ttm, o, g, x.dtype), new_prev, wkv_final)
    for a, b, what in zip(got, want, ("out", "prev", "wkv")):
        assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_time_mix_matches_reference(models, form, length):
    dtype, (jcfg, _, jparams), (tcfg, _, tparams) = models
    jtm, ttm = _layer0(jparams, tparams, "time_mix")
    jx, tx = _inputs(jcfg, length, dtype)
    jfn = jax.jit(getattr(jssm, f"rwkv6_time_mix_{form}"), static_argnums=1)
    want = jfn(jtm, jcfg.ssm, *jx)
    got = getattr(tssm, f"rwkv6_time_mix_{form}")(ttm, tcfg.ssm, *tx)
    for g, w, what in zip(got, want, ("out", "prev", "wkv")):
        _close(g, w, dtype, what)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("chunked", [False, True])
def test_block_matches_reference(models, chunked, length):
    dtype, (jcfg, _, jparams), (tcfg, _, tparams) = models
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlayer = {name: p[0] for name, p in common.sub(tparams, "layers.").items()}
    (jx, jprev, jwkv), (tx, tprev, twkv) = _inputs(jcfg, length, dtype, seed=1)
    jstate = {"tm_prev": jprev, "cm_prev": jprev * 0.5, "wkv": jwkv}
    tstate = {"tm_prev": tprev, "cm_prev": tprev * 0.5, "wkv": twkv}
    jfn = jax.jit(jssm.rwkv6_block_apply, static_argnums=1, static_argnames="chunked")
    want_x, want_s = jfn(jlayer, jcfg.ssm, jx, jstate, chunked=chunked)
    got_x, got_s = tssm.rwkv6_block_apply(tlayer, tcfg.ssm, tx, tstate, chunked=chunked)
    _close(got_x, want_x, dtype, "x")
    for name in want_s:
        _close(got_s[name], want_s[name], dtype, name)


@pytest.mark.parametrize("length", LENGTHS)
def test_prefill_and_decode_step_match_reference(models, length):
    """rwkv6_prefill's logits and every state leaf, then one decode step's."""
    dtype, (_, jmodel, jparams), (_, tmodel, tparams) = models
    tokens = np.random.default_rng(length).integers(0, 512, (2, length))
    jlogits, jstate = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jmodel.init_cache(2, length + 4))
    tlogits, tstate = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)},
                                     tmodel.init_cache(2, length + 4, "cpu"))
    assert tlogits.shape == (2, 1, 512) and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, dtype, "prefill logits")
    assert set(tstate) == set(jstate)
    for name in jstate:
        assert tuple(tstate[name].shape) == jstate[name].shape
        _close(tstate[name], jstate[name], dtype, f"prefill {name}")

    token = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)
    jlogits2, jstate2 = jax.jit(jmodel.decode_step)(
        jparams, jnp.asarray(token, jnp.int32), jnp.full((2,), length, jnp.int32), jstate)
    tlogits2, tstate2 = tmodel.decode_step(tparams, torch.as_tensor(token),
                                           torch.full((2,), length), tstate)
    _close(tlogits2, jlogits2, dtype, "decode logits")
    for name in jstate2:
        _close(tstate2[name], jstate2[name], dtype, f"decode {name}")


@pytest.mark.parametrize("length", LENGTHS)
def test_loss_fn_matches_reference(models, length):
    """``Model.loss_fn`` (``rwkv6_loss_fn``: the chunked trunk, its WKV
    through the ``wkv6`` wrapper's plain version, then the cross entropy of
    the tied logits) on the reduced RWKV6-7B; 10 leaves a ragged chunk."""
    dtype, (_, jmodel, jparams), (_, tmodel, tparams) = models
    rng = np.random.default_rng(length + 1)
    tokens = rng.integers(0, 512, (2, length))
    labels = rng.integers(0, 512, (2, length))
    labels[0, :3] = -100  # ignored positions
    want = jax.jit(jmodel.loss_fn)(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                             "labels": jnp.asarray(labels, jnp.int32)})
    got = tmodel.loss_fn(tparams, {"tokens": torch.as_tensor(tokens),
                                   "labels": torch.as_tensor(labels)})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **_tol(dtype))


def test_make_batch_draws_tokens_in_range():
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config("rwkv6-7b")))
    batch = tmodel.make_batch(torch.Generator().manual_seed(0), 3, 7)
    for name in ("tokens", "labels"):
        t = batch[name]
        assert t.shape == (3, 7) and t.dtype == torch.int64
        assert int(t.min()) >= 0 and int(t.max()) < 512
    again = tmodel.make_batch(torch.Generator().manual_seed(0), 3, 7)
    assert torch.equal(batch["tokens"], again["tokens"])

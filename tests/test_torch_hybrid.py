"""The port's zamba2 hybrid (Mamba2 layers + a weight-shared attention block)
against the reference, on the CPU.

``reduced(get_config("zamba2-2.7b"))`` (4 Mamba2 layers, d_model 128, 8
heads of P = 32, N = 16, chunk 4; the shared block after every 2nd layer)
in float32, with parameters exported from the reference
(``interop.params_from_jax``): configs and parameter counts equal, init
shapes and types equal and an exact round trip; the reference's three Mamba2
checks (tests/test_ssm.py) re-run on the port; the Mamba2 scan and chunked
mixers, ``_hybrid_trunk_nocache``, ``hybrid_prefill`` at a ragged prompt of
10 and three ``hybrid_decode_step``s (logits and every cache leaf) allclose
to the reference's; ``hybrid_loss_fn`` and its gradients against the
reference's; and ``serve_batch`` and a K = 2 ``serve_fleet`` give the
reference's greedy tokens.  The chunked path's SSD goes through ``ops.ssd``
and the shared block's prefill attention through ``gqa_flash_attention``,
whose CPU paths are the kernels' plain versions.

Tolerances: float32 atol = rtol = 1e-4, as tests/test_torch_rwkv6.py (the
same arithmetic summed in another order); the re-run Mamba2 checks keep
tests/test_ssm.py's own (2e-5 and 3e-5).  Greedy tokens must equal the
reference's up to the first step whose top-2 logit margin is within twice
the tolerance (where the argmax may flip), as tests/test_torch_serve.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT, GEN = 10, 4  # 10 leaves a ragged chunk of the reduced chunk 4
M_CFG = dict(kind="mamba2", state_dim=16, head_dim=32, expand=2, chunk=8)  # tests/test_ssm.py's
D = 64


def _close(got, want, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_equals_reference(size):
    jcfg, tcfg = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    if size == "reduced":
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


def test_zamba2_has_2_35_billion_parameters():
    cfg = tconfigs.get_config(ARCH)
    assert cfg.param_count() == 2_353_423_808
    assert ttf.hybrid_num_shared_applications(cfg) == 9


@pytest.fixture(scope="module")
def models():
    """(reference model, params; port model, params) at the reduced size,
    the port's parameters exported from the reference's."""
    jmodel = jbuild_model(jconfigs.reduced(jconfigs.get_config(ARCH)))
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def test_init_shapes_and_types_equal_reference(models):
    _, jparams, tmodel, tparams = models
    mine = tmodel.init(torch.Generator().manual_seed(0))
    assert {n: (tuple(t.shape), t.dtype) for n, t in mine.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in tparams.items()}
    for name in ("layers.mamba.conv_b", "layers.mamba.dt_bias", "layers.mamba.A_log",
                 "layers.mamba.D", "layers.mamba.norm.scale", "final_norm.scale"):
        assert torch.equal(mine[name], tparams[name]), name
    # truncated normals of the reference's scales: each drawn leaf's std
    # within 10% of the reference's
    for name in ("embed", "layers.mamba.in_proj", "layers.mamba.conv_w", "shared_proj",
                 "shared_block.attn.w_q"):
        got, want = float(mine[name].std()), float(tparams[name].std())
        assert abs(got - want) < 0.1 * want, name


def test_parameters_and_cache_round_trip_exactly(models):
    jmodel, jparams, tmodel, tparams = models
    want = jax.tree.map(np.asarray, jparams)
    back = interop.params_to_jax(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    jcache = interop.params_from_jax(jax.tree.map(np.asarray, jmodel.init_cache(2, 8)))
    tcache = tmodel.init_cache(2, 8, "cpu")
    assert set(tcache) == set(jcache) == {"mamba.conv", "mamba.ssm", "attn.k", "attn.v",
                                          "attn.pos_ids"}
    for name in tcache:
        assert torch.equal(tcache[name], jcache[name]), name


@pytest.mark.parametrize("length", [8, 10])
def test_loss_fn_matches_reference(models, length):
    """``hybrid_loss_fn`` (the reference's: zero Mamba2 states, the shared
    block without a cache) and its gradients, at a whole and a ragged
    number of chunks of 4: the loss at TOL, every leaf's gradient at atol
    1e-5 / rtol 1e-3 (sums over the tokens in another order; the SSD's
    through ``ref.ssd_bwd_ref``)."""
    jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(length)
    batch = {k: rng.integers(0, tmodel.cfg.vocab_size, size=(2, length)).astype(np.int32)
             for k in ("tokens", "labels")}
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = {n: t.clone().requires_grad_(True) for n, t in tparams.items()}
    loss = tmodel.loss_fn(params, {k: torch.as_tensor(v, dtype=torch.int64)
                                   for k, v in batch.items()})
    _close(loss.detach(), jloss)
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    want = interop.params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the Mamba2 mixer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    """tests/test_ssm.py's Mamba2 layer (d 64, P 32, N 16, chunk 8), exported."""
    jcfg, tcfg = JSSMConfig(**M_CFG), SSMConfig(**M_CFG)
    jparams = jssm.mamba2_init(jax.random.PRNGKey(0), D, jcfg, jnp.float32)
    return jcfg, jparams, tcfg, interop.params_from_jax(jax.tree.map(np.asarray, jparams))


def _x(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_reference_check_chunked_equals_scan(mamba):
    _, _, cfg, params = mamba
    x = _x((2, 32, D), 1)
    o1, s1 = tssm.mamba2_apply_scan(params, cfg, x)
    o2, s2 = tssm.mamba2_apply_chunked(params, cfg, x)
    for got, want in ((o2, o1), (s2["ssm"], s1["ssm"]), (s2["conv"], s1["conv"])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_reference_check_state_continuation(mamba):
    """prefill(2T) == prefill(T) then scan the second half with carried state."""
    _, _, cfg, params = mamba
    x = _x((1, 16, D), 2)
    o_full, s_full = tssm.mamba2_apply_chunked(params, cfg, x)
    _, s_a = tssm.mamba2_apply_chunked(params, cfg, x[:, :8])
    o_b, s_b = tssm.mamba2_apply_scan(params, cfg, x[:, 8:], s_a)
    np.testing.assert_allclose(o_full[:, 8:].numpy(), o_b.numpy(), atol=3e-5)
    np.testing.assert_allclose(s_full["ssm"].numpy(), s_b["ssm"].numpy(), atol=3e-5)


def test_reference_check_decode_one_token(mamba):
    _, _, cfg, params = mamba
    x = _x((2, 9, D), 3)
    o_full, _ = tssm.mamba2_apply_scan(params, cfg, x)
    _, s = tssm.mamba2_apply_scan(params, cfg, x[:, :8])
    o_step, _ = tssm.mamba2_apply_scan(params, cfg, x[:, 8:9], s)
    np.testing.assert_allclose(o_full[:, -1].numpy(), o_step[:, 0].numpy(), atol=3e-5)


@pytest.mark.parametrize("length", [8, 10, 3])
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_mixer_matches_reference_from_a_state(mamba, form, length):
    """Output, conv state and SSM state from a random state; 10 and 3 leave
    a ragged chunk (chunk 8), which the reference pads."""
    jcfg, jparams, tcfg, tparams = mamba
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, length, D)).astype(np.float32)
    state = {"conv": rng.normal(size=(2, 3, 2 * D + 32)).astype(np.float32),
             "ssm": rng.normal(size=(2, 4, 32, 16)).astype(np.float32)}
    jfn = jax.jit(getattr(jssm, f"mamba2_apply_{form}"), static_argnums=1)
    want, want_s = jfn(jparams, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    got, got_s = getattr(tssm, f"mamba2_apply_{form}")(
        tparams, tcfg, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in state.items()})
    _close(got, want, "out")
    for name in ("conv", "ssm"):
        _close(got_s[name], want_s[name], name)


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------


def test_trunk_nocache_matches_reference(models):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    tokens = np.random.default_rng(5).integers(0, 512, (2, PROMPT))
    jx = jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0)
    jstates = jmodel.init_cache(2, PROMPT)["mamba"]
    positions = np.tile(np.arange(PROMPT), (2, 1))
    want, want_s = jax.jit(jtf._hybrid_trunk_nocache, static_argnums=1)(
        jparams, jmodel.cfg, jx, jnp.asarray(positions), jstates)
    tstates = common.sub(tmodel.init_cache(2, PROMPT, "cpu"), ttf.MAMBA_CACHE)
    got, got_s = ttf._hybrid_trunk_nocache(tparams, cfg, tparams["embed"][torch.as_tensor(tokens)],
                                           torch.as_tensor(positions), tstates)
    _close(got, want, "x")
    for name in want_s:
        _close(got_s[name], want_s[name], name)


def test_prefill_and_decode_steps_match_reference(models):
    """hybrid_prefill at a ragged prompt, then three decode steps: logits and
    every cache leaf, the KV positions exactly."""
    jmodel, jparams, tmodel, tparams = models
    tokens = np.random.default_rng(6).integers(0, 512, (2, PROMPT))
    cache_len = PROMPT + 3
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jmodel.init_cache(2, cache_len))
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)},
                                     tmodel.init_cache(2, cache_len, "cpu"))
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(4):
        if step:
            token = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)
            pos = PROMPT + step - 1
            jlogits, jcache = jdecode(jparams, jnp.asarray(token, jnp.int32),
                                      jnp.full((2,), pos, jnp.int32), jcache)
            tlogits, tcache = tmodel.decode_step(tparams, torch.as_tensor(token),
                                                 torch.full((2,), pos), tcache)
        assert tlogits.shape == (2, 1, 512) and tlogits.dtype == torch.float32
        _close(tlogits, jlogits, f"step {step} logits")
        flat = interop.params_from_jax(jax.tree.map(np.asarray, jcache))
        assert set(tcache) == set(flat)
        for name, want in flat.items():
            assert tcache[name].shape == want.shape and tcache[name].dtype == want.dtype, name
            if name == "attn.pos_ids":
                assert torch.equal(tcache[name], want), f"step {step} {name}"
            else:
                _close(tcache[name], want.numpy(), f"step {step} {name}")


def _reference_greedy(jmodel, jparams, tokens, gen):
    """The reference's greedy tokens (its ``make_generate_fn``) and, per
    step, each row's first step whose top-2 logit margin is within twice the
    tolerance (the argmax may flip there)."""
    b, s = tokens.shape
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    toks, _ = jax.jit(jsteps.make_generate_fn(jmodel, gen))(jparams, jbatch,
                                                           jmodel.init_cache(b, s + gen))
    toks = np.asarray(toks)
    logits, cache = jax.jit(jmodel.prefill)(jparams, jbatch, jmodel.init_cache(b, s + gen))
    decode = jax.jit(jmodel.decode_step)
    upto = np.full(b, gen)
    for step in range(gen):
        if step:
            logits, cache = decode(jparams, jnp.asarray(toks[:, step - 1]),
                                   jnp.full((b,), s + step - 1, jnp.int32), cache)
        want = np.asarray(logits)[:, -1]
        assert np.array_equal(want.argmax(-1), toks[:, step])
        top2 = np.sort(want, axis=-1)[:, -2:]
        limit = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(want).max(axis=-1))
        close = (top2[:, 1] - top2[:, 0]) <= limit
        upto = np.where(close & (upto == gen), step + 1, upto)
    return toks, upto


def _assert_same_tokens(got, want, upto):
    for row in range(want.shape[0]):
        n = upto[row]
        assert np.array_equal(got[row, :n], want[row, :n]), (row, got[row], want[row])


def _serving_model(tmodel, peer_params, prompts):
    """The reduced model whose draws are the exported parameters (peer p's
    for a generator seeded ``1 + p``, as ``serve_fleet`` seeds them; seed 0,
    ``serve_batch``'s, is peer 0) and the prompts given, in turn."""
    prompt_iter = iter(prompts)

    def init(gen):
        return peer_params[max(gen.initial_seed() - 1, 0)]

    def make_batch(_gen, _b, _s):
        return {"tokens": next(prompt_iter)}

    return dataclasses.replace(tmodel, init=init, make_batch=make_batch)


def test_serve_batch_gives_reference_greedy_tokens(models, monkeypatch):
    jmodel, jparams, tmodel, tparams = models
    tokens = np.random.default_rng(7).integers(0, 512, (2, PROMPT))
    want, upto = _reference_greedy(jmodel, jparams, tokens, GEN)
    monkeypatch.setattr(serve, "_model_of", lambda *_: _serving_model(
        tmodel, [tparams], [torch.as_tensor(tokens)]))
    ssd_ops.launches.reset()
    flash_ops.launches.reset()
    out = serve.serve_batch(ARCH, batch=2, prompt_len=PROMPT, gen_tokens=GEN, device="cpu")
    assert ssd_ops.launches.count == 0 and flash_ops.launches.count == 0
    assert out["tokens"].shape == (2, GEN) and out["decode_steps"] == GEN - 1
    _assert_same_tokens(out["tokens"].numpy(), want, upto)
    assert bool((out["cache"]["attn.pos_ids"][:, :, :PROMPT + GEN - 1] >= 0).all())


def test_serve_fleet_gives_reference_greedy_tokens(models, monkeypatch):
    """K = 2 peers of different parameters, one request group each: the
    port's fleet against the reference's stacked fleet, token for token."""
    jmodel, jparams0, tmodel, _ = models
    jpeers = [jparams0, jax.jit(jmodel.init)(jax.random.PRNGKey(1))]
    tpeers = [interop.params_from_jax(jax.tree.map(np.asarray, p)) for p in jpeers]
    prompts = np.random.default_rng(8).integers(0, 512, (2, 2, PROMPT))
    stacked = jax.tree.map(lambda *leaves: jnp.stack(leaves), *jpeers)
    caches = jserve.stack_request_caches(jmodel.init_cache(2, PROMPT + GEN), 2)
    jtoks, _ = jax.jit(jserve.make_fleet_generate_fn(jmodel, GEN))(
        stacked, {"tokens": jnp.asarray(prompts, jnp.int32)}, caches, jnp.arange(2))
    monkeypatch.setattr(serve, "_model_of", lambda *_: _serving_model(
        tmodel, tpeers, [torch.as_tensor(p) for p in prompts]))
    out = serve.serve_fleet(ARCH, num_peers=2, batch=2, prompt_len=PROMPT, gen_tokens=GEN,
                            device="cpu")
    assert out["tokens"].shape == (2, 2, GEN)
    for peer in range(2):
        want, upto = _reference_greedy(jmodel, jpeers[peer], prompts[peer], GEN)
        assert np.array_equal(np.asarray(jtoks)[peer], want)
        _assert_same_tokens(out["tokens"][peer].numpy(), want, upto)
    assert not torch.equal(out["tokens"][0], out["tokens"][1])


def test_serve_batch_on_cpu_draws_and_serves():
    """``serve_batch`` end to end on the reduced model it draws itself: no
    launch counted, the cache's layout and positions."""
    ssd_ops.launches.reset()
    flash_ops.launches.reset()
    out = serve.serve_batch(ARCH, batch=2, prompt_len=7, gen_tokens=3, device="cpu")
    assert ssd_ops.launches.count == 0 and flash_ops.launches.count == 0
    cache = out["cache"]
    assert cache["mamba.ssm"].shape == (4, 2, 8, 32, 16) and cache["mamba.ssm"].dtype == \
        torch.float32
    assert cache["mamba.conv"].shape == (4, 2, 3, 256 + 2 * 16)  # d_inner + B and C
    assert cache["attn.pos_ids"].shape == (2, 2, 10)
    assert torch.equal(cache["attn.pos_ids"][0, 0], torch.tensor(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, -1], dtype=torch.int32))
    stacked = serve.stack_request_caches(cache, 3)
    assert set(stacked) == set(cache) and stacked["mamba.ssm"].shape == (3, 4, 2, 8, 32, 16)

"""The port's vlm decoder (internvl2-2b: a projected image prefix before the
text) and encoder-decoder (seamless-m4t-medium) against the reference, on
the CPU.

- Configs, ``reduced`` and ``param_count`` equal the reference's; the
  parameter tree exported through ``interop.params_from_jax`` has exactly
  the keys, shapes and types of the port's own init, and round-trips bit for
  bit.
- ``encoder_kv`` and ``cross_attention_apply`` (group 1 and group 2),
  ``encdec_encode`` (its non-causal self-attention through
  ``gqa_flash_attention``, whose CPU path is the kernel's plain version),
  ``encdec_cross_kv`` and the vlm ``_decoder_embed``.
- Prefill logits and every cache leaf for both families, float32 and bf16;
  then four greedy decode steps, each step's token the reference's argmax,
  logits and caches at every step.
- The serving steps on the reference's exported parameters and prompt:
  ``make_generate_fn`` (the scanned decode) and prefill plus
  ``make_decode_loop`` give the reference's greedy tokens; a K = 2
  ``make_fleet_generate_fn`` gives the reference's fleet.  ``serve_batch``'s
  two decodes equal bit for bit; ``serve_batch`` and ``serve_fleet`` run
  both families.
- The encoder-decoder's cache wrap, a reference quirk the port follows
  (ROADMAP.md section 3): its cache is sized by ``split_encdec_seq(prompt +
  gen)``, so at prompt 16 and 8 tokens decode position 18 lands in slot 0 in
  both packages.
- ``encdec_loss_fn`` and its gradients against the reference's, float32
  and bf16; the vlm's loss is ``decoder_loss_fn``
  (tests/test_torch_lm_train.py).

Tolerances: float32 atol 5e-5 / rtol 1e-4 (the same arithmetic summed in
another order); bf16 5e-2, the repository's bf16 tolerance, with every
output's type equal to the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

F32_TOL = dict(atol=5e-5, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
VLM, ENCDEC = "internvl2-2b", "seamless-m4t-medium"
ARCHS = (VLM, ENCDEC)
VOCAB = 512  # reduced()


def _export(tree):
    return interop.params_from_jax(jax.tree.map(np.asarray, tree))


def _batch_to_torch(jbatch: dict) -> dict:
    """A reference batch as the port's: int32 tokens as int64, float32 as is."""
    return {name: torch.as_tensor(np.array(x)).to(torch.int64 if x.dtype == jnp.int32
                                                  else torch.float32)
            for name, x in jbatch.items()}


def _close(got, want, dtype="float32", what=""):
    assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL), err_msg=what)


def _close_caches(got: dict, jcache, dtype, what):
    want = _export(jcache)
    assert set(got) == set(want), what
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype, name
        if want[name].dtype == torch.int32:
            assert torch.equal(got[name], want[name]), f"{what} {name}"
        else:
            _close(got[name], interop._array_of(want[name]), dtype, f"{what} {name}")


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32", seed=0):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(dtype=dtype)
    jmodel = jbuild_model(jcfg)
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config(arch)).replace(dtype=dtype))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    return jmodel, jparams, tmodel, _export(jparams)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    """(dtype, reference model, params, port model, params) of a reduced
    arch, the port's parameters exported from the reference's."""
    arch, dtype = request.param
    return (dtype, *_models(arch, dtype))


@pytest.fixture(scope="module", params=ARCHS)
def f32_models(request):
    return _models(request.param)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_equals_reference(arch, size):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if size == "reduced":
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_full_param_counts():
    assert tconfigs.get_config(VLM).param_count() == 1_891_241_984
    assert tconfigs.get_config(ENCDEC).param_count() == 715_401_216


@pytest.mark.parametrize("s", [1, 2, 5, 16, 1024, 1040])
def test_sequence_splits_equal_reference(s):
    cfg = tconfigs.get_config(VLM)
    jcfg = jconfigs.get_config(VLM)
    assert tregistry.split_vlm_seq(cfg, s) == jregistry.split_vlm_seq(jcfg, s)
    assert tregistry.split_encdec_seq(s) == jregistry.split_encdec_seq(s)


def test_exported_tree_has_the_port_keys_shapes_and_types(models):
    """``params_from_jax`` of the reference's tree: exactly the port's init's
    keys, shapes and types, the init's spread close to the reference's."""
    dtype, _, _, tmodel, tparams = models
    mine = tmodel.init(torch.Generator().manual_seed(0))
    assert {n: (tuple(t.shape), t.dtype) for n, t in mine.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in tparams.items()}
    arch = tmodel.cfg.name
    named = ("projector", "lm_head", "layers.attn.w_q") if arch == VLM else (
        "frontend_proj", "enc_layers.attn.w_k", "dec_layers.cross.w_q", "dec_layers.mlp.w_up")
    for name in ("embed", *named):
        assert name in mine, name
        got, want = float(mine[name].float().std()), float(tparams[name].float().std())
        assert abs(got - want) < 0.1 * want, name
    if arch == ENCDEC:
        assert "lm_head" not in mine and "dec_layers.ln_cross.scale" in mine


def test_parameters_round_trip_exactly(models):
    _, _, jparams, _, tparams = models
    want = jax.tree.map(np.asarray, jparams)
    back = interop.params_to_jax(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_cache_layout_equals_reference(f32_models):
    jmodel, _, tmodel, _ = f32_models
    for b, s in ((2, 9), (1, 24), (3, 1040)):
        want = _export(jmodel.init_cache(b, s))
        got = tmodel.init_cache(b, s, "cpu")
        assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == {
            n: (tuple(t.shape), t.dtype) for n, t in want.items()}
        for name in want:
            assert torch.equal(got[name], want[name]), name


def test_make_batch_layout_equals_reference(f32_models):
    jmodel, _, tmodel, _ = f32_models
    want = jmodel.make_batch(jax.random.PRNGKey(0), 3, 20)
    got = tmodel.make_batch(torch.Generator().manual_seed(0), 3, 20)
    assert set(got) == set(want)
    for name, x in want.items():
        assert tuple(got[name].shape) == x.shape, name
        assert got[name].dtype == (torch.int64 if x.dtype == jnp.int32 else torch.float32)
    assert bool(((got["tokens"] >= 0) & (got["tokens"] < VOCAB)).all())


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(kv_heads, dtype):
    """``encoder_kv`` and ``cross_attention_apply`` at group 1 and group 2,
    with more and with fewer encoder frames than decoder tokens."""
    jcfg = jconfigs.reduced(jconfigs.get_config(ENCDEC))
    acfg = dataclasses.replace(jcfg.attention, num_kv_heads=kv_heads)
    tacfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(ENCDEC)).attention,
                                num_kv_heads=kv_heads)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jax.jit(lambda k: jattention.init(k, 128, acfg, jdt))(jax.random.PRNGKey(3))
    tp = _export(jp)
    rng = np.random.default_rng(5)
    for t, s in ((7, 3), (2, 9), (1, 5)):
        enc = rng.standard_normal((2, s, 128)).astype(np.float32)
        x = rng.standard_normal((2, t, 128)).astype(np.float32)
        jenc, jx = jnp.asarray(enc).astype(jdt), jnp.asarray(x).astype(jdt)
        tenc, tx = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (enc, x))
        jk, jv = jattention.encoder_kv(jp, acfg, jenc)
        tk, tv = tattention.encoder_kv(tp, tacfg, tenc)
        assert tk.shape == (2, s, kv_heads, 32)
        _close(tk, jk, dtype, "k")
        _close(tv, jv, dtype, "v")
        jout = jattention.cross_attention_apply(jp, acfg, jx, (jk, jv))
        tout = tattention.cross_attention_apply(tp, tacfg, tx, (tk, tv))
        _close(tout, jout, dtype, f"cross t={t} s={s}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_cross_kv_match_reference(dtype):
    jmodel, jparams, tmodel, tparams = _models(ENCDEC, dtype)
    frames = np.random.default_rng(6).standard_normal((2, 5, 32)).astype(np.float32)
    jenc = jax.jit(lambda p, f: jtf.encdec_encode(p, jmodel.cfg, f))(jparams, jnp.asarray(frames))
    flash_ops.launches.reset()
    tenc = ttf.encdec_encode(tparams, tmodel.cfg, torch.as_tensor(frames))
    assert flash_ops.launches.count == 0  # CPU tensors: the plain version
    _close(tenc, jenc, dtype, "encoder output")
    jk, jv = jax.jit(lambda p, e: jtf.encdec_cross_kv(p, jmodel.cfg, e))(jparams, jenc)
    tk, tv = ttf.encdec_cross_kv(tparams, tmodel.cfg, tenc)
    assert tk.shape == (2, 2, 5, 2, 32)
    _close(tk, jk, dtype, "cross_k")
    _close(tv, jv, dtype, "cross_v")


def test_encoder_attention_is_not_causal():
    """A frame's encoder output depends on later frames (the encoder attends
    over every frame), a decoder token's logits not on later tokens."""
    _, _, tmodel, tparams = _models(ENCDEC)
    frames = torch.as_tensor(np.random.default_rng(7).standard_normal((1, 6, 32)),
                             dtype=torch.float32)
    base = ttf.encdec_encode(tparams, tmodel.cfg, frames)
    moved = frames.clone()
    moved[:, -1] += 1.0
    assert float((ttf.encdec_encode(tparams, tmodel.cfg, moved)[:, 0] - base[:, 0]).abs().max()) \
        > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_embed_matches_reference(dtype):
    jmodel, jparams, tmodel, tparams = _models(VLM, dtype)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, VOCAB, (2, 5))
    patches = rng.standard_normal((2, 4, 32)).astype(np.float32)
    jx = jtf._decoder_embed(jparams, jmodel.cfg, jnp.asarray(tokens, jnp.int32),
                            jnp.asarray(patches))
    tx = ttf._decoder_embed(tparams, tmodel.cfg, torch.as_tensor(tokens),
                            torch.as_tensor(patches))
    assert tx.shape == (2, 9, 128)
    _close(tx, jx, dtype, "prefix + text embeddings")
    _close(ttf._decoder_embed(tparams, tmodel.cfg, torch.as_tensor(tokens)),
           jtf._decoder_embed(jparams, jmodel.cfg, jnp.asarray(tokens, jnp.int32)), dtype,
           "text only")


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def test_prefill_and_greedy_decode_match_reference(models):
    """Prefill of a 14-long sequence (vlm: 4 patches and 10 tokens; encdec: 3
    frames and 11 tokens), then 4 greedy decode steps, each step fed the
    reference's argmax: logits, tokens and every cache leaf at every step."""
    dtype, jmodel, jparams, tmodel, tparams = models
    b, s, n_steps = 2, 14, 4
    jbatch = jmodel.make_batch(jax.random.PRNGKey(9), b, s)
    tbatch = _batch_to_torch(jbatch)
    flash_ops.launches.reset()
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jbatch, jmodel.init_cache(b, s + n_steps))
    tlogits, tcache = tmodel.prefill(tparams, tbatch, tmodel.init_cache(b, s + n_steps, "cpu"))
    assert flash_ops.launches.count == 0
    assert tlogits.shape == (b, 1, VOCAB) and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, dtype, "prefill logits")
    _close_caches(tcache, jcache, dtype, "prefill")
    pos0 = steps.prompt_dec_len(tbatch)
    assert pos0 == (s if tmodel.cfg.family == "vlm" else s - s // 4)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(n_steps):
        token = np.array(jnp.argmax(jlogits[:, -1], axis=-1))
        if dtype == "float32":
            assert np.array_equal(torch.argmax(tlogits[:, -1], dim=-1).numpy(), token), step
        pos = pos0 + step
        jlogits, jcache = jdecode(jparams, jnp.asarray(token, jnp.int32),
                                  jnp.full((b,), pos, jnp.int32), jcache)
        tlogits, tcache = tmodel.decode_step(tparams, torch.as_tensor(token, dtype=torch.int64),
                                             torch.full((b,), pos), tcache)
        _close(tlogits, jlogits, dtype, f"decode {step} logits")
        _close_caches(tcache, jcache, dtype, f"decode {step}")


def test_inplace_decode_step_equals_functional(f32_models):
    """``inplace=True`` writes the cache it is given and returns it; the
    values equal the functional step's, bit for bit."""
    _, _, tmodel, tparams = f32_models
    batch = tmodel.make_batch(torch.Generator().manual_seed(2), 2, 12)
    _, cache = tmodel.prefill(tparams, batch, tmodel.init_cache(2, 16, "cpu"))
    token, pos = torch.tensor([3, 5]), torch.full((2,), steps.prompt_dec_len(batch))
    want_logits, want = tmodel.decode_step(tparams, token, pos, cache)
    copy = {name: t.clone() for name, t in cache.items()}
    got_logits, got = tmodel.decode_step(tparams, token, pos, copy, inplace=True)
    assert got is copy
    assert torch.equal(got_logits, want_logits)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert not torch.equal(copy[next(n for n in copy if n.endswith("pos_ids"))],
                           cache[next(n for n in cache if n.endswith("pos_ids"))])


@pytest.mark.parametrize("decode_impl", ["scan", "python"])
def test_generate_equals_reference_tokens(f32_models, decode_impl):
    """The serving steps on the reference's exported parameters and prompt:
    prefill then the scanned decode (``make_generate_fn``), or prefill then
    ``make_decode_loop``, give the reference's greedy tokens (its
    ``make_generate_fn``, one ``lax.scan``)."""
    jmodel, jparams, tmodel, tparams = f32_models
    b, s, gen = 2, 12, 6
    jbatch = jmodel.make_batch(jax.random.PRNGKey(11), b, s)
    jtoks, jcache = jax.jit(jsteps.make_generate_fn(jmodel, gen))(
        jparams, jbatch, jmodel.init_cache(b, s + gen))
    tbatch = _batch_to_torch(jbatch)
    cache = tmodel.init_cache(b, s + gen, "cpu")
    if decode_impl == "scan":
        ttoks, tcache = steps.make_generate_fn(tmodel, gen)(tparams, tbatch, cache)
    else:
        tok, cache = steps.make_prefill_step(tmodel)(tparams, tbatch, cache)
        pos = torch.full((b,), steps.prompt_dec_len(tbatch))
        rest, tcache = steps.make_decode_loop(tmodel, gen - 1)(tparams, cache, tok, pos)
        ttoks = torch.cat([tok[:, None], rest], dim=1)
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close_caches(tcache, jcache, "float32", "after generate")


def test_fleet_equals_reference_fleet(f32_models):
    """A K = 2 fleet of stacked exported parameters, request groups routed
    to peers 1 and 0: the reference's fleet's tokens and caches."""
    jmodel, _, tmodel, _ = f32_models
    k, b, s, gen = 2, 2, 10, 4
    jstacked = jax.jit(jax.vmap(jmodel.init))(jax.random.split(jax.random.PRNGKey(12), k))
    jprompts = jax.vmap(lambda key: jmodel.make_batch(key, b, s))(
        jax.random.split(jax.random.PRNGKey(13), k))
    jcaches = jserve.stack_request_caches(jmodel.init_cache(b, s + gen), k)
    peer_ids = np.array([1, 0])
    jtoks, jnew = jax.jit(jserve.make_fleet_generate_fn(jmodel, gen))(
        jstacked, jprompts, jcaches, jnp.asarray(peer_ids, jnp.int32))
    ttoks, tnew = serve.make_fleet_generate_fn(tmodel, gen)(
        _export(jstacked), _batch_to_torch(jprompts),
        serve.stack_request_caches(tmodel.init_cache(b, s + gen, "cpu"), k),
        torch.as_tensor(peer_ids))
    assert ttoks.shape == (k, b, gen)
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close_caches(tnew, jnew, "float32", "fleet caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_scan_equals_python_loop(arch):
    """``serve_batch``'s two decodes on the reduced model it draws: equal
    tokens and every leaf of the final cache, bit for bit."""
    kw = dict(batch=2, prompt_len=12, gen_tokens=5, device="cpu")
    scan = serve.serve_batch(arch, decode_impl="scan", **kw)
    loop = serve.serve_batch(arch, decode_impl="python", **kw)
    assert scan["tokens"].shape == (2, 5)
    assert torch.equal(scan["tokens"], loop["tokens"])
    assert set(scan["cache"]) == set(loop["cache"])
    for name in scan["cache"]:
        assert torch.equal(scan["cache"][name], loop["cache"][name]), name


def test_encdec_cache_wrap_follows_reference():
    """The reference quirk (ROADMAP.md section 3): the encoder-decoder's
    cache has ``split_encdec_seq(16 + 8)`` = 18 decoder slots, the prompt's
    decoder side is 12 tokens, so decode position 18 overwrites slot 0 in
    both packages; the cross k and v are the prompt's 4 frames'."""
    from repro.launch.serve import serve_batch as jserve_batch

    want = [18] + list(range(1, 18))
    jout = jserve_batch(ENCDEC, batch=1, prompt_len=16, gen_tokens=8, use_reduced=True,
                        decode_impl="python")
    assert np.asarray(jout["cache"]["self"]["pos_ids"])[:, 0].tolist() == [want, want]
    for impl in ("scan", "python"):
        tout = serve.serve_batch(ENCDEC, batch=1, prompt_len=16, gen_tokens=8, device="cpu",
                                 decode_impl=impl)
        assert tout["cache"]["self.pos_ids"][:, 0].tolist() == [want, want], impl
        assert tout["cache"]["cross_k"].shape == (2, 1, 4, 2, 32)
        assert np.asarray(jout["cache"]["cross_k"]).shape == (2, 1, 4, 2, 32)


def test_vlm_positions_run_across_the_prefix():
    """The vlm cache holds the prefix and the text at positions 0 .. Np + St
    - 1, then the decoded tokens after them."""
    out = serve.serve_batch(VLM, batch=1, prompt_len=16, gen_tokens=8, device="cpu")
    assert out["cache"]["main.pos_ids"][0, 0].tolist() == list(range(23)) + [-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_fleet_runs_the_family(arch):
    out = serve.serve_fleet(arch, num_peers=2, batch=2, prompt_len=6, gen_tokens=3,
                            device="cpu")
    assert out["tokens"].shape == (2, 2, 3)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < VOCAB)).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_family(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "1", "--prompt-len", "8",
                "--gen", "3"])
    assert f"arch={arch}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_raises_naming_item_18(arch):
    """Named for the item-18 raise it held until the encoder-decoder's loss
    was ported; it now holds the loss.  Both families' losses are ported:
    the vlm's is ``decoder_loss_fn`` (held to the reference in
    tests/test_torch_lm_train.py), finite on a batch of its own; the encoder-decoder's ``encdec_loss_fn`` (the frames
    encoded, the decoder over the tokens with the cross k and v, no cache)
    and its gradients equal the reference's ``jax.value_and_grad``, float32
    (the loss at 5e-5 / 1e-4, each gradient at 1e-5 / 1e-3, as
    tests/test_torch_lm_train.py holds the decoders') and bf16 (5e-2, every
    gradient in its leaf's type)."""
    model = build_model(tconfigs.reduced(tconfigs.get_config(arch)))
    if model.cfg.family == "vlm":
        gen = torch.Generator().manual_seed(0)
        loss = model.loss_fn(model.init(gen), model.make_batch(gen, 2, 12))
        assert loss.dim() == 0 and bool(torch.isfinite(loss))
        return
    for dtype, loss_tol, grad_tol in (("float32", F32_TOL, dict(atol=1e-5, rtol=1e-3)),
                                      ("bfloat16", BF16_TOL, BF16_TOL)):
        jmodel, jparams, tmodel, params = _models(arch, dtype)
        jbatch = jmodel.make_batch(jax.random.PRNGKey(5), 2, 24)
        jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(jparams, jbatch)
        leaves = {name: v.clone().requires_grad_(True) for name, v in params.items()}
        loss = ttf.encdec_loss_fn(leaves, tmodel.cfg, _batch_to_torch(jbatch))
        assert loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss.detach()), float(jloss), **loss_tol, err_msg=dtype)
        grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
        want = _export(jgrads)
        assert set(want) == set(leaves)
        for name, g in zip(leaves, grads):
            assert g.dtype == want[name].dtype, name
            np.testing.assert_allclose(g.float().numpy(), want[name].float().numpy(),
                                       **grad_tol, err_msg=f"{dtype} {name}")
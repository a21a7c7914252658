"""The port's dense GQA decoder against the reference, on the CPU.

- The four dense configs, ``for_shape``, ``reduced`` and ``param_count``
  equal the reference's.
- Init shapes and types equal, and parameters round-trip bit for bit.
- ``rmsnorm``, ``apply_rope`` and ``mlp_apply`` equal the reference's.
- ``gqa_apply`` equals the reference with no cache, the model cache, the
  int8 cache, ``qkv_bias`` (random biases) and a sliding window >= T: prefill
  (through ``gqa_flash_attention``, whose CPU path is the kernel's plain
  version) and one decode step (the plain ``_attend``), output and every
  cache leaf; and a chunk of 4 tokens appended to a written cache (the
  plain ``_attend``).
- Prefill and 4 decode steps on exported parameters, teacher-forced with the
  same tokens, equal the reference for reduced minitron-8b, smollm-135m,
  qwen1.5-32b (random QKV biases) and phi4-mini with H 6, Kh 2 (group 3),
  and with the int8 cache and a window of 8 decoded past the window.
- The window quirk at T > window: the port's prefill equals the reference's
  no-cache forward and differs from its cached prefill, and the port's ring
  holds the positions the reference's does (ROADMAP.md §3).
- The unported families (vlm, encdec) and ``decoder_loss_fn`` raise,
  naming their items; the MoE decoders are ``tests/test_torch_moe.py``'s.

Tolerances: float32 atol = rtol = 1e-4 (measured differences are ~1e-6:
the same arithmetic summed in another order); the int8 cache's values are
compared exactly and its outputs at the same 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ("minitron-8b", "phi4-mini-3.8b", "qwen1.5-32b", "smollm-135m")
VOCAB = 512  # reduced()


def _port_config(jcfg):
    """A reference ModelConfig rebuilt from the port's own dataclasses."""
    fields = dataclasses.asdict(jcfg)
    nested = {"attention": tbase.AttentionConfig, "moe": tbase.MoEConfig,
              "ssm": tbase.SSMConfig}
    for key, cls in nested.items():
        if fields[key] is not None:
            fields[key] = cls(**fields[key])
    return tbase.ModelConfig(**fields)


def _with_attention(jcfg, **kw):
    return jcfg.replace(attention=dataclasses.replace(jcfg.attention, **kw))


def _close(got, want, what=""):
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL,
                               err_msg=what)


def _export(tree):
    return interop.params_from_jax(jax.tree.map(np.asarray, tree))


def _random_biases(jparams, seed):
    """The reference initializes QKV biases to 0; random ones exercise them."""
    rng = np.random.default_rng(seed)
    attn = dict(jparams["layers"]["attn"])
    for name in ("b_q", "b_k", "b_v"):
        attn[name] = jnp.asarray(0.5 * rng.normal(size=attn[name].shape), attn[name].dtype)
    return {**jparams, "layers": {**jparams["layers"], "attn": attn}}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("size", ["full", "reduced", "long_500k"])
def test_dense_config_equals_reference(arch, size):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if size == "reduced":
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    elif size == "long_500k":
        jcfg = jconfigs.for_shape(jcfg, jconfigs.INPUT_SHAPES["long_500k"])
        tcfg = tconfigs.for_shape(tcfg, tconfigs.INPUT_SHAPES["long_500k"])
        assert tcfg.attention.sliding_window == tconfigs.LONG_CTX_WINDOW == 4096
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ["rwkv6-7b", *DENSE, "deepseek-v2-236b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("shape", sorted(jconfigs.INPUT_SHAPES))
def test_for_shape_equals_reference(arch, shape):
    jcfg = jconfigs.for_shape(jconfigs.get_config(arch), jconfigs.INPUT_SHAPES[shape])
    tcfg = tconfigs.for_shape(tconfigs.get_config(arch), tconfigs.INPUT_SHAPES[shape])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tconfigs.NATIVE_LONG_CTX_FAMILIES == jconfigs.NATIVE_LONG_CTX_FAMILIES


def test_minitron_8b_has_9_9_billion_parameters():
    cfg = tconfigs.get_config("minitron-8b")
    assert cfg.param_count() == 9_882_042_368
    assert (cfg.attention.num_heads, cfg.attention.num_kv_heads, cfg.attention.head_dim) == (
        32, 8, 128)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def minitron(request):
    jcfg = jconfigs.reduced(jconfigs.get_config("minitron-8b")).replace(dtype=request.param)
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0))
    return jcfg, jparams


def test_init_shapes_and_types_equal_reference(minitron):
    jcfg, jparams = minitron
    mine = build_model(_port_config(jcfg)).init(torch.Generator().manual_seed(0))
    flat_ref = _export(jparams)
    assert {n: (tuple(t.shape), t.dtype) for n, t in mine.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in flat_ref.items()}
    # fan-in scaled truncated normals: each drawn leaf's std within 10% of the reference's
    for name in ("embed", "lm_head", "layers.attn.w_q", "layers.attn.w_o", "layers.mlp.w_up",
                 "layers.mlp.w_down"):
        got, want = float(mine[name].float().std()), float(flat_ref[name].float().std())
        assert abs(got - want) < 0.1 * want, name
    for name in ("layers.ln1.scale", "layers.ln2.scale", "final_norm.scale"):
        assert torch.equal(mine[name], flat_ref[name]), name


def test_parameters_round_trip_exactly(minitron):
    _, jparams = minitron
    want = jax.tree.map(np.asarray, jparams)
    back = interop.params_to_jax(_export(jparams))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_qkv_bias_init_equals_reference():
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen1.5-32b"))
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0))
    mine = build_model(_port_config(jcfg)).init(torch.Generator().manual_seed(0))
    for name in ("b_q", "b_k", "b_v"):
        ref = _export(jparams)[f"layers.attn.{name}"]
        assert mine[f"layers.attn.{name}"].shape == ref.shape and not bool(ref.any())


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_and_mlp_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7))
    jx, tx = jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))
    tol = TOL if dtype == "float32" else dict(atol=5e-2, rtol=5e-2)

    scale = rng.normal(size=32).astype(np.float32)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale, dtype)}, jx, 1e-5)
    got = common.rmsnorm({"scale": torch.as_tensor(scale).to(tx.dtype)}, tx, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)

    for theta in (10000.0, 500000.0):
        for xs, jxs in ((tx, jx), (tx[:, :, 0], jx[:, :, 0])):  # with and without a head axis
            want = jcommon.apply_rope(jxs, jnp.asarray(pos, jnp.int32), theta)
            got = common.apply_rope(xs, torch.as_tensor(pos), theta)
            assert got.dtype == xs.dtype
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(common.rope_frequencies(32, 10000.0).numpy(),
                               np.asarray(jcommon.rope_frequencies(32, 10000.0)), rtol=1e-6)

    h = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = {name: (0.3 * rng.normal(size=shape)).astype(np.float32)
         for name, shape in (("w_up", (16, 40)), ("w_down", (40, 16)), ("w_gate", (16, 40)))}
    for gated in (True, False):
        for act in ("silu", "gelu", "relu", "relu2"):
            ws = {k: v for k, v in w.items() if gated or k != "w_gate"}
            want = jcommon.mlp_apply({k: jnp.asarray(v, dtype) for k, v in ws.items()},
                                     jnp.asarray(h, dtype), act=act)
            got = common.mlp_apply({k: torch.as_tensor(v).to(tx.dtype) for k, v in ws.items()},
                                   torch.as_tensor(h).to(tx.dtype), act=act)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       **tol, err_msg=f"{act} gated={gated}")


# ---------------------------------------------------------------------------
# gqa_apply
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "plain": {},
    "qkv_bias": dict(qkv_bias=True),
    "window_ge_t": dict(sliding_window=12),
    "int8": dict(cache_quant="int8"),
    "group3": dict(num_heads=6, num_kv_heads=2),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("cached", [False, True])
def test_gqa_apply_matches_reference(case, cached):
    jcfg = _with_attention(jconfigs.reduced(jconfigs.get_config("minitron-8b")),
                           **ATTN_CASES[case]).attention
    tcfg = tbase.AttentionConfig(**dataclasses.asdict(jcfg))
    jp = jattention.init(jax.random.PRNGKey(1), 128, jcfg, jnp.float32)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(2)
        jp = {**jp, **{n: jnp.asarray(rng.normal(size=jp[n].shape), jnp.float32)
                       for n in ("b_q", "b_k", "b_v")}}
    tp = _export(jp)
    rng = np.random.default_rng(3)
    b, t = 2, 9
    x = rng.normal(size=(b, t, 128)).astype(np.float32)
    pos = np.tile(np.arange(t), (b, 1))
    jcache = jattention.init_cache(jcfg, b, 16, jnp.float32) if cached else None
    tcache = tattention.init_cache(tcfg, b, 16, torch.float32, "cpu") if cached else None
    apply = jax.jit(jattention.apply, static_argnums=1)
    want, jcache2 = apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos, jnp.int32), cache=jcache)
    got, tcache2 = tattention.apply(tp, tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                                    cache=tcache, prefill=True)
    _close(got, want, "prefill out")
    if not cached:
        assert tcache2 is None
        return
    assert set(tcache2) == set(jcache2)
    for name in jcache2:
        want_leaf = np.asarray(jcache2[name])
        if want_leaf.dtype.kind in "iu":  # int8 values and positions: exact
            assert str(tcache2[name].dtype).split(".")[-1] == str(want_leaf.dtype), name
            np.testing.assert_array_equal(tcache2[name].numpy(), want_leaf, err_msg=name)
        else:
            _close(tcache2[name], want_leaf, f"prefill cache {name}")
    # the cache passed in is left as it was
    assert bool((tcache["pos_ids"] == -1).all())

    x1 = rng.normal(size=(b, 1, 128)).astype(np.float32)
    p1 = np.full((b, 1), t)
    want, jcache3 = apply(jp, jcfg, jnp.asarray(x1), jnp.asarray(p1, jnp.int32), cache=jcache2)
    got, tcache3 = tattention.apply(tp, tcfg, torch.as_tensor(x1), torch.as_tensor(p1),
                                    cache=tcache2)
    _close(got, want, "decode out")
    np.testing.assert_array_equal(tcache3["pos_ids"].numpy(), np.asarray(jcache3["pos_ids"]))


def test_gqa_apply_noncausal_matches_reference():
    """``causal=False`` (the reference's encoder form): prefill over the
    prompt without a mask, then a decode step over every written slot."""
    jcfg = jconfigs.reduced(jconfigs.get_config("minitron-8b")).attention
    tcfg = tbase.AttentionConfig(**dataclasses.asdict(jcfg))
    jp = jattention.init(jax.random.PRNGKey(4), 128, jcfg, jnp.float32)
    tp = _export(jp)
    rng = np.random.default_rng(6)
    b, t = 2, 7
    x = rng.normal(size=(b, t, 128)).astype(np.float32)
    pos = np.tile(np.arange(t), (b, 1))
    jcache = jattention.init_cache(jcfg, b, 10, jnp.float32)
    tcache = tattention.init_cache(tcfg, b, 10, torch.float32, "cpu")
    for cache_j, cache_t in ((None, None), (jcache, tcache)):
        want, jc = jattention.gqa_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                        cache=cache_j, causal=False)
        got, tc = tattention.gqa_apply(tp, tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                                       cache=cache_t, causal=False, prefill=True)
        _close(got, want, "prefill out")
    x1 = rng.normal(size=(b, 1, 128)).astype(np.float32)
    want, _ = jattention.gqa_apply(jp, jcfg, jnp.asarray(x1), jnp.full((b, 1), t, jnp.int32),
                                   cache=jc, causal=False)
    got, _ = tattention.gqa_apply(tp, tcfg, torch.as_tensor(x1), torch.full((b, 1), t),
                                  cache=tc, causal=False)
    _close(got, want, "decode out")


def test_prefill_precondition_checked_on_cpu():
    cfg = tconfigs.reduced(tconfigs.get_config("minitron-8b")).attention
    p = tattention.init(torch.Generator().manual_seed(0), 128, cfg, torch.float32)
    x = torch.randn(1, 4, 128)
    cache = tattention.init_cache(cfg, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="prefill"):
        tattention.apply(p, cfg, x, torch.arange(3, 7)[None], cache=cache, prefill=True)
    _, full = tattention.apply(p, cfg, x, torch.arange(4)[None], cache=cache, prefill=True)
    with pytest.raises(ValueError, match="prefill"):  # a second prefill into a written cache
        tattention.apply(p, cfg, x, torch.arange(4)[None], cache=full, prefill=True)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_append_matches_reference(case, monkeypatch):
    """T > 1 tokens appended to a written cache (a chunked prefill; no
    ``prefill`` flag) attend over the cache through the plain ``_attend``,
    as the reference does; only the first chunk goes through the kernel's
    wrapper."""
    jcfg = _with_attention(jconfigs.reduced(jconfigs.get_config("minitron-8b")),
                           **ATTN_CASES[case]).attention
    tcfg = tbase.AttentionConfig(**dataclasses.asdict(jcfg))
    jp = jattention.init(jax.random.PRNGKey(5), 128, jcfg, jnp.float32)
    tp = _export(jp)
    rng = np.random.default_rng(7)
    b, t0, t1 = 2, 5, 4
    x = rng.normal(size=(b, t0 + t1, 128)).astype(np.float32)
    pos = np.tile(np.arange(t0 + t1), (b, 1))
    calls = []
    wrapper = flash_ops.gqa_flash_attention
    monkeypatch.setattr(flash_ops, "gqa_flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or wrapper(*a, **kw))
    jc = jattention.init_cache(jcfg, b, 16, jnp.float32)
    tc = tattention.init_cache(tcfg, b, 16, torch.float32, "cpu")
    for lo, hi, prefill in ((0, t0, True), (t0, t0 + t1, False)):
        want, jc = jattention.apply(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                                    jnp.asarray(pos[:, lo:hi], jnp.int32), cache=jc)
        got, tc = tattention.apply(tp, tcfg, torch.as_tensor(x[:, lo:hi]),
                                   torch.as_tensor(pos[:, lo:hi]), cache=tc, prefill=prefill)
        _close(got, want, f"out of tokens {lo}..{hi - 1}")
    assert calls == [t0]
    for name in jc:
        want_leaf = np.asarray(jc[name])
        if want_leaf.dtype.kind in "iu":
            np.testing.assert_array_equal(tc[name].numpy(), want_leaf, err_msg=name)
        else:
            _close(tc[name], want_leaf, f"cache {name}")


def test_cache_bytes_and_int8_layout_equal_reference():
    for quant in ("model", "int8"):
        jcfg = _with_attention(jconfigs.reduced(jconfigs.get_config("minitron-8b")),
                               cache_quant=quant, sliding_window=8).attention
        tcfg = tbase.AttentionConfig(**dataclasses.asdict(jcfg))
        want = jattention.init_cache(jcfg, 2, 20, jnp.bfloat16)
        got = tattention.init_cache(tcfg, 2, 20, torch.bfloat16, "cpu")
        assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1]) for n, t in got.items()} == {
            n: (t.shape, str(t.dtype)) for n, t in want.items()}
        assert tattention.cache_bytes(tcfg, 2, 20) == jattention.cache_bytes(jcfg, 2, 20)
    x = np.random.default_rng(0).normal(size=(2, 5, 2, 32)).astype(np.float32)
    jq, js = jattention._quantize_kv(jnp.asarray(x))
    tq, ts = tattention._quantize_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tattention._dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jattention._dequantize_kv(jq, js)))


# ---------------------------------------------------------------------------
# the whole decoder: prefill and decode
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "minitron": ("minitron-8b", {}),
    "smollm": ("smollm-135m", {}),
    "qwen_qkv_bias": ("qwen1.5-32b", {}),
    "phi4_group3": ("phi4-mini-3.8b", dict(num_heads=6, num_kv_heads=2)),
    "minitron_int8": ("minitron-8b", dict(cache_quant="int8")),
    "minitron_window8": ("minitron-8b", dict(sliding_window=8)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_prefill_and_decode_match_reference(case):
    """Prefill of a 6-token prompt, then 4 decode steps teacher-forced with the
    same tokens in both packages (with a window of 8 the decode runs past
    the window); logits and every cache leaf at each step."""
    arch, attn = MODEL_CASES[case]
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jcfg = _with_attention(jcfg, **attn) if attn else jcfg
    jmodel, tmodel = jbuild_model(jcfg), build_model(_port_config(jcfg))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    if jcfg.attention.qkv_bias:
        jparams = _random_biases(jparams, 1)
    tparams = _export(jparams)
    rng = np.random.default_rng(4)
    b, t, steps = 2, 6, 4
    tokens = rng.integers(0, VOCAB, (b, t))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                              jmodel.init_cache(b, t + steps))
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)},
                                     tmodel.init_cache(b, t + steps, "cpu"))
    assert tlogits.shape == (b, 1, VOCAB) and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, "prefill logits")
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(steps + 1):
        flat = _export(jcache)
        assert set(tcache) == set(flat)
        for name in flat:
            if flat[name].dtype in (torch.int8, torch.int32):
                assert torch.equal(tcache[name], flat[name]), (step, name)
            else:
                _close(tcache[name], flat[name].numpy(), f"step {step} cache {name}")
        if step == steps:
            break
        token = rng.integers(0, VOCAB, b)
        pos = t + step
        jlogits, jcache = jdecode(jparams, jnp.asarray(token, jnp.int32),
                                  jnp.full((b,), pos, jnp.int32), jcache)
        tlogits, tcache = tmodel.decode_step(tparams, torch.as_tensor(token),
                                             torch.full((b,), pos), tcache)
        _close(tlogits, jlogits, f"decode {step} logits")


def test_window_quirk_prefill_longer_than_window():
    """T = 16 > window = 8.  The reference writes the whole prompt into the
    8-slot ring and then attends over the ring, so early queries read keys
    that later positions overwrote; the port's prefill attends over the
    prompt with the window mask, which is the reference's own no-cache
    forward.  The ring left behind holds positions 8..15 in both."""
    jcfg = _with_attention(jconfigs.reduced(jconfigs.get_config("minitron-8b")),
                           sliding_window=8)
    jmodel, tmodel = jbuild_model(jcfg), build_model(_port_config(jcfg))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = _export(jparams)
    b, t = 2, 16
    tokens = np.random.default_rng(5).integers(0, VOCAB, (b, t))
    jtok = jnp.asarray(tokens, jnp.int32)

    def no_cache_forward(params, tok):
        x = jtf._decoder_embed(params, jcfg, tok)
        positions = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None], (b, t))
        x, _, _ = jtf._decoder_trunk(params, jcfg, x, positions, None)
        return jtf.decoder_logits(params, jcfg, x[:, -1:])

    want = jax.jit(no_cache_forward)(jparams, jtok)
    quirk, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jtok}, jmodel.init_cache(b, t + 4))
    got, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)},
                                 tmodel.init_cache(b, t + 4, "cpu"))
    _close(got, want, "prefill logits vs the reference's no-cache forward")
    assert float(np.abs(got.numpy() - np.asarray(quirk)).max()) > 0.1
    assert tcache["main.pos_ids"].shape == (2, b, 8)
    np.testing.assert_array_equal(tcache["main.pos_ids"].numpy(),
                                  np.asarray(jcache["main"]["pos_ids"]))
    np.testing.assert_array_equal(tcache["main.pos_ids"][0, 0].numpy(), np.arange(8, 16))
    # layer 0's keys come from the embeddings alone, so they agree too
    _close(tcache["main.k"][0], np.asarray(jcache["main"]["k"][0]), "layer 0 ring keys")


def test_prefill_on_cpu_counts_no_kernel_launch():
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config("smollm-135m")))
    params = tmodel.init(torch.Generator().manual_seed(0))
    flash_ops.launches.reset()
    tmodel.prefill(params, tmodel.make_batch(torch.Generator().manual_seed(1), 2, 8),
                   tmodel.init_cache(2, 10, "cpu"))
    assert flash_ops.launches.count == 0


# ---------------------------------------------------------------------------
# what is not ported
# ---------------------------------------------------------------------------


def test_unported_paths_raise_naming_their_items():
    cfg = tconfigs.reduced(tconfigs.get_config("minitron-8b"))
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match="item 18"):
        model.loss_fn({}, {})
    with pytest.raises(NotImplementedError, match="item 16"):
        ttf._decoder_embed({}, cfg, torch.zeros(1, 2, dtype=torch.int64),
                           patches=torch.zeros(1, 2, 4))
    vlm_cfg = _port_config(jconfigs.reduced(jconfigs.get_config("internvl2-2b")))
    with pytest.raises(NotImplementedError, match="item 16"):
        ttf.decoder_init(torch.Generator(), vlm_cfg)
    for arch in ("internvl2-2b", "seamless-m4t-medium"):
        with pytest.raises(NotImplementedError, match="item 16"):
            build_model(_port_config(jconfigs.reduced(jconfigs.get_config(arch))))

"""The port's MoE decoders (``models/moe.py``, MLA in ``models/attention.py``,
``first_layers`` in ``models/transformer.py``) against the reference, on the
CPU.

- ``moe.apply`` on parameters exported from the reference's ``moe.init``,
  routing groups 1 and 2, shared experts 0 and 1, capacity factor 64 (no
  drops) and 0.25 (drops), output and aux; a bf16 case; a zeroed router
  (every entry ties) with and without drops.  The dropped assignments equal
  a numpy loop over the reference's rule, on the reference's own top-k.
- ``_top_k`` equals ``jax.lax.top_k`` on rows full of ties; ``capacity``
  and ``_num_groups`` equal the reference's; ``apply_dense_reference``
  equals the reference's.
- ``mla_apply`` uncached and cached (prefill, then a decode step), expanded
  and absorbed, with and without a sliding window and a query rank, output
  and every cache leaf.
- Reduced deepseek-v2-236b (MLA, a dense first layer, shared experts) and
  qwen3-moe-235b-a22b (GQA): prefill and teacher-forced decode logits and
  caches, greedy tokens through ``make_generate_fn``, the scanned decode
  equal to the python loop, ``serve_fleet`` bit-identical to sequential,
  the parameter tree round-trip, init shapes, cache layout and full
  ``param_count``.

Tolerances: float32 atol 5e-5 / rtol 1e-4 (the same arithmetic summed in
another order); bf16 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

TOL = dict(atol=5e-5, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
MOE_ARCHS = ("deepseek-v2-236b", "qwen3-moe-235b-a22b")
VOCAB = 512  # reduced()


def _export(tree):
    return interop.params_from_jax(jax.tree.map(np.asarray, tree))


def _close(got, want, what="", tol=TOL):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **tol,
                               err_msg=what)


def _moe_cfgs(e=4, k=2, d=16, f=32, shared=0, groups=1, cf=8.0):
    kw = dict(num_experts=e, top_k=k, expert_ff=f, num_shared=shared, capacity_factor=cf,
              router_groups=groups)
    return jbase.MoEConfig(**kw), tbase.MoEConfig(**kw)


def _moe_params(jcfg, d=16, dtype=jnp.float32, seed=0):
    jp = jmoe.init(jax.random.PRNGKey(seed), d, jcfg, dtype)
    return jp, _export(jp)


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# ---------------------------------------------------------------------------
# moe.apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [64.0, 0.25])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_matches_reference(groups, shared, cf):
    jcfg, tcfg = _moe_cfgs(shared=shared, groups=groups, cf=cf)
    jp, tp = _moe_params(jcfg)
    x = _x((2, 32, 16), 1)  # 64 tokens: C = 8 drops at cf 0.25 (the minimum capacity)
    want, want_aux = jax.jit(jmoe.apply, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    got, got_aux = tmoe.apply(tp, tcfg, torch.as_tensor(x))
    _close(got, want, "out")
    _close(got_aux, want_aux, "aux")
    if cf < 1:  # the drops matter: without them the output is another
        full, _ = tmoe.apply(tp, dataclasses.replace(tcfg, capacity_factor=64.0),
                             torch.as_tensor(x))
        assert float((full - got).abs().max()) > 1e-2
        assert float(tmoe.dropped_share(tp, tcfg, torch.as_tensor(x))) > 0


@pytest.mark.parametrize("cf", [64.0, 0.25])
def test_moe_apply_bf16_matches_reference(cf):
    jcfg, tcfg = _moe_cfgs(shared=1, cf=cf)
    jp, tp = _moe_params(jcfg, dtype=jnp.bfloat16)
    x = _x((2, 8, 16), 2)
    want, want_aux = jax.jit(jmoe.apply, static_argnums=1)(jp, jcfg,
                                                          jnp.asarray(x, jnp.bfloat16))
    got, got_aux = tmoe.apply(tp, tcfg, torch.as_tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, "out", BF16_TOL)
    _close(got_aux, want_aux, "aux", BF16_TOL)


def _dropped_oracle(experts: np.ndarray, e: int, c: int) -> np.ndarray:
    """The reference's rule as a loop: assignments in token-major,
    choice-minor order; an assignment is dropped when its expert already
    holds C earlier assignments (dropped ones counted too)."""
    g, ng, k = experts.shape
    dropped = np.zeros((g, ng * k), bool)
    for gi in range(g):
        count = np.zeros(e, np.int64)
        for a, ex in enumerate(experts[gi].reshape(-1)):
            dropped[gi, a] = count[ex] >= c
            count[ex] += 1
    return dropped


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [0.25, 0.5, 1.25])
def test_dropped_assignments_equal_the_reference_rule(groups, cf):
    jcfg, tcfg = _moe_cfgs(e=4, k=2, groups=groups, cf=cf)
    jp, tp = _moe_params(jcfg, seed=3)
    x = _x((2, 16, 16), 4)
    n = 32
    g = jmoe._num_groups(jcfg, n)
    c = jmoe.capacity(jcfg, n // g)
    logits = jnp.asarray(x).reshape(g, n // g, 16) @ jp["router"]
    _, jexperts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    want = _dropped_oracle(np.asarray(jexperts), 4, c)
    dest = tmoe._slots(torch.as_tensor(np.array(jexperts), dtype=torch.int64), 4, c)
    np.testing.assert_array_equal((dest == 4 * c).numpy(), want)
    for row in dest:  # a group's kept slots are unique
        kept = row[row < 4 * c]
        assert kept.unique().numel() == kept.numel()
    share = tmoe.dropped_share(tp, tcfg, torch.as_tensor(x))
    assert float(share) == pytest.approx(want.mean(), abs=1e-7)


@pytest.mark.parametrize("cf", [64.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_match_reference(k, cf):
    """A zeroed router makes every probability 1/E: top-k must take experts
    0 .. k-1 for every token (``jax.lax.top_k``'s lower index first)."""
    jcfg, tcfg = _moe_cfgs(k=k, shared=1, cf=cf)
    jp, _ = _moe_params(jcfg, seed=5)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = _export(jp)
    x = _x((4, 16, 16), 6)
    want, want_aux = jax.jit(jmoe.apply, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    got, got_aux = tmoe.apply(tp, tcfg, torch.as_tensor(x))
    _close(got, want, "out")
    _close(got_aux, want_aux, "aux")


@pytest.mark.parametrize("seed", range(3))
def test_top_k_takes_the_lower_index_among_ties(seed):
    rng = np.random.default_rng(seed)
    probs = rng.integers(0, 3, size=(5, 7, 16)).astype(np.float32)  # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 6)
    got_v, got_i = tmoe._top_k(torch.as_tensor(probs), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("tokens,groups", [(1, 16), (24, 16), (32, 16), (4096, 1), (4, 1),
                                           (1000, 8), (7, 3)])
def test_capacity_and_groups_equal_reference(tokens, groups):
    for e, k, cf in ((160, 6, 1.25), (128, 8, 1.25), (4, 2, 0.25), (8, 2, 64.0)):
        jcfg, tcfg = _moe_cfgs(e=e, k=k, groups=groups, cf=cf)
        assert tmoe._num_groups(tcfg, tokens) == jmoe._num_groups(jcfg, tokens)
        ng = tokens // jmoe._num_groups(jcfg, tokens)
        assert tmoe.capacity(tcfg, ng) == jmoe.capacity(jcfg, ng)


@pytest.mark.parametrize("shared", [0, 1])
def test_dense_reference_matches_reference(shared):
    jcfg, tcfg = _moe_cfgs(shared=shared)
    jp, tp = _moe_params(jcfg, seed=7)
    x = _x((2, 8, 16), 8)
    want, want_aux = jax.jit(jmoe.apply_dense_reference, static_argnums=1)(jp, jcfg,
                                                                          jnp.asarray(x))
    got, got_aux = tmoe.apply_dense_reference(tp, tcfg, torch.as_tensor(x))
    _close(got, want, "out")
    _close(got_aux, want_aux, "aux")
    # and the grouped dispatch, without drops, against it
    grouped, _ = tmoe.apply(tp, tcfg, torch.as_tensor(x))
    torch.testing.assert_close(grouped, got, **TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_CASES = {
    "expanded": {},
    "absorbed": dict(mla_absorb=True),
    "window": dict(sliding_window=6),
    "absorbed_window": dict(mla_absorb=True, sliding_window=6),
    "no_q_rank": dict(q_lora_rank=0),
}


def _mla_cfgs(**kw):
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("deepseek-v2-236b")).attention, **kw)
    return jcfg, tbase.AttentionConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("case", sorted(MLA_CASES))
@pytest.mark.parametrize("cached", [False, True])
def test_mla_apply_matches_reference(case, cached):
    """A 5-token prompt (prefill), then with a cache two decode steps (past
    the window of 6 in the window cases); output and every cache leaf."""
    jcfg, tcfg = _mla_cfgs(**MLA_CASES[case])
    jp = jattention.init(jax.random.PRNGKey(1), 128, jcfg, jnp.float32)
    tp = _export(jp)
    assert set(tp) == set(tattention.init(torch.Generator().manual_seed(0), 128, tcfg,
                                          torch.float32))
    b, t = 2, 5
    x = _x((b, t + 2, 128), 9)
    pos = np.tile(np.arange(t + 2), (b, 1))
    jcache = jattention.init_cache(jcfg, b, 10, jnp.float32) if cached else None
    tcache = tattention.init_cache(tcfg, b, 10, torch.float32, "cpu") if cached else None
    apply = jax.jit(jattention.apply, static_argnums=1)
    for lo, hi in ((0, t), (t, t + 1), (t + 1, t + 2)):
        if lo and not cached:
            break
        want, jcache = apply(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                             jnp.asarray(pos[:, lo:hi], jnp.int32), cache=jcache)
        got, tcache = tattention.apply(tp, tcfg, torch.as_tensor(x[:, lo:hi]),
                                       torch.as_tensor(pos[:, lo:hi]), cache=tcache,
                                       prefill=lo == 0)
        _close(got, want, f"out of tokens {lo}..{hi - 1}")
        if not cached:
            assert tcache is None
            continue
        assert set(tcache) == set(jcache)
        for name in jcache:
            if name == "pos_ids":
                np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]))
            else:
                _close(tcache[name], jcache[name], f"cache {name} after {hi}")


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_window_prefill_longer_than_window(absorb):
    """T = 10 > window = 6: the port's prefill attends over the prompt with
    the window mask, which is the reference's no-cache forward (its cached
    prefill writes the whole prompt into the 6-slot ring first, the quirk
    of ROADMAP.md §3); the ring left behind holds the reference's
    positions and latents."""
    jcfg, tcfg = _mla_cfgs(sliding_window=6, mla_absorb=absorb)
    jp = jattention.init(jax.random.PRNGKey(2), 128, jcfg, jnp.float32)
    tp = _export(jp)
    b, t = 2, 10
    x = _x((b, t, 128), 12)
    pos = np.tile(np.arange(t), (b, 1))
    want, _ = jattention.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos, jnp.int32))
    _, jcache = jattention.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                     cache=jattention.init_cache(jcfg, b, 14, jnp.float32))
    got, tcache = tattention.mla_apply(tp, tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                                       cache=tattention.init_cache(tcfg, b, 14, torch.float32,
                                                                   "cpu"), prefill=True)
    _close(got, want, "prefill out vs the reference's no-cache forward")
    np.testing.assert_array_equal(tcache["pos_ids"].numpy(), np.asarray(jcache["pos_ids"]))
    np.testing.assert_array_equal(tcache["pos_ids"][0].numpy(), [6, 7, 8, 9, 4, 5])
    for name in ("c_kv", "k_rope"):
        _close(tcache[name], jcache[name], f"ring {name}")


def test_mla_absorbed_equals_expanded_decode():
    """The port's counterpart of the reference's absorbed-decode test: the
    same parameters and cache, one decode step both ways."""
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-v2-236b"))
    cfg_abs = cfg.replace(attention=dataclasses.replace(cfg.attention, mla_absorb=True))
    m, m_abs = build_model(cfg), build_model(cfg_abs)
    params = m.init(torch.Generator().manual_seed(0))
    batch = m.make_batch(torch.Generator().manual_seed(1), 2, 8)
    _, cache = m.prefill(params, batch, m.init_cache(2, 12, "cpu"))
    tok, pos = torch.tensor([3, 5]), torch.full((2,), 8)
    logits1, c1 = m.decode_step(params, tok, pos, cache)
    logits2, c2 = m_abs.decode_step(params, tok, pos, cache)
    torch.testing.assert_close(logits1, logits2, atol=2e-3, rtol=2e-3)
    for name in c1:
        torch.testing.assert_close(c1[name], c2[name], **TOL)


def test_mla_cache_layout_and_bytes_equal_reference():
    for window in (None, 8):
        jcfg, tcfg = _mla_cfgs(sliding_window=window)
        want = jattention.init_cache(jcfg, 2, 20, jnp.bfloat16)
        got = tattention.init_cache(tcfg, 2, 20, torch.bfloat16, "cpu")
        assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1]) for n, t in got.items()} == {
            n: (t.shape, str(t.dtype)) for n, t in want.items()}
        assert tattention.cache_bytes(tcfg, 2, 20) == jattention.cache_bytes(jcfg, 2, 20)
    full = tconfigs.get_config("deepseek-v2-236b").attention
    assert tattention.cache_bytes(full, 4, 1040) == 4 * 1040 * (512 + 64) * 2


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_models(request):
    """(reference model, params; port model, params) of a reduced MoE arch,
    the port's parameters exported from the reference's."""
    jcfg = jconfigs.reduced(jconfigs.get_config(request.param))
    jmodel = jbuild_model(jcfg)
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config(request.param)))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, jparams, tmodel, _export(jparams)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_equals_reference(arch, size):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if size == "reduced":
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_full_param_counts():
    assert tconfigs.get_config("deepseek-v2-236b").param_count() == 235_741_306_880
    assert tconfigs.get_config("qwen3-moe-235b-a22b").param_count() == 235_093_606_400


def test_init_shapes_and_types_equal_reference(moe_models):
    _, jparams, tmodel, tparams = moe_models
    mine = tmodel.init(torch.Generator().manual_seed(0))
    assert {n: (tuple(t.shape), t.dtype) for n, t in mine.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in tparams.items()}
    assert mine["layers.moe.router"].dtype == torch.float32
    for name in ("embed", "layers.moe.w_gate", "layers.moe.w_down", "layers.attn.w_o"):
        got, want = float(mine[name].float().std()), float(tparams[name].float().std())
        assert abs(got - want) < 0.1 * want, name


def test_parameters_round_trip_exactly(moe_models):
    _, jparams, _, tparams = moe_models
    want = jax.tree.map(np.asarray, jparams)
    back = interop.params_to_jax(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_bf16_moe_tree_round_trips_exactly():
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-v2-236b")).replace(dtype="bfloat16")
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(2))
    flat = _export(jparams)
    assert flat["layers.moe.router"].dtype == torch.float32
    assert flat["layers.moe.shared.w_gate"].dtype == torch.bfloat16
    assert flat["first_layers.mlp.w_up"].shape == (1, 128, 128)  # dense_ff of reduced()
    back = interop.params_to_jax(flat)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray,
                                                                            jparams))):
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_cache_layout_equals_reference(moe_models):
    jmodel, _, tmodel, _ = moe_models
    want = _export(jmodel.init_cache(2, 9))
    got = tmodel.init_cache(2, 9, "cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in want.items()}


@pytest.mark.parametrize("arch,absorb", [("deepseek-v2-236b", False),
                                         ("deepseek-v2-236b", True),
                                         ("qwen3-moe-235b-a22b", False)])
def test_prefill_and_decode_match_reference(arch, absorb):
    """Prefill of a 6-token prompt, then 4 decode steps teacher-forced with the
    same tokens in both packages (deepseek also with ``mla_absorb``); logits
    and every cache leaf at each step."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jcfg = jcfg.replace(attention=dataclasses.replace(jcfg.attention, mla_absorb=absorb))
    jmodel = jbuild_model(jcfg)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    tmodel = build_model(tcfg.replace(attention=dataclasses.replace(tcfg.attention,
                                                                    mla_absorb=absorb)))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = _export(jparams)
    rng = np.random.default_rng(4)
    b, t, n_steps = 2, 6, 4
    tokens = rng.integers(0, VOCAB, (b, t))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                              jmodel.init_cache(b, t + n_steps))
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)},
                                     tmodel.init_cache(b, t + n_steps, "cpu"))
    assert tlogits.shape == (b, 1, VOCAB) and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, "prefill logits")
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(n_steps + 1):
        flat = _export(jcache)
        assert set(tcache) == set(flat)
        for name in flat:
            if flat[name].dtype == torch.int32:
                assert torch.equal(tcache[name], flat[name]), (step, name)
            else:
                _close(tcache[name], flat[name].numpy(), f"step {step} cache {name}")
        if step == n_steps:
            break
        token = rng.integers(0, VOCAB, b)
        pos = t + step
        jlogits, jcache = jdecode(jparams, jnp.asarray(token, jnp.int32),
                                  jnp.full((b,), pos, jnp.int32), jcache)
        tlogits, tcache = tmodel.decode_step(tparams, torch.as_tensor(token),
                                             torch.full((b,), pos), tcache)
        _close(tlogits, jlogits, f"decode {step} logits")


def test_greedy_tokens_equal_reference(moe_models):
    """The port's ``make_generate_fn`` (prefill, then the scanned decode run
    eagerly on the CPU) against the reference's, token for token up to the
    first step whose top-2 logit margin is within twice the tolerance."""
    jmodel, jparams, tmodel, tparams = moe_models
    b, s, gen = 2, 8, 6
    tokens = np.random.default_rng(11).integers(0, VOCAB, (b, s))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jtoks, _ = jax.jit(jsteps.make_generate_fn(jmodel, gen))(jparams, jbatch,
                                                            jmodel.init_cache(b, s + gen))
    jtoks = np.asarray(jtoks)
    flash_ops.launches.reset()
    ttoks, _ = steps.make_generate_fn(tmodel, gen)(tparams, {"tokens": torch.as_tensor(tokens)},
                                                  tmodel.init_cache(b, s + gen, "cpu"))
    assert flash_ops.launches.count == 0  # CPU tensors: the plain version
    logits, cache = jax.jit(jmodel.prefill)(jparams, jbatch, jmodel.init_cache(b, s + gen))
    decode = jax.jit(jmodel.decode_step)
    upto = np.full(b, gen)
    for step in range(gen):
        if step:
            logits, cache = decode(jparams, jnp.asarray(jtoks[:, step - 1]),
                                   jnp.full((b,), s + step - 1, jnp.int32), cache)
        want = np.asarray(logits)[:, -1]
        top2 = np.sort(want, axis=-1)[:, -2:]
        limit = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(want).max(axis=-1))
        upto = np.where((top2[:, 1] - top2[:, 0] <= limit) & (upto == gen), step + 1, upto)
    for row in range(b):
        assert np.array_equal(ttoks[row, :upto[row]].numpy(), jtoks[row, :upto[row]]), row


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_scanned_decode_equals_python_loop(arch):
    """``serve_batch``'s two decodes on the reduced model it draws: equal
    tokens and final caches, bit for bit, and the first and main caches'
    positions."""
    kw = dict(batch=2, prompt_len=7, gen_tokens=4, device="cpu")
    scan = serve.serve_batch(arch, decode_impl="scan", **kw)
    loop = serve.serve_batch(arch, decode_impl="python", **kw)
    assert torch.equal(scan["tokens"], loop["tokens"])
    assert set(scan["cache"]) == set(loop["cache"])
    for name in scan["cache"]:
        assert torch.equal(scan["cache"][name], loop["cache"][name]), name
    want_pos = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, -1], dtype=torch.int32)
    for name in ("first.pos_ids", "main.pos_ids"):
        if name in scan["cache"]:
            assert bool((scan["cache"][name] == want_pos).all()), name
    assert ("first.pos_ids" in scan["cache"]) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_model_equals_serve_batch(arch):
    """``serve_model`` on the built config is what ``serve_batch`` runs."""
    kw = dict(batch=2, prompt_len=5, gen_tokens=3, device="cpu")
    model = build_model(tconfigs.reduced(tconfigs.get_config(arch)))
    a = serve.serve_model(model, **kw)
    b = serve.serve_batch(arch, **kw)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["params_gb"] == b["params_gb"]


@pytest.mark.parametrize("order", ["identity", "reversed"])
def test_fleet_bit_identical_to_sequential(moe_models, order):
    """One fleet call == each group served separately on its peer's own
    (separately drawn) parameters, token for token and cache for cache."""
    tmodel = moe_models[2]
    k, gen = 3, 4
    draw = lambda p: tmodel.init(torch.Generator().manual_seed(10 + p))  # noqa: E731
    stacked = ttf.stacked_init(k, draw)
    prompt_gen = torch.Generator().manual_seed(1)
    prompts = ttf.stacked_init(k, lambda _p: tmodel.make_batch(prompt_gen, 2, 8))
    caches = serve.stack_request_caches(tmodel.init_cache(2, 8 + gen, "cpu"), k)
    peer_ids = torch.arange(k) if order == "identity" else torch.arange(k - 1, -1, -1)
    toks, new_caches = serve.make_fleet_generate_fn(tmodel, gen)(stacked, prompts, caches,
                                                                 peer_ids)
    assert toks.shape == (k, 2, gen)
    single = steps.make_generate_fn(tmodel, gen)
    for g, peer in enumerate(peer_ids.tolist()):
        want, want_cache = single(draw(peer), {n: t[g] for n, t in prompts.items()},
                                  tmodel.init_cache(2, 8 + gen, "cpu"))
        assert torch.equal(toks[g], want)
        for name in want_cache:
            assert torch.equal(new_caches[name][g], want_cache[name])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_fleet_runs_the_moe_family(arch):
    out = serve.serve_fleet(arch, num_peers=2, batch=2, prompt_len=6, gen_tokens=3,
                            device="cpu")
    assert out["tokens"].shape == (2, 2, 3)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < VOCAB)).all())

"""The port's scanned decode (``repro_torch.launch.steps.make_decode_scan``) and
its in-place cache writes, on the CPU.

* ``make_decode_scan`` against ``make_decode_loop`` (the python path) from
  the same prefill: tokens and every leaf of the final cache equal
  (``torch.equal``) for the reduced smollm-135m, minitron-8b, minitron-8b
  with a sliding window of 8 whose ring the decode runs past, minitron-8b
  with the int8 KV cache, RWKV6-7B and zamba2-2.7b.  On the CPU the scanned
  decode runs its one step eagerly over its static buffers, writing the
  cache in place; on the card it replays a captured CUDA graph of the step,
  which ``chip_smoke.py`` holds to the python path.
* The scan consumes the cache it is given (returns it, written); the python
  path leaves its input cache as it was.
* ``serve_batch(decode_impl="scan")`` against the reference's
  ``serve_batch`` (its scanned decode) on the same parameters and prompt:
  greedy tokens equal up to the first step whose top-2 logit margin is
  within twice the float32 tolerance (where the argmax may flip), as
  tests/test_torch_serve.py compares generation.
* ``serve_fleet``'s scanned groups against each group served with the
  python loop; ``make_decode_scan(model, 0)`` raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _config(arch, **attention):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    if attention:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, **attention))
    return cfg


MODELS = {
    "smollm": lambda: _config("smollm-135m"),
    "minitron": lambda: _config("minitron-8b"),
    "minitron_window8": lambda: _config("minitron-8b", sliding_window=8),
    "minitron_int8": lambda: _config("minitron-8b", cache_quant="int8"),
    "rwkv6": lambda: _config("rwkv6-7b"),
    "zamba2": lambda: _config("zamba2-2.7b"),
}
B, PROMPT, GEN = 2, 6, 7  # with the window of 8, decode writes positions 6 .. 11


def _prefilled(cfg, seed=0):
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen)
    prompt = model.make_batch(gen, B, PROMPT)
    tok, cache = steps.make_prefill_step(model)(params, prompt,
                                                model.init_cache(B, PROMPT + GEN, "cpu"))
    return model, params, tok, cache


def _copy(cache):
    return {name: t.clone() for name, t in cache.items()}


@pytest.mark.parametrize("case", sorted(MODELS))
def test_decode_scan_equals_decode_loop(case):
    """GEN - 1 = 6 greedy steps both ways from one prefill: tokens and
    every cache leaf bit-equal, the scanned one written into the cache it
    was given."""
    cfg = MODELS[case]()
    model, params, tok, cache = _prefilled(cfg)
    pos = torch.full((B,), PROMPT, dtype=torch.int64)
    kept = _copy(cache)
    want_toks, want_cache = steps.make_decode_loop(model, GEN - 1)(params, cache, tok, pos)
    for name in cache:  # the python path leaves its input as it was
        assert torch.equal(cache[name], kept[name]), name
    tok_in, pos_in = tok.clone(), pos.clone()
    got_toks, got_cache = steps.make_decode_scan(model, GEN - 1)(params, cache, tok, pos)
    assert torch.equal(tok, tok_in) and torch.equal(pos, pos_in)
    assert got_toks.shape == (B, GEN - 1) and got_toks.dtype == torch.int64
    assert torch.equal(got_toks, want_toks)
    assert set(got_cache) == set(want_cache)
    for name in want_cache:
        assert got_cache[name] is cache[name], name  # consumed: written in place
        assert torch.equal(got_cache[name], want_cache[name]), name
    if case == "minitron_window8":  # the ring ran past its 8 slots
        last = PROMPT + GEN - 2
        held = torch.sort(got_cache["main.pos_ids"][:, 0].long(), dim=-1).values
        assert torch.equal(held[0], torch.arange(last - 7, last + 1))


@pytest.mark.parametrize("case", ["minitron_int8", "rwkv6", "zamba2"])
def test_inplace_decode_step_equals_functional(case):
    """One decode step with ``inplace=True`` writes the values the
    functional step returns, into the cache it was given."""
    cfg = MODELS[case]()
    model, params, tok, cache = _prefilled(cfg, seed=1)
    pos = torch.full((B,), PROMPT, dtype=torch.int64)
    with torch.no_grad():
        want_logits, want = model.decode_step(params, tok, pos, cache)
        mine = _copy(cache)
        got_logits, got = model.decode_step(params, tok, pos, mine, inplace=True)
    assert torch.equal(got_logits, want_logits)
    for name in want:
        assert got[name] is mine[name] and torch.equal(got[name], want[name]), name


def test_decode_scan_one_step_and_zero_steps():
    model, params, tok, cache = _prefilled(MODELS["smollm"]())
    pos = torch.full((B,), PROMPT, dtype=torch.int64)
    want, _ = steps.make_decode_loop(model, 1)(params, _copy(cache), tok, pos)
    got, _ = steps.make_decode_scan(model, 1)(params, cache, tok, pos)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="num_steps"):
        steps.make_decode_scan(model, 0)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "smollm-135m"])
def test_serve_batch_scan_matches_reference(arch, monkeypatch):
    """The reference's ``serve_batch`` (decode_impl="scan") and the port's,
    on the reference's parameters and prompt (seed 0), exported."""
    batch, prompt_len, gen = 2, 8, 6
    jmodel = jbuild_model(jconfigs.reduced(jconfigs.get_config(arch)))
    rng = jax.random.PRNGKey(0)
    jparams = jmodel.init(rng)
    jprompt = jmodel.make_batch(rng, batch, prompt_len)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    tprompt = {"tokens": torch.as_tensor(np.array(jprompt["tokens"]), dtype=torch.int64)}
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config(arch)))
    tmodel = dataclasses.replace(tmodel, init=lambda g: tparams,
                                 make_batch=lambda g, b, s: tprompt)
    monkeypatch.setattr(serve, "_model_of", lambda a, use_reduced: tmodel)
    want = np.asarray(jserve.serve_batch(arch, batch=batch, prompt_len=prompt_len,
                                         gen_tokens=gen, decode_impl="scan")["tokens"])
    out = serve.serve_batch(arch, batch=batch, prompt_len=prompt_len, gen_tokens=gen,
                            device="cpu")
    assert out["capture_s"] is not None and out["decode_steps"] == gen - 1
    got = out["tokens"].numpy()
    # the reference's logits along its own tokens: where may a greedy token flip?
    logits, cache = jax.jit(jmodel.prefill)(jparams, jprompt, jmodel.init_cache(batch,
                                                                              prompt_len + gen))
    decode = jax.jit(jmodel.decode_step)
    margins, limits = [], []
    for step in range(gen):
        if step:
            logits, cache = decode(jparams, jnp.asarray(want[:, step - 1]),
                                   jnp.full((batch,), prompt_len + step - 1, jnp.int32), cache)
        last = np.asarray(logits)[:, -1]
        assert np.array_equal(last.argmax(-1), want[:, step])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        limits.append(2 * (TOL["atol"] + TOL["rtol"] * np.abs(last).max(axis=-1)))
    margins, limits = np.stack(margins, axis=1), np.stack(limits, axis=1)
    for row in range(batch):
        close = np.flatnonzero(margins[row] <= limits[row])
        upto = close[0] + 1 if close.size else gen
        assert np.array_equal(got[row, :upto], want[row, :upto]), row


@pytest.mark.parametrize("case", ["rwkv6", "zamba2"])
def test_serve_fleet_scan_equals_python_loop(case):
    """The fleet's scanned groups == each group prefilled and decoded with
    the python loop on views of its peer's parameters: tokens and caches."""
    cfg = MODELS[case]()
    model = build_model(cfg)
    k, gen = 2, 5
    stacked = ttf.stacked_init(k, lambda p: model.init(torch.Generator().manual_seed(10 + p)))
    prompt_gen = torch.Generator().manual_seed(1)
    prompts = ttf.stacked_init(k, lambda _p: model.make_batch(prompt_gen, B, PROMPT))
    caches = serve.stack_request_caches(model.init_cache(B, PROMPT + gen, "cpu"), k)
    fleet = serve.make_fleet_generate_fn(model, gen)
    toks, new_caches = fleet(stacked, prompts, caches, torch.arange(k))
    assert fleet.decode.capture_seconds > 0
    prefill = steps.make_prefill_step(model)
    loop = steps.make_decode_loop(model, gen - 1)
    for g in range(k):
        tok, cache = prefill(common.row(stacked, g), common.row(prompts, g),
                             model.init_cache(B, PROMPT + gen, "cpu"))
        rest, cache = loop(common.row(stacked, g), cache, tok,
                           torch.full((B,), PROMPT, dtype=torch.int64))
        assert torch.equal(toks[g], torch.cat([tok[:, None], rest], dim=1))
        for name in cache:
            assert torch.equal(new_caches[name][g], cache[name]), name


def test_serve_defaults_match_reference():
    """``decode_impl="scan"`` by default, in ``serve_batch`` and the CLI."""
    assert serve.serve_batch.__kwdefaults__["decode_impl"] == "scan"
    assert jserve.serve_batch.__kwdefaults__["decode_impl"] == "scan"
    out = serve.serve_batch("smollm-135m", batch=2, prompt_len=8, gen_tokens=3, device="cpu")
    assert out["capture_s"] is not None
    python = serve.serve_batch("smollm-135m", batch=2, prompt_len=8, gen_tokens=3,
                               device="cpu", decode_impl="python")
    assert python["capture_s"] is None and torch.equal(out["tokens"], python["tokens"])

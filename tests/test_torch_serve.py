"""The port's serving path (``repro_torch.launch.serve``, ``launch.steps``,
``core.p2p.serving_params``) against the reference, on the CPU.

* Generation, for the reduced RWKV6-7B and the reduced smollm-135m (the
  reference's own tests/test_serve.py arch, a dense GQA decoder): on the
  same exported parameters and prompt, every step's
  logits, teacher-forced with the reference's greedy tokens, are allclose
  (float32 atol = rtol = 1e-4; measured ~3e-6), and the port's own greedy
  tokens equal the reference's up to the first step whose top-2 logit margin
  is within twice that tolerance (where the argmax may flip).
* The explicit empty decode at ``gen_tokens == 1``, the ``ValueError``s, and
  ``decode_impl="scan"`` equal to ``"python"`` on the CPU.
* The fleet is bit-identical to sequential per-peer generation
  (``torch.equal``), under any routing, for both families.
* The 2NN fleet, ``serving_params`` and ``consensus_averaged_params`` on a
  state exported from the reference (``interop.state_from_jax``): serving
  rows bit-equal, logits and averages allclose at float32 atol 1e-6 /
  rtol 1e-5 (the reference's own test tolerance for the average).
* Without ``device="cpu"`` the entry points and the CLI raise (no CUDA here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import p2pl_mnist as jmnist  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model, mlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "rwkv6-7b"
DENSE_ARCH = "smollm-135m"


def _models(arch):
    jmodel = jbuild_model(jconfigs.reduced(jconfigs.get_config(arch)))
    tmodel = build_model(tconfigs.reduced(tconfigs.get_config(arch)))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


@pytest.fixture(scope="module")
def dense_models():
    return _models(DENSE_ARCH)


@pytest.mark.parametrize("prompt_len,gen", [(8, 6), (10, 5)])
def test_generate_matches_reference(models, prompt_len, gen):
    _check_generate(models, prompt_len, gen)


@pytest.mark.parametrize("prompt_len,gen", [(8, 6), (10, 5)])
def test_dense_generate_matches_reference(dense_models, prompt_len, gen):
    _check_generate(dense_models, prompt_len, gen)


def _check_generate(models, prompt_len, gen):
    jmodel, jparams, tmodel, tparams = models
    tokens = np.random.default_rng(prompt_len).integers(0, 512, (2, prompt_len))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tbatch = {"tokens": torch.as_tensor(tokens)}
    cache_len = prompt_len + gen
    jtoks, _ = jax.jit(jsteps.make_generate_fn(jmodel, gen))(
        jparams, jbatch, jmodel.init_cache(2, cache_len))
    jtoks = np.array(jtoks)
    ttoks, _ = steps.make_generate_fn(tmodel, gen)(tparams, tbatch,
                                                  tmodel.init_cache(2, cache_len, "cpu"))
    assert ttoks.shape == (2, gen) and ttoks.dtype == torch.int64

    # teacher-forced: both packages fed the reference's greedy tokens
    jlogits, jstate = jax.jit(jmodel.prefill)(jparams, jbatch, jmodel.init_cache(2, cache_len))
    tlogits, tstate = tmodel.prefill(tparams, tbatch, tmodel.init_cache(2, cache_len, "cpu"))
    jdecode = jax.jit(jmodel.decode_step)
    margins, limits = [], []
    for step in range(gen):
        if step:
            prev = jtoks[:, step - 1]
            pos = prompt_len + step - 1
            jlogits, jstate = jdecode(jparams, jnp.asarray(prev, jnp.int32),
                                      jnp.full((2,), pos, jnp.int32), jstate)
            tlogits, tstate = tmodel.decode_step(tparams, torch.as_tensor(prev),
                                                 torch.full((2,), pos), tstate)
        want = np.asarray(jlogits)[:, -1]
        np.testing.assert_allclose(tlogits[:, -1].numpy(), want, **TOL, err_msg=f"step {step}")
        assert np.array_equal(want.argmax(-1), jtoks[:, step])
        top2 = np.sort(want, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        # two logits each off by up to the tolerance can swap within this
        limits.append(2 * (TOL["atol"] + TOL["rtol"] * np.abs(want).max(axis=-1)))
    margins, limits = np.stack(margins, axis=1), np.stack(limits, axis=1)  # (B, gen)
    for row in range(2):
        close = np.flatnonzero(margins[row] <= limits[row])
        upto = close[0] + 1 if close.size else gen  # the first step that may flip, included
        assert np.array_equal(ttoks[row, :upto].numpy(), jtoks[row, :upto]), row


def test_gen_tokens_one_is_explicit_empty_decode():
    out = serve.serve_batch(ARCH, batch=2, prompt_len=8, gen_tokens=1, device="cpu")
    assert out["tokens"].shape == (2, 1)
    assert out["decode_steps"] == 0
    assert out["decode_s_per_token"] is None
    assert out["peak_memory_gb"] is None  # no device peak on the CPU
    many = serve.serve_batch(ARCH, batch=2, prompt_len=8, gen_tokens=5, device="cpu")
    assert many["tokens"].shape == (2, 5) and many["decode_steps"] == 4
    assert torch.equal(out["tokens"], many["tokens"][:, :1])


def test_degenerate_lengths_rejected(models):
    _, _, tmodel, _ = models
    with pytest.raises(ValueError, match="gen_tokens"):
        serve.serve_batch(ARCH, gen_tokens=0, device="cpu")
    with pytest.raises(ValueError, match="gen_tokens"):
        steps.make_generate_fn(tmodel, 0)
    with pytest.raises(ValueError, match="num_steps"):
        steps.make_decode_loop(tmodel, 0)
    with pytest.raises(ValueError, match="decode_impl"):
        serve.serve_batch(ARCH, decode_impl="loop", device="cpu")
    # the scanned decode runs on the CPU and gives the python loop's tokens
    kw = dict(batch=2, prompt_len=8, gen_tokens=4, device="cpu")
    scan = serve.serve_batch(ARCH, decode_impl="scan", **kw)
    assert torch.equal(scan["tokens"], serve.serve_batch(ARCH, decode_impl="python",
                                                         **kw)["tokens"])
    with pytest.raises(ValueError, match="peer_axis"):
        serve.serve_fleet(ARCH, peer_axis="mesh", device="cpu")
    # the pod layout serves a process a peer, the stacked fleet's tokens
    kw = dict(num_peers=2, batch=2, prompt_len=5, gen_tokens=3, device="cpu")
    assert torch.equal(serve.serve_fleet(ARCH, peer_axis="pod", **kw)["tokens"],
                       serve.serve_fleet(ARCH, **kw)["tokens"])


def test_prefill_on_cpu_counts_no_kernel_launch():
    wkv6_ops.launches.reset()
    serve.serve_batch(ARCH, batch=2, prompt_len=9, gen_tokens=3, device="cpu")
    assert wkv6_ops.launches.count == 0


@pytest.mark.parametrize("order", ["identity", "reversed"])
def test_fleet_generate_bit_identical_to_sequential(models, order):
    _check_fleet(models[2], order)


@pytest.mark.parametrize("order", ["identity", "reversed"])
def test_dense_fleet_generate_bit_identical_to_sequential(dense_models, order):
    _check_fleet(dense_models[2], order)


def _check_fleet(tmodel, order):
    """One fleet call == each group served separately on its peer's own
    (separately drawn) parameters, token for token and cache for cache."""
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


def test_stack_request_caches_layout(models):
    _check_stack_request_caches(models[2])


def test_dense_stack_request_caches_layout(dense_models):
    """The decoder's KV cache (``main.k``, ``main.v``, ``main.pos_ids``)."""
    assert set(dense_models[2].init_cache(2, 8, "cpu")) == {"main.k", "main.v", "main.pos_ids"}
    _check_stack_request_caches(dense_models[2])


def test_dense_serve_batch_on_cpu_counts_no_launch():
    flash_ops.launches.reset()
    out = serve.serve_batch("minitron-8b", batch=2, prompt_len=7, gen_tokens=3, device="cpu")
    assert out["tokens"].shape == (2, 3) and out["decode_steps"] == 2
    assert out["cache"]["main.pos_ids"].shape == (2, 2, 10)
    assert bool((out["cache"]["main.pos_ids"][:, :, :9] >= 0).all())
    assert flash_ops.launches.count == 0


def _check_stack_request_caches(tmodel):
    cache = tmodel.init_cache(2, 8, "cpu")
    stacked = serve.stack_request_caches(cache, 3)
    for name, leaf in cache.items():
        assert stacked[name].shape == (3, *leaf.shape)
        assert stacked[name].untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()


@pytest.fixture(scope="module")
def mnist_states():
    """A reference 2NN state of K = 4 divergent peers (local_dsgd: no max-norm
    sync) and the port's state converted from it."""
    jcfg = dataclasses.replace(jmnist.noniid_k2().p2p, num_peers=4)
    jstate = jp2p.init_state(jax.random.PRNGKey(3), jmlp.init_2nn, jcfg)
    task = ttask.get_task("mnist_mlp")
    return jstate, interop.state_from_jax(jax.tree.map(np.asarray, jstate), task), task


def test_serving_params_equal_reference(mnist_states):
    jstate, tstate, task = mnist_states
    got = tp2p.serving_params(tstate, task)
    want = interop.params_from_jax(jax.tree.map(np.asarray, jp2p.serving_params(jstate)))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
        # views into the state's (K, row) buffer: serving copies nothing
        assert got[name].untyped_storage().data_ptr() == tstate.params.untyped_storage().data_ptr()


@pytest.mark.parametrize("peer_ids", [[0, 1, 2, 3], [3, 2, 1, 0], [1, 1, 0]])
def test_fleet_classify_matches_reference(mnist_states, peer_ids):
    jstate, tstate, task = mnist_states
    inputs = np.random.default_rng(5).normal(size=(len(peer_ids), 16, 784)).astype(np.float32)
    want = jax.jit(jserve.make_fleet_classify_fn(jmlp.apply_2nn))(
        jp2p.serving_params(jstate), jnp.asarray(inputs), jnp.asarray(peer_ids, jnp.int32))
    got = serve.make_fleet_classify_fn(mlp.apply_2nn)(
        tp2p.serving_params(tstate, task), torch.as_tensor(inputs), torch.as_tensor(peer_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sizes", [None, [1.0, 3.0, 0.0, 0.0]])
def test_consensus_averaged_params_match_reference(mnist_states, sizes):
    jstate, tstate, task = mnist_states
    data_sizes = None if sizes is None else np.asarray(sizes)
    want = interop.params_from_jax(jax.tree.map(
        np.asarray, jp2p.consensus_averaged_params(jp2p.serving_params(jstate), data_sizes)))
    stacked = tp2p.serving_params(tstate, task)
    got = tp2p.consensus_averaged_params(stacked, data_sizes)
    for name in want:
        assert got[name].shape == stacked[name].shape  # the stacked layout serving reuses
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)
        assert torch.equal(got[name][0], got[name][-1])


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_points_raise_without_cuda(no_cuda, device):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_batch(ARCH, batch=2, prompt_len=4, gen_tokens=2, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_fleet(ARCH, num_peers=2, batch=2, prompt_len=4, gen_tokens=2, device=device)


@pytest.mark.parametrize("argv", [[], ["--peers", "2"], ["--full"], ["--device", "cuda"]])
def test_cli_raises_without_cuda(no_cuda, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "2", "--gen", "2", "--prompt-len", "4", *argv])


@pytest.mark.parametrize("argv,want", [
    ([], "decode:"),
    (["--peers", "2"], "fleet: 2 personalized models"),
    (["--gen", "1"], "decode: (empty"),
])
def test_cli_on_cpu(argv, want, capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--gen", "3", "--prompt-len", "6", *argv])
    out = capsys.readouterr().out
    assert "device=cpu" in out and want in out

"""Port parity, the training step API: ``repro_torch.optim``,
``repro_torch.checkpoint``, the training half of ``launch.steps`` and the
consensus kernels' tree-level wrappers, against the reference's on the CPU.

- optim: ``sgd`` with and without momentum, ``adamw`` with weight decay, a
  schedule as the rate, step by step (params and state), float32 and bf16
  parameters, the step an int or a tensor; the schedules; ``global_norm``
  and ``clip_by_global_norm``;
- checkpoint: a round trip of the port's trees (dotted names, nested dicts,
  lists, bf16); files of either package restored by the other (float32);
  bf16 written as the reference writes it, byte for byte, restored by the
  port bit for bit where the reference's ``restore`` raises (a quirk of the
  reference); a missing key and a shape mismatch raise;
- ``make_train_step`` on the 2NN and reduced smollm-135m (float32 and
  bf16), ``make_consensus_step`` (the 2NN on a ring, reduced smollm in bf16
  with d held to a float64 truth, mixed leaf types, an isolated peer) and
  ``make_consensus_step_psum``;
- ``flatten_pytree`` in the reference's leaf order on every registered
  model's reduced parameters; ``consensus_mix_schedule``,
  ``consensus_mix_push_sum_schedule``, ``consensus_mix_flat``,
  ``quantize_int8``, ``dequant_mix_flat``, ``dequant_consensus_mix_stacked``
  and ``_schedule`` against the reference's Pallas wrappers in interpret
  mode; a tensor round index gives the int's result bit for bit.

Tolerance: float32 atol 5e-5 / rtol 1e-4, bf16 5e-2 (tests/test_kernels.py).
"""
import dataclasses
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels.consensus_mix import dequant as jdequant  # noqa: E402
from repro.kernels.consensus_mix import ops as jops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, reduced  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant as tdequant  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as tops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A reference tree (jax or numpy leaves) as the port's flat dict."""
    return interop.params_from_jax(_np(tree))


def _close(got: dict, want_tree, tol, what=""):
    want = _port(want_tree)
    assert list(pytree.leaves_with_path(got)) and set(got) == set(want), what
    for name, g in got.items():
        assert g.dtype == want[name].dtype, (what, name, g.dtype, want[name].dtype)
        np.testing.assert_allclose(g.float().numpy(), want[name].float().numpy(), **tol,
                                   err_msg=f"{what} {name}")


def _small_tree(rng, dtype="float32"):
    tree = {"fc1": {"w": rng.normal(size=(6, 4)), "b": rng.normal(size=(4,))},
            "out": {"w": rng.normal(size=(4, 3))}}
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(dtype), tree)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.1),
    "sgd_momentum": lambda o: o.sgd(0.1, momentum=0.9),
    "sgd_cosine": lambda o: o.sgd(o.cosine_schedule(0.2, 2, 6, floor=0.01), momentum=0.5),
    "adamw_wd": lambda o: o.adamw(0.01, weight_decay=0.1),
    "adamw_cosine": lambda o: o.adamw(o.cosine_schedule(1e-2, 2, 5), b2=0.99),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name, dtype):
    rng = np.random.default_rng(0)
    jparams = _small_tree(rng, dtype)
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](toptim)
    tparams = _port(jparams)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    tol = TOL if dtype == "float32" else BF16_TOL
    for step in range(6):
        jgrads = _small_tree(rng, dtype)
        jparams, jstate = jopt.update(jgrads, jstate, jparams, jnp.asarray(step, jnp.int32))
        tstep = step if step % 2 else torch.tensor(step)
        tparams, tstate = topt.update(_port(jgrads), tstate, tparams, tstep)
        _close(tparams, jparams, tol, f"step {step} params")
        for got, want in zip(pytree.leaves(tstate), jax.tree.leaves(jstate)):
            assert got.dtype == torch.float32  # float32 state whatever the params' type
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if dtype == "bfloat16":  # the update rounds once, from float32, as the reference's
        np.testing.assert_array_equal(tparams["fc1.b"].view(torch.int16).numpy(),
                                      np.asarray(jparams["fc1"]["b"]).view(np.int16))


def test_schedules_match_reference():
    for args in ((0.1, 3, 10), (0.5, 0, 4, 0.05), (1e-3, 10, 10)):
        jfn, tfn = joptim.cosine_schedule(*args), toptim.cosine_schedule(*args)
        for step in range(14):
            want = float(jfn(jnp.asarray(step, jnp.int32)))
            for s in (step, torch.tensor(step)):
                got = tfn(s)
                assert got.dtype == torch.float32
                np.testing.assert_allclose(float(got), want, **TOL)
    assert toptim.constant_schedule(0.3)(torch.tensor(5)) == 0.3


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype, max_norm):
    jtree = _small_tree(np.random.default_rng(1), dtype)
    tree = _port(jtree)
    np.testing.assert_allclose(float(toptim.global_norm(tree)),
                               float(joptim.global_norm(jtree)), **TOL)
    _close(toptim.clip_by_global_norm(tree, max_norm), joptim.clip_by_global_norm(jtree, max_norm),
           TOL if dtype == "float32" else BF16_TOL)
    if max_norm > 1e3:
        for name, g in toptim.clip_by_global_norm(tree, max_norm).items():
            assert torch.equal(g, tree[name])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"fc1.w": torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32)),
            "emb": torch.as_tensor(rng.normal(size=(5, 2)).astype(np.float32)).to(torch.bfloat16),
            "opt": {"m": {"fc1.w": torch.zeros(3, 4)}, "count": torch.tensor(7)},
            "hist": [torch.arange(3), torch.ones(2, dtype=torch.float64)]}
    tckpt.save(str(tmp_path / "ck"), tree, step=12, extra={"arch": "x"})
    meta = tckpt.load_metadata(str(tmp_path / "ck.npz"))
    assert meta == {"step": 12, "extra": {"arch": "x"},
                    "keys": sorted(["fc1/w", "emb", "opt/m/fc1/w", "opt/count", "hist/#0",
                                    "hist/#1"])}
    like = pytree.tree_map(torch.zeros_like, tree)
    got = tckpt.restore(str(tmp_path / "ck"), like)
    assert list(got) == list(tree) and isinstance(got["hist"], list)
    for (path, g), w in zip(pytree.leaves_with_path(got), pytree.leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_checkpoint_files_cross_between_packages(tmp_path):
    jtree = {"fc1": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                     "b": np.ones(4, np.float32)},
             "layers": {"attn": {"wq": np.full((2, 3), 0.5, np.float32)}}}
    # the reference writes, the port reads into its dotted names
    jckpt.save(str(tmp_path / "ref"), jtree, step=3)
    like = {k: torch.zeros_like(v) for k, v in _port(jtree).items()}
    got = tckpt.restore(str(tmp_path / "ref"), like)
    for name, v in _port(jtree).items():
        assert torch.equal(got[name], v), name
    # the port writes, the reference reads into its nested tree
    tckpt.save(str(tmp_path / "port"), _port(jtree), step=3)
    back = jckpt.restore(str(tmp_path / "port"), jax.tree.map(np.zeros_like, jtree))
    jax.tree.map(np.testing.assert_array_equal, back, jtree)
    assert tckpt.load_metadata(str(tmp_path / "port")) == jckpt.load_metadata(
        str(tmp_path / "ref"))
    assert _members(tmp_path / "port.npz") == _members(tmp_path / "ref.npz")


def test_checkpoint_bf16_written_as_reference_and_restored_by_port(tmp_path):
    """The reference writes bf16 leaves as two-byte void records (``<V2``)
    and cannot restore them (ROADMAP.md section 3); the port writes the same
    bytes and restores them bit for bit."""
    jtree = {"w": jnp.asarray(np.random.default_rng(3).normal(size=(4, 6)), jnp.bfloat16),
             "b": jnp.asarray([1.0, -2.5], jnp.float32)}
    jckpt.save(str(tmp_path / "ref"), jtree)
    tree = _port(jtree)
    tckpt.save(str(tmp_path / "port"), tree)
    assert _members(tmp_path / "port.npz") == _members(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as npz:
        assert npz["w"].dtype.kind == "V" and npz["w"].dtype.itemsize == 2
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path / "ref"), jtree)
    for path in ("ref", "port"):
        got = tckpt.restore(str(tmp_path / path), {k: torch.zeros_like(v) for k, v in tree.items()})
        for name, v in tree.items():
            assert got[name].dtype == v.dtype
            assert torch.equal(got[name].view(torch.int16) if v.dtype == torch.bfloat16
                               else got[name], v.view(torch.int16) if v.dtype == torch.bfloat16
                               else v), name


def test_checkpoint_missing_key_and_shape_mismatch_raise_as_reference(tmp_path):
    jtree = {"a": np.ones((2, 3), np.float32)}
    jckpt.save(str(tmp_path / "ck"), jtree)
    for jlike, tlike, exc in (({"b": np.ones((2, 3), np.float32)}, {"b": torch.ones(2, 3)},
                               KeyError),
                              ({"a": np.ones((3, 2), np.float32)}, {"a": torch.ones(3, 2)},
                               ValueError)):
        with pytest.raises(exc) as want:
            jckpt.restore(str(tmp_path / "ck"), jlike)
        with pytest.raises(exc) as got:
            tckpt.restore(str(tmp_path / "ck"), tlike)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


def _mlp_params(rng, lead=()):
    """A 2NN's tree (20-16-16-5), the reference's leaves, ``lead`` stacked."""
    dims = {"fc1": (20, 16), "fc2": (16, 16), "out": (16, 5)}
    return {name: {"w": jnp.asarray(rng.normal(scale=0.3, size=lead + d), jnp.float32),
                   "b": jnp.asarray(rng.normal(scale=0.1, size=lead + d[1:]), jnp.float32)}
            for name, d in dims.items()}


def _mlp_models():
    def port_loss(params, batch):
        x, y = batch
        return tmlp.loss_2nn({k: v[None] for k, v in params.items()}, (x[None], y[None]))[0]

    return types.SimpleNamespace(loss_fn=jmlp.loss_2nn), types.SimpleNamespace(loss_fn=port_loss)


def _mlp_batches(rng, steps, b=8):
    return [(rng.normal(size=(b, 20)).astype(np.float32),
             rng.integers(0, 5, size=b).astype(np.int32)) for _ in range(steps)]


def _lm_case(dtype):
    jcfg = dataclasses.replace(jreduced(jget_config("smollm-135m")), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    model = build_model(reduced(get_config("smollm-135m")).replace(dtype=dtype))
    return jmodel, model, jmodel.init(jax.random.PRNGKey(1))


def _lm_batches(rng, steps, vocab, b=2, s=16):
    return [{"tokens": rng.integers(0, vocab, size=(b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, size=(b, s)).astype(np.int32)}
            for _ in range(steps)]


def _mlp_port(b):
    return torch.as_tensor(b[0]), torch.as_tensor(b[1], dtype=torch.int64)


def _lm_port(b):
    return {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}


TRAIN_CASES = {  # (optimizer, dtype): the 2NN float32, reduced smollm-135m
    "mlp_sgd": (lambda o: o.sgd(0.05, momentum=0.5), "float32"),
    "mlp_adamw": (lambda o: o.adamw(o.cosine_schedule(1e-2, 1, 4), weight_decay=0.01),
                  "float32"),
    "smollm_f32": (lambda o: o.sgd(0.1, momentum=0.5), "float32"),
    "smollm_bf16": (lambda o: o.sgd(0.1, momentum=0.5), "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_reference(case):
    rng = np.random.default_rng(5)
    make, dtype = TRAIN_CASES[case]
    if case.startswith("mlp"):
        jmodel, tmodel = _mlp_models()
        jparams = _mlp_params(rng)
        batches = _mlp_batches(rng, 3)
        to_port, to_ref = _mlp_port, lambda b: tuple(map(jnp.asarray, b))
    else:
        jmodel, tmodel, jparams = _lm_case(dtype)
        batches = _lm_batches(rng, 2, jmodel.cfg.vocab_size)
        to_port, to_ref = _lm_port, lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    tol = TOL if dtype == "float32" else BF16_TOL
    jopt, topt = make(joptim), make(toptim)
    jd = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-2, p.dtype), jparams)
    params0 = jparams
    jstep = jax.jit(jsteps.make_train_step(jmodel, jopt, eta_d=0.25))
    tstep = tsteps.make_train_step(tmodel, topt, eta_d=0.25)
    tparams, td = _port(jparams), _port(jd)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    before = {k: v.clone() for k, v in tparams.items()}
    for step, batch in enumerate(batches):
        jparams, jstate, jloss = jstep(jparams, jstate, jd, to_ref(batch), jnp.asarray(step))
        tparams, tstate, tloss = tstep(tparams, tstate, td, to_port(batch), step)
        assert not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), **tol)
        _close(tparams, jparams, tol, f"step {step}")
    # the step left its inputs as they were
    assert all(torch.equal(before[k], v) for k, v in _port(params0).items())


def test_train_step_without_eta_d_ignores_d():
    jmodel, tmodel = _mlp_models()
    params = _port(_mlp_params(np.random.default_rng(2)))
    (x, y), = _mlp_batches(np.random.default_rng(0), 1)
    batch = (torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64))
    opt = toptim.sgd(0.1)
    a = tsteps.make_train_step(tmodel, opt)(params, (), None, batch, 0)
    d = {k: torch.ones_like(v) for k, v in params.items()}
    b = tsteps.make_train_step(tmodel, opt)(params, (), d, batch, 0)
    for name in params:
        assert torch.equal(a[0][name], b[0][name])


# ---------------------------------------------------------------------------
# make_consensus_step, make_consensus_step_psum
# ---------------------------------------------------------------------------


def _ring_matrices(k, sizes=None):
    graph = tgraph.build_graph("ring", k)
    return (tgraph.mixing_matrix(graph, "data_weighted", data_sizes=sizes),
            tgraph.affinity_matrix(graph, data_sizes=sizes))


def _stacked_mlp(k, seed=0):
    return _mlp_params(np.random.default_rng(seed), (k,))


@pytest.mark.parametrize("use_affinity", [True, False])
def test_consensus_step_matches_reference_on_the_mlp(use_affinity):
    k, t = 4, 3
    w, beta = _ring_matrices(k, np.array([5, 10, 20, 40]))
    jstacked = _stacked_mlp(k)
    jd = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), jstacked)
    jmixed, jd_new = jsteps.make_consensus_step(w, beta, local_steps=t,
                                                use_affinity=use_affinity)(jstacked, jd)
    td = _port(jd)
    step = tsteps.make_consensus_step(w, beta, local_steps=t, use_affinity=use_affinity)
    tmixed, td_new = step(_port(jstacked), td)
    _close(tmixed, jmixed, TOL, "mixed")
    _close(td_new, jd_new, TOL, "d")
    if not use_affinity:
        assert td_new is td
    # a second call reuses the operands uploaded by the first
    again, _ = step(_port(jstacked), td)
    assert all(torch.equal(again[n], tmixed[n]) for n in tmixed)


def test_consensus_step_bf16_d_within_the_reference_error():
    """bf16 peers close together: the reference rounds the Beta-average to
    bf16 before it subtracts x, the kernel's plain version sums in float32
    and rounds d once.  Against the float64 truth the port's d is nearer,
    and both mixes are within bf16 tolerance of each other (ROADMAP.md
    section 3)."""
    k, t = 4, 4
    w, beta = _ring_matrices(k, np.array([3, 1, 4, 2]))
    _, _, jparams = _lm_case("bfloat16")
    rng = np.random.default_rng(8)
    jstacked = jax.tree.map(
        lambda p: (p.astype(jnp.float32)[None] * (1 + 1e-2 * rng.normal(size=(k,) + p.shape)))
        .astype(jnp.bfloat16), jparams)
    jd = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jstacked)
    jmixed, jd_new = jsteps.make_consensus_step(w, beta, local_steps=t,
                                                use_affinity=True)(jstacked, jd)
    tmixed, td_new = tsteps.make_consensus_step(w, beta, local_steps=t, use_affinity=True)(
        _port(jstacked), _port(jd))
    _close(tmixed, jmixed, BF16_TOL, "mixed")
    ref_err2 = port_err2 = 0.0
    for name, x in _port(jstacked).items():
        x64 = x.double().reshape(k, -1)
        truth = ((torch.as_tensor(beta) @ x64) - x64) / t
        assert td_new[name].dtype == torch.float32
        port_err2 += float(((td_new[name].double().reshape(k, -1) - truth) ** 2).sum())
        ref = _port(jd_new)[name].double().reshape(k, -1)
        ref_err2 += float(((ref - truth) ** 2).sum())
    assert port_err2 < ref_err2, (port_err2, ref_err2)


def test_consensus_step_mixes_each_leaf_type_in_its_type():
    k, t = 3, 2
    w, beta = _ring_matrices(k)
    rng = np.random.default_rng(4)
    jstacked = {"a": jnp.asarray(rng.normal(size=(k, 5, 3)), jnp.bfloat16),
                "norm": jnp.asarray(rng.normal(size=(k, 7)), jnp.float32),
                "b": jnp.asarray(rng.normal(size=(k, 4)), jnp.bfloat16)}
    jd = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jstacked)
    jmixed, jd_new = jsteps.make_consensus_step(w, beta, local_steps=t,
                                                use_affinity=True)(jstacked, jd)
    calls = []
    real = tops.consensus_mix_stacked

    def counted(flat, ops, local_steps):
        calls.append(flat.dtype)
        return real(flat, ops, local_steps)

    tops.consensus_mix_stacked = counted
    try:
        tmixed, td_new = tsteps.make_consensus_step(w, beta, local_steps=t, use_affinity=True)(
            _port(jstacked), _port(jd))
    finally:
        tops.consensus_mix_stacked = real
    assert calls == [torch.bfloat16, torch.float32]  # one call for each leaf type
    _close(tmixed, jmixed, BF16_TOL, "mixed")
    np.testing.assert_allclose(tmixed["norm"].numpy(), np.asarray(jmixed["norm"]), **TOL)
    _close(td_new, jd_new, BF16_TOL, "d")
    np.testing.assert_allclose(td_new["norm"].numpy(), np.asarray(jd_new["norm"]), **TOL)


def test_consensus_step_isolated_peer_keeps_zero_d():
    """A peer with no affinity neighbor: the port keeps d = 0, as its runtime
    does; the reference's dense form gives -x / T (ROADMAP.md section 3)."""
    k, t = 3, 2
    w = np.array([[0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.0, 0.0, 1.0]])
    beta = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    x = np.random.default_rng(0).normal(size=(k, 6)).astype(np.float32)
    jmixed, jd = jsteps.make_consensus_step(w, beta, local_steps=t, use_affinity=True)(
        {"x": jnp.asarray(x)}, None)
    tmixed, td = tsteps.make_consensus_step(w, beta, local_steps=t, use_affinity=True)(
        {"x": torch.as_tensor(x)}, None)
    np.testing.assert_allclose(tmixed["x"].numpy(), np.asarray(jmixed["x"]), **TOL)
    np.testing.assert_allclose(td["x"][:2].numpy(), np.asarray(jd["x"])[:2], **TOL)
    assert not bool(td["x"][2].any())
    np.testing.assert_allclose(np.asarray(jd["x"])[2], -x[2] / t, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consensus_step_psum_matches_reference(dtype):
    k, t = 5, 3
    jstacked = jax.tree.map(lambda p: p.astype(dtype), _stacked_mlp(k, seed=1))
    kw = dict(self_weight=0.4, peer_weight=0.15, local_steps=t, use_affinity=True)
    jmixed, jd = jsteps.make_consensus_step_psum(k, **kw)(jstacked, None)
    tmixed, td = tsteps.make_consensus_step_psum(k, **kw)(_port(jstacked), None)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(tmixed, jmixed, tol, "mixed")
    _close(td, jd, tol, "d")


def test_consensus_step_psum_equals_the_kernel_step_on_the_complete_graph():
    k, t = 4, 2
    w = np.full((k, k), 1.0 / k)
    beta = (np.ones((k, k)) - np.eye(k)) / (k - 1)
    stacked = _port(_stacked_mlp(k, seed=2))
    a = tsteps.make_consensus_step_psum(k, self_weight=1 / k, peer_weight=1 / k, local_steps=t,
                                        use_affinity=True)(stacked, None)
    b = tsteps.make_consensus_step(w, beta, local_steps=t, use_affinity=True)(stacked, None)
    for x, y in zip(a, b):
        for name in stacked:
            torch.testing.assert_close(x[name], y[name], **TOL)


# ---------------------------------------------------------------------------
# the kernels' tree-level wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_flatten_pytree_in_reference_order(arch):
    """Every registered model's reduced leaves, stacked over K = 2, each
    filled with values of its own: the flat buffers are equal."""
    shapes = jax.eval_shape(jbuild_model(jreduced(jget_config(arch))).init,
                            jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)
    start, filled = 0, []
    for leaf in leaves:
        n = 2 * int(np.prod(leaf.shape))
        filled.append((start + np.arange(n, dtype=np.float32)).reshape((2,) + leaf.shape))
        start += n
    jtree = jax.tree.unflatten(treedef, filled)
    want, _ = jops.flatten_pytree(jax.tree.map(jnp.asarray, jtree))
    tree = _port(jtree)
    got, meta = tops.flatten_pytree(tree)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [s for s, _ in meta] == [tuple(v.shape) for v in pytree.leaves(tree)]
    back = tops.unflatten_pytree(tree, got)
    assert list(back) == list(tree) and all(torch.equal(back[n], tree[n]) for n in tree)


def test_flatten_pytree_mnist_mlp_and_dotted_order():
    jtree = _stacked_mlp(3)
    want, _ = jops.flatten_pytree(jtree)
    got, _ = tops.flatten_pytree(_port(jtree))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # "a.b" is the nested key a/b: it sorts before "a-c", as jax sorts the nest
    flat, _ = tops.flatten_pytree({"a-c": torch.ones(2, 1), "a.b": torch.zeros(2, 1)})
    jflat, _ = jops.flatten_pytree({"a-c": jnp.ones((2, 1)), "a": {"b": jnp.zeros((2, 1))}})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_consensus_mix_schedule_matches_reference(as_tensor):
    texp = tconfigs.timevarying_k8(schedule="link_dropout", schedule_rounds=3)
    w, beta, _ = tp2p.mixing_constants(texp.p2p, np.arange(1, 9) * 5)
    jstacked = _stacked_mlp(8, seed=3)
    jsparse = jops.sparse_from_schedule(w, beta)
    tsparse = tops.sparse_from_schedule(w, beta)
    assert tsparse.self_w.shape == (3, 8)
    stacked = _port(jstacked)
    for r in range(4):
        jm, jd = jops.consensus_mix_schedule(jstacked, jnp.asarray(r), *jsparse, 4)
        idx = torch.tensor(r) if as_tensor else r
        tm, td = tops.consensus_mix_schedule(stacked, idx, *tsparse, 4)
        _close(tm, jm, TOL, f"round {r} mixed")
        _close(td, jd, TOL, f"round {r} d")
        if as_tensor:  # the tensor index gives the int's result bit for bit
            im, idd = tops.consensus_mix_schedule(stacked, r, *tsparse, 4)
            assert all(torch.equal(tm[n], im[n]) and torch.equal(td[n], idd[n]) for n in tm)


def test_consensus_mix_push_sum_schedule_matches_reference():
    texp = tconfigs.directed_k8(schedule="one_way_matching")
    consts, _ = tp2p.protocol_constants(texp.p2p, np.arange(1, 9) * 5)
    jsparse = jops.sparse_from_schedule(consts.w, consts.beta)
    tsparse = tops.sparse_from_schedule(consts.w, consts.beta)
    jstacked = _stacked_mlp(8, seed=4)
    mass = np.linspace(0.5, 1.5, 8).astype(np.float32)
    for r in (0, 1, 5):
        jm, jd, jy = jops.consensus_mix_push_sum_schedule(jstacked, jnp.asarray(mass),
                                                          jnp.asarray(r), *jsparse, 3)
        tm, td, ty = tops.consensus_mix_push_sum_schedule(_port(jstacked), torch.as_tensor(mass),
                                                          torch.tensor(r), *tsparse, 3)
        _close(tm, jm, TOL, "mixed")
        _close(td, jd, TOL, "d")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consensus_mix_flat_matches_reference(dtype):
    rng = np.random.default_rng(6)
    x, nbrs = rng.normal(size=300), rng.normal(size=(3, 300))
    wn, bt = np.array([0.2, 0.1, 0.3], np.float32), np.array([0.5, 0.25, 0.25], np.float32)
    jm, jd = jops.consensus_mix_flat(jnp.asarray(x, dtype), jnp.asarray(nbrs, dtype),
                                     jnp.float32(0.4), jnp.asarray(wn), jnp.asarray(bt), 5)
    tdt = getattr(torch, dtype)
    tm, td = tops.consensus_mix_flat(torch.as_tensor(x).to(tdt), torch.as_tensor(nbrs).to(tdt),
                                     0.4, torch.as_tensor(wn), torch.as_tensor(bt), 5)
    tol = TOL if dtype == "float32" else BF16_TOL
    for g, w in zip((tm, td), (jm, jd)):
        assert g.dtype == tdt and g.shape == (300,)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


def test_quantize_int8_equals_reference():
    x = np.random.default_rng(7).normal(size=(4, 257)).astype(np.float32)
    x[2] = 0.0
    jq, js = jdequant.quantize_int8(jnp.asarray(x))
    tq, ts = tdequant.quantize_int8(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequant_mix_flat_matches_reference():
    rng = np.random.default_rng(9)
    x, est = rng.normal(size=200).astype(np.float32), rng.normal(size=200).astype(np.float32)
    nest = rng.normal(size=(2, 200)).astype(np.float32)
    q = rng.integers(-127, 128, size=(2, 200)).astype(np.int8)
    sc = np.array([0.01, 0.02], np.float32)
    wn, bt = np.array([0.3, 0.2], np.float32), np.array([0.6, 0.4], np.float32)
    want = jdequant.dequant_mix_flat(*(jnp.asarray(a) for a in (x, est, nest, q, sc)),
                                     jnp.float32(0.5), jnp.asarray(wn), jnp.asarray(bt), 4)
    got = tdequant.dequant_mix_flat(*(torch.as_tensor(a) for a in (x, est, nest, q, sc)), 0.5,
                                    torch.as_tensor(wn), torch.as_tensor(bt), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dequant_consensus_mix_schedule_matches_reference(as_tensor):
    """The mix equals the reference's; d differs from it by the own
    payload's advance over T, as the port's runtime does (ROADMAP.md
    section 3, ``tests/test_torch_dequant_mix.py``)."""
    texp = tconfigs.timevarying_k8(schedule="round_robin")
    w, beta, _ = tp2p.mixing_constants(texp.p2p, np.arange(1, 9) * 5)
    jsparse = jops.sparse_from_schedule(w, beta)
    tsparse = tops.sparse_from_schedule(w, beta)
    jstacked = _stacked_mlp(8, seed=5)
    flat = np.asarray(jops.flatten_pytree(jstacked)[0])
    est = flat + np.random.default_rng(1).normal(scale=0.05, size=flat.shape).astype(np.float32)
    jq, jscale = jdequant.quantize_int8(jnp.asarray(flat - est))
    tq, tscale = tdequant.quantize_int8(torch.as_tensor(flat - est))
    t = 4
    own = (tq.float() * tscale[:, None] / t).numpy()
    for r in range(3):
        jm, jd = jdequant.dequant_consensus_mix_schedule(
            jstacked, jnp.asarray(est), jq, jscale, *jsparse, jnp.asarray(r), t)
        tm, td = tdequant.dequant_consensus_mix_schedule(
            _port(jstacked), torch.as_tensor(est), tq, tscale, *tsparse,
            torch.tensor(r) if as_tensor else r, t)
        _close(tm, jm, TOL, f"round {r} mixed")
        got_d = tops.flatten_pytree(td)[0].numpy()
        want_d = np.asarray(jops.flatten_pytree(jd)[0])
        np.testing.assert_allclose(want_d - got_d, own, **TOL)
    assert np.abs(own).max() > 1e-4


def test_wrappers_take_reference_sparse_arrays():
    """The reference's operand arrays (numpy, any int and float types) go
    in as they are and give the port's own operands' result."""
    w, beta = _ring_matrices(4)
    jsparse = [np.asarray(a) for a in jops.sparse_from_schedule(w[None], beta[None])]
    stacked = _port(_stacked_mlp(4, seed=6))
    a = tops.consensus_mix_schedule(stacked, 0, *jsparse, 2)
    b = tops.consensus_mix_schedule(stacked, 0, *tops.sparse_from_schedule(w[None], beta[None]),
                                    2)
    for x, y in zip(a, b):
        assert all(torch.equal(x[n], y[n]) for n in stacked)


def test_sparse_from_schedule_keeps_affinity_on_zero_mixing_edges():
    """An edge of mixing weight 0 with an affinity weight: the port's slots
    are W's and Beta's nonzeros, so d keeps that neighbor; the reference's
    are W's alone, so its d drops it (ROADMAP.md section 3; the port's
    runtime keeps it too, tests/test_torch_round.py)."""
    w = np.array([[1.0, 0.0, 0.0], [0.0, 0.5, 0.5], [0.0, 0.5, 0.5]])
    beta = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    x = {"x": np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)}
    tsparse = tops.sparse_from_schedule(w[None], beta[None])
    assert tsparse.nbr_idx.shape[-1] == 1 and int(tsparse.nbr_idx[0, 0, 0]) == 1
    _, td = tops.consensus_mix_schedule({"x": torch.as_tensor(x["x"])}, 0, *tsparse, 2)
    _, jd = jops.consensus_mix_schedule({"x": jnp.asarray(x["x"])}, jnp.asarray(0),
                                        *jops.sparse_from_schedule(w[None], beta[None]), 2)
    want_row0 = (x["x"][1] - x["x"][0]) / 2
    np.testing.assert_allclose(td["x"][0].numpy(), want_row0, **TOL)
    assert not np.asarray(jd["x"])[0].any()
    np.testing.assert_allclose(td["x"][1:].numpy(), np.asarray(jd["x"])[1:], **TOL)

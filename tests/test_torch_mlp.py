"""Port parity, the 2NN: on parameters exported from ``repro.models.mlp``,
per-peer losses, gradients and logits are allclose to the reference.

Tolerance: float32 atol 5e-5 / rtol 1e-4 (tests/test_kernels.py's float32
tolerance); the two packages sum the matmuls in different orders, TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
K, B = 3, 10


def _exported(seed=0):
    tree = jax.vmap(jmlp.init_2nn)(jax.random.split(jax.random.PRNGKey(seed), K))
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, n, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=(K, n)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(seed):
    tree = _exported(seed)
    x, y = _batch(seed)
    want_loss, want_grads = jax.vmap(jax.value_and_grad(jmlp.loss_2nn))(
        tree, (jnp.asarray(x), jnp.asarray(y))
    )
    params = {k: v.requires_grad_(True) for k, v in interop.params_from_jax(tree).items()}
    losses = tmlp.loss_2nn(params, (torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64)))
    assert losses.shape == (K,)
    grads = torch.autograd.grad(losses.sum(), list(params.values()))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss), **TOL)
    want = interop.params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL, err_msg=name)


def test_shared_input_logits_and_accuracy_match_reference():
    tree = _exported(2)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=64).astype(np.int32)
    want = jax.vmap(lambda p: jmlp.apply_2nn(p, jnp.asarray(x)))(tree)
    params = interop.params_from_jax(tree)
    got = tmlp.apply_2nn(params, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_acc = jax.vmap(lambda p: jmlp.accuracy_2nn(p, jnp.asarray(x), jnp.asarray(y)))(tree)
    got_acc = tmlp.accuracy_2nn(params, torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64))
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), atol=1.0 / 64)


def test_init_layout_and_bounds():
    gen = torch.Generator().manual_seed(0)
    got = tmlp.init_2nn(gen)
    want = jmlp.init_2nn(jax.random.PRNGKey(0))
    assert list(got) == list(tmlp.param_shapes())
    for name, value in got.items():
        layer, leaf = name.split(".")
        assert tuple(value.shape) == want[layer][leaf].shape
        assert value.dtype == torch.float32
        bound = want[layer]["w"].shape[0] ** -0.5  # 1/sqrt(fan_in)
        assert float(value.abs().max()) <= bound
    assert sum(v.numel() for v in got.values()) == 199_210
    # a second draw from the same generator differs; a reseeded one repeats
    again = tmlp.init_2nn(torch.Generator().manual_seed(0))
    assert all(torch.equal(got[n], again[n]) for n in got)
    assert not torch.equal(got["fc1.w"], tmlp.init_2nn(gen)["fc1.w"])

"""Parameter exchange with the reference: JAX tree -> numpy -> port -> numpy
is exact, before and after max-norm sync on both sides, and the port's flat
parameter rows hold the leaves without loss."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import consensus as jconsensus  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)


def _tree(k, seed):
    return jax.vmap(jmlp.init_2nn)(jax.random.split(jax.random.PRNGKey(seed), k))


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k,seed", [(2, 0), (5, 3)])
def test_round_trip_exact(k, seed):
    tree = jax.tree.map(np.asarray, _tree(k, seed))
    params = interop.params_from_jax(tree)
    assert set(params) == set(ttask.get_task("mnist_mlp").param_shapes)
    _assert_trees_equal(interop.params_to_jax(params), tree)


@pytest.mark.parametrize("k,seed", [(2, 0), (5, 3)])
def test_round_trip_after_max_norm_sync(k, seed):
    tree = _tree(k, seed)
    want = jax.tree.map(np.asarray, jconsensus.max_norm_sync(tree))
    synced = tconsensus.max_norm_sync(interop.params_from_jax(jax.tree.map(np.asarray, tree)))
    _assert_trees_equal(interop.params_to_jax(synced), want)


def test_flat_rows_round_trip():
    task = ttask.get_task("mnist_mlp")
    layout = tp2p.ParamLayout.of(task)
    params = interop.params_from_jax(jax.tree.map(np.asarray, _tree(3, 1)))
    flat = layout.flatten(params)
    assert flat.shape == (3, layout.row) and torch.all(flat[:, layout.size:] == 0)
    views = layout.views(flat)
    for name, value in params.items():
        assert torch.equal(views[name], value)
        # a view into the row buffer, not a copy
        assert views[name].untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()


@pytest.mark.parametrize("protocol", ["gossip", "push_sum"])
def test_state_from_jax_carries_the_protocol_state(protocol):
    """A reference round state converts with its protocol state: gossip's
    ``()``, push-sum's (K,) mass, float32 bits unchanged."""
    from repro.configs import p2pl_mnist as jconfigs
    from repro.core import p2p as jp2p
    from repro.core import task as jtask
    from repro_torch.core import protocols as tprotocols

    cfg = jconfigs.directed_k8(protocol=protocol).p2p
    sizes = np.array([150, 150, 150, 150, 100, 100, 100, 100])
    jstate = jp2p.init_state(jax.random.PRNGKey(0), jtask.get_task("mnist_mlp"), cfg,
                             data_sizes=sizes)
    tstate = interop.state_from_jax(jax.tree.map(np.asarray, jstate),
                                    ttask.get_task("mnist_mlp"))
    if protocol == "gossip":
        assert tstate.protocol == ()
    else:
        assert isinstance(tstate.protocol, tprotocols.PushSumState)
        assert tstate.protocol.mass.dtype == torch.float32
        np.testing.assert_array_equal(tstate.protocol.mass.numpy(),
                                      np.asarray(jstate.protocol.mass))

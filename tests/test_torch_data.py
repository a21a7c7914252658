"""Port parity, host data: synthetic MNIST, partitions and batch streams are
exactly equal (``array_equal``) to ``repro.data`` for the same seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import partition as jpartition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.data import partition as tpartition  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

# the ring config: 8 peers, 2 classes each (timevarying_k8 / sharded_k8 shards)
RING_CLASSES = [((2 * k) % 10, (2 * k + 1) % 10) for k in range(8)]


def _parts(pkg, name, data):
    x, y = data[0], data[1]
    if name == "noniid_k2":
        return pkg.pathological_partition(x, y, [(0, 1), (7, 8)], samples_per_class=50)
    if name == "iid_k100":
        return pkg.iid_partition(x, y, 100)
    return pkg.pathological_partition(x, y, RING_CLASSES, samples_per_class=50)


@pytest.mark.parametrize("num_train,num_test,seed", [(4000, 1000, 1234), (600, 100, 7)])
def test_mnist_like_equal(num_train, num_test, seed):
    want = jsynthetic.mnist_like(num_train, num_test, seed=seed)
    got = tsynthetic.mnist_like(num_train, num_test, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("config", ["noniid_k2", "iid_k100", "ring"])
def test_partitions_equal(config, mnist_small):
    want = _parts(jpartition, config, mnist_small)
    got = _parts(tpartition, config, mnist_small)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(tpartition.data_sizes(got), jpartition.data_sizes(want))


def test_pathological_partition_rejects_absent_class(mnist_small):
    x, y = mnist_small[0], mnist_small[1]
    with pytest.raises(ValueError, match="does not occur"):
        tpartition.pathological_partition(x, y, [(0, 11)])


@pytest.mark.parametrize("config,local_steps", [("noniid_k2", 10), ("iid_k100", 12),
                                                ("ring", 10)])
def test_peer_batcher_identical(config, local_steps, mnist_small):
    parts = _parts(jpartition, config, mnist_small)
    want = jpipeline.PeerBatcher(parts, 10, seed=3)
    got = tpipeline.PeerBatcher(parts, 10, seed=3)
    # enough rounds to cross epoch boundaries (reshuffles) on the small shards
    for _ in range(3):
        wx, wy = want.round_batches(local_steps)
        gx, gy = got.round_batches_on(local_steps, torch.device("cpu"))
        assert wx.shape == (local_steps, len(parts), 10, 784)
        assert gx.dtype == torch.float32 and gy.dtype == torch.int64
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)


def test_peer_batcher_tiny_shard_samples_with_replacement(mnist_small):
    # a 5-sample shard under B=10 draws with replacement in the reference
    x, y = mnist_small[0], mnist_small[1]
    parts = [(x[:5], y[:5]), (x[5:50], y[5:50])]
    want = jpipeline.PeerBatcher(parts, 10, seed=1)
    got = tpipeline.PeerBatcher(parts, 10, seed=1)
    for _ in range(4):
        for g, w in zip(got.round_batches_on(3, torch.device("cpu")), want.round_batches(3)):
            np.testing.assert_array_equal(g.numpy(), w)

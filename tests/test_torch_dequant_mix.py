"""Port parity, the fused dequantize-and-mix step: the plain stacked PyTorch
version (``repro_torch.kernels.consensus_mix.ref.dequant_mix_stacked_ref``,
which ``dequant.dequant_mix_stacked`` runs for CPU tensors) against the
reference's oracle ``ref.dequant_mix_ref`` and its Pallas wrapper
``dequant.dequant_mix_flat`` in interpret mode, per peer.  The CUDA kernel
itself is held to this plain version on the card by chip_smoke.py.

The reference's wrapper takes one scale per sender over the whole row and the
peer's own estimate from before this step's advance (quirks (a) and (b) of
ROADMAP.md section 3); the port follows the runtime: per-leaf scales, and d
from the advanced own estimate.  With one leaf the two scale layouts agree,
and passing the advanced own estimate as ``self_est`` gives the reference the
runtime's operands.

Tolerance: float32 atol 5e-5 / rtol 1e-4, tests/test_kernels.py's.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.consensus_mix import dequant as jdequant  # noqa: E402
from repro.kernels.consensus_mix import ref as jref  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant as tdequant  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_mix import ref as tref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
T = 10


def _random_case(d, n, seed, num_leaves=1):
    """K = d + 1 peers, each with d random neighbors and random weights."""
    k = d + 1
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, n)).astype(np.float32)
    est = rng.normal(size=(k, n)).astype(np.float32)
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = rng.uniform(0.0, 0.1, size=(k, num_leaves)).astype(np.float32)
    idx = np.stack([np.delete(np.arange(k), i)[rng.permutation(k - 1)][:d]
                    for i in range(k)]).astype(np.int32)
    w = rng.dirichlet(np.ones(d + 1), size=k).astype(np.float32)
    beta = rng.dirichlet(np.ones(d), size=k).astype(np.float32)
    ops = tops.SparseOperands(*(torch.as_tensor(a) for a in (w[:, 0].copy(), idx,
                                                            w[:, 1:].copy(), beta)))
    return x, est, q, scale, ops


def _port(x, est, q, scale, ops, offsets):
    mixed, d, est_new = tdequant.dequant_mix_stacked(
        torch.as_tensor(x), torch.as_tensor(est), torch.as_tensor(q), torch.as_tensor(scale),
        ops, offsets, T)
    return mixed.numpy(), d.numpy(), est_new.numpy()


def _reference_per_peer(fn, x, est, q, scale, ops, self_est):
    """The reference's per-peer function over every peer, with one scale per row."""
    idx = ops.nbr_idx.numpy()
    out_m, out_d = [], []
    for k in range(x.shape[0]):
        m, dd = fn(jnp.asarray(x[k]), jnp.asarray(self_est[k]), jnp.asarray(est[idx[k]]),
                   jnp.asarray(q[idx[k]]), jnp.asarray(scale[idx[k], 0]),
                   jnp.asarray(ops.self_w[k].item()), jnp.asarray(ops.nbr_w[k].numpy()),
                   jnp.asarray(ops.beta[k].numpy()), T)
        out_m.append(np.asarray(m))
        out_d.append(np.asarray(dd))
    return np.stack(out_m), np.stack(out_d)


SHAPES = [(n, d) for n in (64, 257, 1000) for d in (1, 3, 5)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_matches_reference_oracle(n, d):
    x, est, q, scale, ops = _random_case(d, n, seed=n + d)
    got_m, got_d, got_e = _port(x, est, q, scale, ops, (0, n))
    adv = est + q.astype(np.float32) * scale  # the runtime's advanced estimates
    np.testing.assert_array_equal(got_e, adv)
    want_m, want_d = _reference_per_peer(jref.dequant_mix_ref, x, est, q, scale, ops, adv)
    np.testing.assert_allclose(got_m, want_m, **TOL)
    np.testing.assert_allclose(got_d, want_d, **TOL)


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_matches_reference_pallas_interpret(n, d):
    x, est, q, scale, ops = _random_case(d, n, seed=7 * n + d)
    got_m, got_d, _ = _port(x, est, q, scale, ops, (0, n))
    adv = est + q.astype(np.float32) * scale
    want_m, want_d = _reference_per_peer(
        lambda *a: jdequant.dequant_mix_flat(*a, interpret=True), x, est, q, scale, ops, adv)
    np.testing.assert_allclose(got_m, want_m, **TOL)
    np.testing.assert_allclose(got_d, want_d, **TOL)


def test_d_differs_from_reference_wrapper_by_own_advance():
    """Quirk (a): the reference's wrapper computes d from the own estimate
    before this step's advance; the runtime, and the port, after it.  The two
    differ by exactly the own advance over T."""
    x, est, q, scale, ops = _random_case(3, 300, seed=5)
    _, got_d, _ = _port(x, est, q, scale, ops, (0, 300))
    _, wrapper_d = _reference_per_peer(jdequant.dequant_mix_flat, x, est, q, scale, ops, est)
    own_advance = q.astype(np.float32) * scale / T
    np.testing.assert_allclose(wrapper_d - got_d, own_advance, **TOL)
    assert np.abs(own_advance).max() > 1e-3


def test_per_leaf_scales_apply_to_their_columns():
    """Several leaves: each column is advanced by its own leaf's scale, the
    columns past the last leaf (row padding) by the last leaf's."""
    n, offsets = 30, (0, 7, 8, 21, 27)
    x, est, q, scale, ops = _random_case(3, n, seed=9, num_leaves=4)
    m1, d1, got_e = _port(x, est, q, scale, ops, offsets)
    leaf_of = np.searchsorted(np.asarray(offsets[:-1]), np.arange(n), side="right") - 1
    np.testing.assert_array_equal(got_e, est + q.astype(np.float32) * scale[:, leaf_of])
    # and the mix equals the no-payload mix of those advanced estimates
    m2, d2, _ = tdequant.dequant_mix_stacked(
        torch.as_tensor(x), torch.as_tensor(got_e), None, None, ops, offsets, T)
    np.testing.assert_array_equal(m1, m2.numpy())
    np.testing.assert_array_equal(d1, d2.numpy())


def test_zero_beta_keeps_zero_d():
    """The no-neighbor guard reads the RAW beta sum: d is exactly zero for a
    zero beta row even when the payload scales are nonzero."""
    x, est, q, scale, ops = _random_case(3, 256, seed=11)
    beta = ops.beta.clone()
    beta[2] = 0.0
    ops = ops._replace(beta=beta)
    _, got_d, _ = _port(x, est, q, np.full_like(scale, 0.05), ops, (0, 256))
    assert np.array_equal(got_d[2], np.zeros(256, np.float32))
    assert np.abs(got_d[1]).max() > 0


def test_zero_scale_ignores_payload():
    """scale = 0 (an all-zero difference) drops the payload: the mix runs on
    the bare estimates, and the estimate does not move."""
    x, est, q, scale, ops = _random_case(2, 128, seed=12)
    zero = np.zeros_like(scale)
    got_m, got_d, got_e = _port(x, est, q, zero, ops, (0, 128))
    np.testing.assert_array_equal(got_e, est)
    want_m, want_d = _reference_per_peer(jref.dequant_mix_ref, x, est, np.zeros_like(q), zero,
                                         ops, est)
    np.testing.assert_allclose(got_m, want_m, **TOL)
    np.testing.assert_allclose(got_d, want_d, **TOL)


def test_padding_slots_and_columns_stay_exact():
    """Padded slots (own index, weight 0) add exactly +-0.0, and the 2NN row's
    padding columns stay exactly 0 in every output."""
    task = ttask.get_task("mnist_mlp")
    layout = tp2p.ParamLayout.of(task)
    g = tgraph.build_graph("star", 8)
    sizes = np.arange(1, 9) * 10
    w, beta = tgraph.mixing_matrix(g, data_sizes=sizes), tgraph.affinity_matrix(g, data_sizes=sizes)
    tight = tops.sparse_from_matrices(w, beta)
    padded = tops.sparse_from_matrices(w, beta, dmax=9)
    rng = np.random.default_rng(13)
    x = torch.zeros(8, layout.row)
    est = torch.zeros(8, layout.row)
    q = torch.zeros(8, layout.row, dtype=torch.int8)
    x[:, :layout.size] = torch.as_tensor(rng.normal(size=(8, layout.size)).astype(np.float32))
    est[:, :layout.size] = torch.as_tensor(rng.normal(size=(8, layout.size)).astype(np.float32))
    q[:, :layout.size] = torch.as_tensor(rng.integers(-127, 128, (8, layout.size)).astype(np.int8))
    scale = torch.as_tensor(rng.uniform(0, 0.01, (8, 6)).astype(np.float32))
    outs = [tdequant.dequant_mix_stacked(x, est, q, scale, o, layout.leaf_offsets, T)
            for o in (tight, padded)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
        assert torch.all(a[:, layout.size:] == 0)


def test_wrapper_rejects_bad_operands():
    x, est, q, scale, ops = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                             for a in _random_case(2, 16, seed=1))
    call = lambda **kw: tdequant.dequant_mix_stacked(  # noqa: E731
        *[kw.get(name, dflt) for name, dflt in (("x", x), ("est", est), ("q", q),
                                                 ("scale", scale), ("ops", ops),
                                                 ("offs", (0, 16)))], T)
    with pytest.raises(ValueError, match="q and scale"):
        call(scale=None)
    with pytest.raises(ValueError, match="scale must be"):
        call(offs=(0, 8, 16))
    with pytest.raises(ValueError, match="leaf_offsets"):
        call(offs=(0, 17))
    with pytest.raises(ValueError, match="q must be"):
        call(q=q.to(torch.int32))
    with pytest.raises(ValueError, match="est must be"):
        call(est=est[:, :8])
    with pytest.raises(ValueError, match="nbr_idx"):
        call(ops=ops._replace(nbr_idx=ops.nbr_idx + 3))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tdequant.dequant_mix_stacked(x.to("meta"), est, q, scale, ops, (0, 16), T)


def test_vector_path_needs_aligned_leaves():
    layout = tp2p.ParamLayout.of(ttask.get_task("mnist_mlp"))
    x = torch.zeros(2, layout.row)
    q = torch.zeros(2, layout.row, dtype=torch.int8)
    assert tdequant.takes_vector_path(layout.leaf_offsets, x, q)
    assert not tdequant.takes_vector_path((0, 7, 16), torch.zeros(2, 16))
    assert not tdequant.takes_vector_path((0, 8, 15), torch.zeros(2, 15))


def test_cpu_wrapper_counts_no_launch_and_has_no_fallback():
    tdequant.launches.reset()
    x, est, q, scale, ops = _random_case(2, 33, seed=2)
    for _ in range(3):
        _port(x, est, q, scale, ops, (0, 33))
    assert tdequant.launches.count == 0
    tree = ast.parse(Path(tdequant.__file__).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
    assert tdequant.max_slots(6) >= 99  # iid_k100's complete graph fits


GRAPHS = [("complete", 100, None), ("star", 8, None), ("ring", 8, 3)]


def _graph_operands(topology, k, dmax):
    """A graph's float64 W and Beta, and its padded slot table."""
    g = tgraph.build_graph(topology, k)
    sizes = np.arange(1, k + 1) * 10
    w = tgraph.mixing_matrix(g, "data_weighted", data_sizes=sizes)
    beta = tgraph.affinity_matrix(g, data_sizes=sizes)
    return w, beta, tops.sparse_from_matrices(w, beta, dmax=dmax)


@pytest.mark.parametrize("topology,k,dmax", GRAPHS)
def test_dense_operator_is_w_off_and_beta(topology, k, dmax):
    """The column-tile kernel's table: [W_off; Beta] from the slot table, padding
    slots (ring K=8 padded to 3 slots) adding nothing."""
    w, beta, ops = _graph_operands(topology, k, dmax)
    dense = tref.dense_mix_operator(ops.nbr_idx, ops.nbr_w, ops.beta).numpy()
    want = np.concatenate([w - np.diag(np.diag(w)), beta]).astype(np.float32)
    assert dense.shape == (2 * k, k)
    np.testing.assert_array_equal(dense, want)


@pytest.mark.parametrize("topology,k,dmax", GRAPHS)
def test_dense_operator_product_matches_plain(topology, k, dmax):
    """[W_off; Beta] times the advanced estimates gives the plain version's sums."""
    _, _, ops = _graph_operands(topology, k, dmax)
    n, offsets = 257, (0, 100, 101, 250)
    rng = np.random.default_rng(k)
    x, est = (torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32)) for _ in range(2))
    q = torch.as_tensor(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    scale = torch.as_tensor(rng.uniform(0.0, 0.1, size=(k, 3)).astype(np.float32))
    mixed, d, adv = tref.dequant_mix_stacked_ref(x, est, q, scale, offsets, *ops, T)
    dense = tref.dense_mix_operator(ops.nbr_idx, ops.nbr_w, ops.beta)
    sums = dense @ adv
    torch.testing.assert_close(ops.self_w[:, None] * x + sums[:k], mixed, **TOL)
    has = ops.beta.sum(dim=1) > 0
    torch.testing.assert_close(torch.where(has[:, None], (sums[k:] - adv) / T, 0.0), d, **TOL)


@pytest.mark.parametrize("k,tile", [(2, True), (8, True), (100, True), (128, True),
                                    (129, False), (4096, False)])
def test_tile_path_rule(k, tile):
    """Up to the cap (128 peers) the column-tile design, above it the gather;
    the CUDA source's cap is the wrapper's."""
    assert tdequant.takes_tile_path(k) is tile
    src = Path(tdequant.SOURCES[0]).read_text()
    assert f"constexpr int kTileMaxPeers = {tdequant.TILE_MAX_PEERS};" in src

"""Port parity, the fused consensus step: the plain stacked PyTorch version
(``repro_torch.kernels.consensus_mix.ref``, which ``ops.consensus_mix_stacked``
runs for CPU tensors) against the reference's oracle per peer and against the
reference's Pallas wrapper run in interpret mode, as tests/test_kernels.py
runs it.  The CUDA kernel itself is held to this plain version on the card by
chip_smoke.py.

Tolerance: float32 atol 5e-5 / rtol 1e-4, tests/test_kernels.py's.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.consensus_mix import ops as jops  # noqa: E402
from repro.kernels.consensus_mix import ref as jref  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_mix import ref as tref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
T = 10


def _random_case(k, d, n, seed):
    """K = d + 1 peers on the complete graph with random row weights."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(k, n)).astype(np.float32)
    idx = np.stack([np.delete(np.arange(k), i)[rng.permutation(k - 1)][:d]
                    for i in range(k)]).astype(np.int32)
    w = rng.dirichlet(np.ones(d + 1), size=k).astype(np.float32)
    beta = rng.dirichlet(np.ones(d), size=k).astype(np.float32)
    return flat, w[:, 0].copy(), idx, w[:, 1:].copy(), beta


def _port(flat, self_w, idx, nbr_w, beta):
    ops = tops.SparseOperands(*(torch.as_tensor(a) for a in (self_w, idx, nbr_w, beta)))
    mixed, d = tops.consensus_mix_stacked(torch.as_tensor(flat), ops, T)
    return mixed.numpy(), d.numpy()


SHAPES = [(n, d) for n in (64, 257, 199_210) for d in (1, 3)] + [(257, 99)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_matches_reference_oracle_per_peer(n, d):
    flat, self_w, idx, nbr_w, beta = _random_case(d + 1, d, n, seed=n + d)
    got_m, got_d = _port(flat, self_w, idx, nbr_w, beta)
    want_m, want_d = jax.vmap(lambda x, nb, sw, wn, bt: jref.consensus_mix_ref(
        x, nb, sw, wn, bt, T))(
        jnp.asarray(flat), jnp.asarray(flat[idx]), jnp.asarray(self_w),
        jnp.asarray(nbr_w), jnp.asarray(beta))
    np.testing.assert_allclose(got_m, np.asarray(want_m), **TOL)
    np.testing.assert_allclose(got_d, np.asarray(want_d), **TOL)


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_matches_reference_pallas_interpret(n, d):
    flat, self_w, idx, nbr_w, beta = _random_case(d + 1, d, n, seed=7 * n + d)
    got_m, got_d = _port(flat, self_w, idx, nbr_w, beta)
    want_m, want_d = jops.consensus_mix_stacked(
        jnp.asarray(flat), jnp.asarray(self_w), jnp.asarray(idx), jnp.asarray(nbr_w),
        jnp.asarray(beta), T, interpret=True)
    np.testing.assert_allclose(got_m, np.asarray(want_m), **TOL)
    np.testing.assert_allclose(got_d, np.asarray(want_d), **TOL)


def _ring_operands(dmax, zero_beta_row=None):
    g = tgraph.build_graph("ring", 8)
    sizes = np.arange(1, 9) * 10
    w = tgraph.mixing_matrix(g, data_sizes=sizes)
    beta = tgraph.affinity_matrix(g, data_sizes=sizes)
    if zero_beta_row is not None:
        beta[zero_beta_row] = 0.0
    return w, beta, tops.sparse_from_matrices(w, beta, dmax=dmax)


def test_padded_slots_add_exact_zero():
    flat = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 1001)).astype(np.float32))
    w, beta, tight = _ring_operands(dmax=None)
    _, _, padded = _ring_operands(dmax=5)
    assert tight.nbr_idx.shape == (8, 2) and padded.nbr_idx.shape == (8, 5)
    assert torch.equal(padded.nbr_idx[:, 2:], torch.arange(8, dtype=torch.int32)[:, None]
                       .expand(8, 3))
    got_tight = tops.consensus_mix_stacked(flat, tight, T)
    got_padded = tops.consensus_mix_stacked(flat, padded, T)
    for a, b in zip(got_tight, got_padded):
        assert torch.equal(a, b)  # weight-0 self slots contribute exactly +-0.0
    # and both equal the reference's dense oracle
    want = jref.segment_mix_ref(jnp.asarray(flat.numpy()), jnp.asarray(w, jnp.float32),
                                jnp.asarray(beta, jnp.float32), T)
    for g, ww in zip(got_padded, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), **TOL)


def test_zero_beta_row_keeps_d_zero():
    flat = np.random.default_rng(1).normal(size=(8, 300)).astype(np.float32)
    w, beta, ops = _ring_operands(dmax=3, zero_beta_row=3)
    mixed, d = tops.consensus_mix_stacked(torch.as_tensor(flat), ops, T)
    assert torch.all(d[3] == 0)
    assert torch.any(d[2] != 0)
    want = jref.segment_mix_ref(jnp.asarray(flat), jnp.asarray(w, jnp.float32),
                                jnp.asarray(beta, jnp.float32), T)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(want[1]), **TOL)


def test_constant_preserving():
    # row-stochastic mixing of identical params is the identity, and d = 0
    flat = torch.full((5, 512), 3.25)
    g = tgraph.build_graph("complete", 5)
    w = tgraph.mixing_matrix(g, data_sizes=np.array([1, 2, 3, 4, 5]))
    ops = tops.sparse_from_matrices(w, tgraph.affinity_matrix(g))
    mixed, d = tops.consensus_mix_stacked(flat, ops, 5)
    np.testing.assert_allclose(mixed.numpy(), 3.25, rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("topology,k", [("complete", 2), ("ring", 8), ("star", 6)])
def test_dense_mix_matches_sparse(topology, k):
    g = tgraph.build_graph(topology, k)
    sizes = np.arange(1, k + 1) * 25
    w = tgraph.mixing_matrix(g, data_sizes=sizes)
    beta = tgraph.affinity_matrix(g, data_sizes=sizes)
    flat = torch.as_tensor(np.random.default_rng(k).normal(size=(k, 777)).astype(np.float32))
    mixed, d = tops.consensus_mix_stacked(flat, tops.sparse_from_matrices(w, beta), T)
    w32, beta32 = (torch.as_tensor(m, dtype=torch.float32) for m in (w, beta))
    dense_mixed = tconsensus.mix_stacked(w32, flat)
    dense_d = (tconsensus.mix_stacked(beta32, flat) - flat) / T
    dense_d[beta32.sum(dim=1) == 0] = 0.0
    np.testing.assert_allclose(mixed.numpy(), dense_mixed.numpy(), **TOL)
    np.testing.assert_allclose(d.numpy(), dense_d.numpy(), **TOL)


@pytest.mark.parametrize("k", [2, 7])
def test_drift_metrics_match_reference(k):
    from repro.core import consensus as jconsensus

    flat = np.random.default_rng(k).normal(size=(k, 2000)).astype(np.float32)
    tree = {"a": jnp.asarray(flat[:, :1500].reshape(k, 30, 50)), "b": jnp.asarray(flat[:, 1500:])}
    np.testing.assert_allclose(float(tconsensus.consensus_error(torch.as_tensor(flat))),
                               float(jconsensus.consensus_error(tree)), **TOL)
    np.testing.assert_allclose(float(tconsensus.pairwise_drift(torch.as_tensor(flat))),
                               float(jconsensus.pairwise_drift(tree)), **TOL)


def test_sparse_from_matrices_matches_reference():
    g = tgraph.build_graph("ring", 6)
    w = tgraph.mixing_matrix(g, data_sizes=np.arange(1, 7))
    beta = tgraph.affinity_matrix(g, data_sizes=np.arange(1, 7))
    for dmax in (None, 4):
        got = tops.sparse_from_matrices(w, beta, dmax=dmax)
        want = jops.sparse_from_matrices(w, beta, dmax=dmax)
        for gg, ww in zip(got, want):
            np.testing.assert_array_equal(gg.numpy(), np.asarray(ww))
        assert got.nbr_idx.dtype == torch.int32 and got.beta.dtype == torch.float32


def test_wrapper_rejects_bad_operands():
    g = tgraph.build_graph("ring", 4)
    ops = tops.sparse_from_matrices(tgraph.mixing_matrix(g), tgraph.affinity_matrix(g))
    flat = torch.zeros(4, 16)
    with pytest.raises(TypeError, match="float32"):
        tops.consensus_mix_stacked(flat.double(), ops, T)
    with pytest.raises(ValueError, match="contiguous"):
        tops.consensus_mix_stacked(torch.zeros(16, 4).T, ops, T)
    with pytest.raises(ValueError, match="nbr_idx"):
        tops.consensus_mix_stacked(flat, ops._replace(nbr_idx=ops.nbr_idx + 4), T)
    with pytest.raises(ValueError, match="self_w"):
        tops.consensus_mix_stacked(torch.zeros(3, 16), ops, T)


@pytest.mark.parametrize("k,tile", [(2, False), (8, False), (15, False), (16, True), (100, True),
                                    (128, True), (129, False), (4096, False)])
def test_tile_path_rule(k, tile):
    """From 16 peers (below them the gather design is faster) up to the cap
    (128, whose dense table fits shared memory) the column-tile design, the
    gather elsewhere; the CUDA source's cap is the wrapper's."""
    assert tops.takes_tile_path(k) is tile
    src = Path(tops.SOURCES[0]).read_text()
    assert f"constexpr int kTileMaxPeers = {tops.TILE_MAX_PEERS};" in src


@pytest.mark.parametrize("topology,k,dmax,self_only_w", [
    ("complete", 100, None, False), ("star", 8, None, False), ("ring", 8, 3, False),
    ("complete", 100, None, True)])
def test_dense_operator_product_matches_plain(topology, k, dmax, self_only_w):
    """The column-tile kernel's sums: [W_off; Beta] times x gives the plain
    version's mixed and d, on padded slot tables too; with W = I (no
    off-diagonal weight) the mix is x and d survives."""
    g = tgraph.build_graph(topology, k)
    sizes = np.arange(1, k + 1) * 10
    w = np.eye(k) if self_only_w else tgraph.mixing_matrix(g, "data_weighted", data_sizes=sizes)
    beta = tgraph.affinity_matrix(g, data_sizes=sizes)
    ops = tops.sparse_from_matrices(w, beta, dmax=dmax)
    x = torch.as_tensor(np.random.default_rng(k).normal(size=(k, 257)).astype(np.float32))
    mixed, d = tref.consensus_mix_stacked_ref(x, *ops, T)
    sums = tref.dense_mix_operator(ops.nbr_idx, ops.nbr_w, ops.beta) @ x
    torch.testing.assert_close(ops.self_w[:, None] * x + sums[:k], mixed, **TOL)
    has = ops.beta.sum(dim=1) > 0
    torch.testing.assert_close(torch.where(has[:, None], (sums[k:] - x) / T, 0.0), d, **TOL)
    if self_only_w:
        assert torch.equal(mixed, x) and float(d.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# bf16 parameters (a bf16 language model's consensus)
# ---------------------------------------------------------------------------

BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # tests/test_kernels.py's bf16 tolerance


@pytest.mark.parametrize("n,d", [(64, 1), (257, 3), (4096, 5)])
def test_bf16_plain_matches_reference_pallas_interpret(n, d):
    """bf16 x: float32 sums, mixed and d cast back to bf16, the weights
    float32 (the reference kernel's ``_kernel``), against the reference's
    Pallas wrapper in interpret mode, as ``test_consensus_mix_sweep`` runs
    it in bf16."""
    flat, self_w, idx, nbr_w, beta = _random_case(d + 1, d, n, seed=11 * n + d)
    x = torch.as_tensor(flat).to(torch.bfloat16)
    ops = tops.SparseOperands(*(torch.as_tensor(a) for a in (self_w, idx, nbr_w, beta)))
    got_m, got_d = tops.consensus_mix_stacked(x, ops, T)
    assert got_m.dtype == got_d.dtype == torch.bfloat16
    want_m, want_d = jops.consensus_mix_stacked(
        jnp.asarray(flat, jnp.bfloat16), jnp.asarray(self_w), jnp.asarray(idx),
        jnp.asarray(nbr_w), jnp.asarray(beta), T, interpret=True)
    assert want_m.dtype == jnp.bfloat16
    np.testing.assert_allclose(got_m.float().numpy(), np.asarray(want_m, np.float32), **BF16_TOL)
    np.testing.assert_allclose(got_d.float().numpy(), np.asarray(want_d, np.float32), **BF16_TOL)
    # the float32 sums of the bf16 values, rounded once
    want32 = tref.consensus_mix_stacked_ref(x.float(), *ops, T)
    for g, w in zip((got_m, got_d), want32):
        assert torch.equal(g, w.to(torch.bfloat16))


BF16_MODES = {
    "mass": lambda x, pub, mass, ops, w, beta: tops.consensus_mix_push_sum_stacked(
        x, mass, ops, T),
    "snapshot": lambda x, pub, mass, ops, w, beta: tops.consensus_mix_snapshot_stacked(
        x, pub, ops, T),
    "mass_snapshot": lambda x, pub, mass, ops, w, beta:
        tops.consensus_mix_push_sum_snapshot_stacked(x, pub, mass, ops, T),
    "dense": lambda x, pub, mass, ops, w, beta: tops.consensus_mix_dense(x, w, beta, T),
}


@pytest.mark.parametrize("mode", list(BF16_MODES))
def test_bf16_in_every_mode(mode):
    """Every mode takes a bf16 buffer (a bf16 model's parameters under
    push-sum, bounded staleness and adaptive selection): its outputs bf16
    (the new mass float32), each the float32 sums of the bf16 values rounded
    once; a float16 buffer is refused.  Each mode is held to the reference
    in tests/test_torch_bf16_modes.py."""
    g = tgraph.build_graph("complete", 4)
    w, beta = tgraph.mixing_matrix(g), tgraph.affinity_matrix(g)
    ops = tops.sparse_from_matrices(w, beta)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(4, 24)).astype(np.float32)).to(torch.bfloat16)
    pub = (x.float() + 0.1).to(torch.bfloat16)
    mass = torch.as_tensor([0.5, 1.0, 1.5, 1.0])
    wt, bt = (torch.as_tensor(m, dtype=torch.float32) for m in (w, beta))
    got = BF16_MODES[mode](x, pub, mass, ops, wt, bt)
    want = BF16_MODES[mode](x.float(), pub.float(), mass, ops, wt, bt)
    for g_out, w_out in zip(got, want):
        if g_out.dtype == torch.float32:  # the new mass
            assert torch.equal(g_out, w_out)
        else:
            assert g_out.dtype == torch.bfloat16 and torch.equal(g_out, w_out.to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        BF16_MODES[mode](x.half(), pub.half(), mass, ops, wt, bt)


def test_vector_path_rule_sees_bf16_rows():
    """The gather's vector path loads 16 bytes a thread: 4 float32 or 8 bf16
    elements, so a bf16 row of 4 mod 8 elements takes the scalar path where
    a float32 row of as many elements does not; the CUDA source's rule."""
    f32 = torch.zeros(4, 1004)
    assert tops.vector_width(f32) == 4
    assert tops.vector_width(f32.bfloat16()) == 1
    assert tops.vector_width(torch.zeros(4, 1008, dtype=torch.bfloat16)) == 8
    off = torch.zeros(4 * 1008 + 4, dtype=torch.bfloat16)[4:].view(4, 1008)  # 8 bytes off
    assert tops.vector_width(off) == 1
    src = Path(tops.SOURCES[0]).read_text()
    assert "const bool vec8 = n % 8 == 0 && aligned16(x)" in src
    assert "const bool vec4 = n % 4 == 0 && aligned16(x)" in src

"""Port parity, the segment-sum consensus step: the plain stacked PyTorch
version (``ref.segment_mix_stacked_ref``, which ``segment.segment_mix_stacked``
and ``segment_mix_schedule`` run for CPU tensors) against the reference's
Pallas wrappers of the same names, run in interpret mode as
tests/test_kernels.py runs them, and against the dense oracle
``ref.segment_mix_ref`` of both packages.  The slot forms of
``core.consensus`` are held to the reference's.  The CUDA kernel itself is
held to this plain version on the card by chip_smoke.py, on both of its
routes (the column tile from 16 to 128 peers, a persistent gather
elsewhere); here ``kernel_route`` is held to the CUDA source's constants,
and the plain version to the reference at the shapes where the routes
meet (K = 100, 128 and 129, and K = 32 at a degree bound past K; the mass
mode at K = 100).

Tolerance: float32 atol 5e-5 / rtol 1e-4, tests/test_kernels.py's: the
slot-ordered sums reduce in another order than the dense products.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import consensus as jconsensus  # noqa: E402
from repro.kernels.consensus_mix import ref as jref  # noqa: E402
from repro.kernels.consensus_mix import segment as jseg  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_mix import ref as tref  # noqa: E402
from repro_torch.kernels.consensus_mix import segment as tseg  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
T = 5


def _sparse(k, seed, *, degree_bound=None):
    """tests/test_kernels.py's case: a ring with dropped links, 3 rounds,
    random data sizes, step size 0.8."""
    cfg = tp2p.P2PConfig(num_peers=k, topology="ring", schedule="link_dropout",
                         schedule_rounds=3)
    sizes = np.random.default_rng(seed).integers(5, 30, size=k)
    return tgraph.SparseSchedule.from_schedule(
        tp2p.build_schedule(cfg), "data_weighted", data_sizes=sizes,
        consensus_step_size=0.8, degree_bound=degree_bound)


def _flat(k, n, seed):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


def _jax_round_ops(sp, r):
    return (jnp.asarray(sp.self_w[r], jnp.float32), jnp.asarray(sp.nbr_idx[r]),
            jnp.asarray(sp.nbr_w[r], jnp.float32), jnp.asarray(sp.beta[r], jnp.float32))


@pytest.mark.parametrize("k,n", [(8, 64), (16, 300), (8, 1000)])
def test_plain_matches_reference_kernel_and_dense_oracles(k, n):
    sp = _sparse(k, seed=k + n)
    w_np, b_np = sp.to_dense()
    flat = _flat(k, n, seed=n)
    ops_s = tops.upload_schedule(sp)
    for r in range(sp.period):
        got = tseg.segment_mix_stacked(torch.as_tensor(flat), tops.select_round(ops_s, r), T)
        jm, jd = jseg.segment_mix_stacked({"w": jnp.asarray(flat)}, *_jax_round_ops(sp, r), T)
        dense = jref.segment_mix_ref(jnp.asarray(flat), jnp.asarray(w_np[r], jnp.float32),
                                     jnp.asarray(b_np[r], jnp.float32), T)
        tdense = tref.segment_mix_ref(torch.as_tensor(flat), torch.as_tensor(w_np[r]),
                                      torch.as_tensor(b_np[r]), T)
        for want in ((jm["w"], jd["w"]), dense, tdense):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("round_idx", [0, 4, 17])
def test_schedule_selects_the_round(round_idx):
    k, n = 8, 128
    sp = _sparse(k, seed=3)
    flat = _flat(k, n, seed=4)
    stacks = (jnp.asarray(sp.self_w, jnp.float32), jnp.asarray(sp.nbr_idx),
              jnp.asarray(sp.nbr_w, jnp.float32), jnp.asarray(sp.beta, jnp.float32))
    jm, jd = jseg.segment_mix_schedule({"w": jnp.asarray(flat)}, jnp.int32(round_idx),
                                       *stacks, T)
    gm, gd = tseg.segment_mix_schedule(torch.as_tensor(flat), round_idx,
                                       tops.upload_schedule(sp), T)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jm["w"]), **TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jd["w"]), **TOL)


def test_tight_and_padded_operands_are_bitwise_equal():
    """Padding slots (own index, weight 0) add exactly +-0.0."""
    k, n = 8, 257
    tight = tops.upload_schedule(_sparse(k, seed=5))
    padded = tops.upload_schedule(_sparse(k, seed=5, degree_bound=k - 1))
    assert tight.nbr_idx.shape[2] < padded.nbr_idx.shape[2] == k - 1
    flat = torch.as_tensor(_flat(k, n, seed=6))
    for r in range(3):
        for g, w in zip(tseg.segment_mix_schedule(flat, r, padded, T),
                        tseg.segment_mix_schedule(flat, r, tight, T)):
            assert torch.equal(g, w)


def test_zero_beta_row_keeps_d_exactly_zero():
    """A peer with an all-zero beta row (isolated this round) keeps d = 0."""
    flat = torch.as_tensor(_flat(4, 128, seed=7))
    ops = tops.SparseOperands(
        torch.tensor([1.0, 0.4, 0.4, 0.7]),
        torch.tensor([[0, 0], [0, 2], [1, 3], [2, 2]], dtype=torch.int32),
        torch.tensor([[0, 0], [0.3, 0.3], [0.3, 0.3], [0.3, 0]]),
        torch.tensor([[0, 0], [0.5, 0.5], [0.5, 0.5], [1.0, 0]]),
    )
    mixed, d = tseg.segment_mix_stacked(flat, ops, T)
    assert bool((d[0] == 0).all()) and float(d[1:].abs().max()) > 0
    assert torch.equal(mixed[0], flat[0])
    _, jd = jseg.segment_mix_stacked({"w": jnp.asarray(flat.numpy())},
                                     *(jnp.asarray(t.numpy()) for t in ops), T)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd["w"]), **TOL)


def test_slot_forms_match_reference():
    k, d = 6, 3
    rng = np.random.default_rng(8)
    x = rng.normal(size=(k, 5, 8)).astype(np.float32)
    idx = rng.integers(0, k, size=(k, d)).astype(np.int32)
    self_w = rng.uniform(size=k).astype(np.float32)
    nbr_w = rng.uniform(size=(k, d)).astype(np.float32)
    gathered = tconsensus.ring_gather_slots(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(gathered.numpy(), x[idx])
    np.testing.assert_allclose(
        tconsensus.mix_slots(torch.as_tensor(self_w), torch.as_tensor(nbr_w),
                             torch.as_tensor(x), gathered).numpy(),
        np.asarray(jconsensus.mix_slots(jnp.asarray(self_w), jnp.asarray(nbr_w),
                                        jnp.asarray(x), jnp.asarray(x[idx]))), **TOL)
    np.testing.assert_allclose(
        tconsensus.slot_sum(torch.as_tensor(nbr_w), gathered).numpy(),
        np.asarray(jconsensus.slot_sum(jnp.asarray(nbr_w), jnp.asarray(x[idx]))), **TOL)


def test_wrapper_takes_any_degree_bound():
    """D = 4097 slots: past consensus_mix's staged-slot limit, which refuses
    it; the segment wrapper takes every D a SparseSchedule produces."""
    k = 4098
    sched = tgraph.static_schedule(tgraph.build_graph("ring", k))
    ops = tops.select_round(tops.upload_schedule(
        tgraph.SparseSchedule.from_schedule(sched, degree_bound=k - 1)), 0)
    assert ops.nbr_idx.shape[1] == k - 1 > tops.MAX_SLOTS
    flat = torch.as_tensor(_flat(k, 3, seed=9))
    mixed, d = tseg.segment_mix_stacked(flat, ops, T)
    want = tref.consensus_mix_stacked_ref(flat, *ops, T)
    torch.testing.assert_close(mixed, want[0], **TOL)
    torch.testing.assert_close(d, want[1], **TOL)
    with pytest.raises(ValueError, match="slots"):
        tops.consensus_mix_stacked(flat, ops, T)


def test_wrapper_rejects_bad_operands():
    ops_s = tops.upload_schedule(_sparse(8, seed=10))
    flat = torch.zeros(8, 16)
    with pytest.raises(TypeError, match="float32"):
        tseg.segment_mix_schedule(flat.double(), 0, ops_s, T)
    with pytest.raises(ValueError, match="contiguous"):
        tseg.segment_mix_schedule(torch.zeros(16, 8).T, 0, ops_s, T)
    with pytest.raises(ValueError, match="period"):
        tseg.segment_mix_schedule(flat, 0, ops_s._replace(self_w=ops_s.self_w[:1]), T)
    with pytest.raises(ValueError, match=r"\(R, K\)"):
        tseg.segment_mix_schedule(flat, 0, tops.select_round(ops_s, 0), T)
    bad = ops_s.nbr_idx.clone()
    bad[2, 3, 0] = 8  # out of range in a round other than the first
    with pytest.raises(ValueError, match="nbr_idx"):
        tseg.segment_mix_schedule(flat, 0, ops_s._replace(nbr_idx=bad), T)
    with pytest.raises(ValueError, match="local_steps"):
        tseg.segment_mix_schedule(flat, 0, ops_s, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tseg.segment_mix_schedule(flat.to("meta"), 0, ops_s, T)


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    tseg.launches.reset()
    ops_s = tops.upload_schedule(_sparse(8, seed=11))
    for r in range(4):
        tseg.segment_mix_schedule(torch.as_tensor(_flat(8, 33, seed=r)), r, ops_s, T)
    assert tseg.launches.count == 0


# The kernel's two routes meet at these shapes: the column tile from
# TILE_MIN_PEERS to TILE_MAX_PEERS peers with K / TILE_MIN_DENSITY to
# TILE_MAX_SLOTS slots, the persistent gather elsewhere.
@pytest.mark.parametrize("k,d,route", [
    (8, 7, "gather"), (15, 14, "gather"), (16, 15, "tile"), (100, 99, "tile"),
    (128, 127, "tile"), (129, 128, "gather"), (4096, 2, "gather"),
    (16, 40, "tile"),  # a degree bound past K: the padding slots scatter +0.0
    (100, 4097, "gather"),  # past TILE_MAX_SLOTS
    (64, 2, "gather"), (128, 42, "gather"), (128, 43, "tile"),  # sparse rows: D < K / 3
])
def test_kernel_route(k, d, route):
    """``kernel_route`` is the CUDA source's rule, on its constants."""
    assert tseg.kernel_route(k, d) == route
    src = Path(tseg.SOURCES[0]).read_text()
    for name, value in (("kTileMinPeers", tseg.TILE_MIN_PEERS),
                        ("kTileMaxPeers", tseg.TILE_MAX_PEERS),
                        ("kTileMinDensity", tseg.TILE_MIN_DENSITY),
                        ("kTileMaxSlots", tseg.TILE_MAX_SLOTS)):
        assert f"constexpr int {name} = {value};" in src
    assert "kTileMinDensity * d_slots >= num_peers" in src
    assert '#include "tile_mix.cuh"' in src
    assert tseg.ROUTES == ("gather", "tile") and "kRouteGather = 0, kRouteTile = 1" in src


def _complete(k, *, stochasticity="row", degree_bound=None):
    sched = tgraph.static_schedule(tgraph.build_graph("complete", k))
    return tgraph.SparseSchedule.from_schedule(
        sched, "data_weighted", data_sizes=np.arange(1, k + 1) * 10,
        stochasticity=stochasticity, degree_bound=degree_bound)


@pytest.mark.parametrize("k,bound", [(100, None), (128, None), (129, None), (32, 34)])
def test_plain_matches_reference_at_the_route_edges(k, bound):
    """At the shapes where the routes meet (the tile's K = 100 main path and
    its cap, the gather just past it, and a tile shape whose degree bound
    exceeds K, so two padding slots a row), the plain version the card
    holds both routes to is held to the reference's Pallas wrapper and to
    both packages' dense oracles."""
    n = 36
    sp = _complete(k, degree_bound=bound)
    assert sp.degree_bound == (k - 1 if bound is None else bound)
    w_np, b_np = sp.to_dense()
    flat = _flat(k, n, seed=k)
    got = tseg.segment_mix_stacked(torch.as_tensor(flat),
                                   tops.select_round(tops.upload_schedule(sp), 0), T)
    jm, jd = jseg.segment_mix_stacked({"w": jnp.asarray(flat)}, *_jax_round_ops(sp, 0), T)
    dense = jref.segment_mix_ref(jnp.asarray(flat), jnp.asarray(w_np[0], jnp.float32),
                                 jnp.asarray(b_np[0], jnp.float32), T)
    tdense = tref.segment_mix_ref(torch.as_tensor(flat), torch.as_tensor(w_np[0]),
                                  torch.as_tensor(b_np[0]), T)
    for want in ((jm["w"], jd["w"]), dense, tdense):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mass_mode_plain_matches_reference_at_k100():
    """``iid_k100 --protocol push_sum`` on the segment runtime (the tile
    route on the card): the mass mode's plain version against the
    reference's ``segment_mix_push_sum_stacked`` and its dense oracle."""
    k, n = 100, 36
    sp = _complete(k, stochasticity="column")
    a_np, b_np = sp.to_dense()
    flat = _flat(k, n, seed=12)
    mass = np.random.default_rng(13).uniform(0.2, 2.0, k).astype(np.float32)
    got = tseg.segment_mix_push_sum_stacked(
        torch.as_tensor(flat), torch.as_tensor(mass),
        tops.select_round(tops.upload_schedule(sp), 0), T)
    jm, jd, jy = jseg.segment_mix_push_sum_stacked({"w": jnp.asarray(flat)}, jnp.asarray(mass),
                                                   *_jax_round_ops(sp, 0), T)
    dense = jref.segment_mix_push_sum_ref(jnp.asarray(flat), jnp.asarray(mass),
                                          jnp.asarray(a_np[0], jnp.float32),
                                          jnp.asarray(b_np[0], jnp.float32), T)
    for want in ((jm["w"], jd["w"], jy), dense):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

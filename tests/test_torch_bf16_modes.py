"""Port parity, the bf16 storage modes of the consensus kernels that a bf16
language model reaches beside the gossip step: each mode's plain version
(``repro_torch.kernels.consensus_mix.ref``, which the wrappers run for CPU
tensors and which chip_smoke.py holds each CUDA mode to on the card) on
bf16 buffers against the reference's oracles in bf16, on the CPU.

- ``consensus_mix``'s mass mode against the reference's Pallas
  ``consensus_mix_push_sum_stacked`` (interpret mode); its snapshot mode,
  gossip against ``ref.consensus_mix_ref`` per peer on the published rows
  and push-sum against ``PushSumProtocol.mix_compressed`` with the
  snapshots for the estimates; the dense-operand mode against
  ``ops.consensus_mix_dense`` and ``consensus_mix_push_sum_dense``;
- ``dequant_mix`` (gossip and mass): the estimates advanced where the
  reference's ``ef_compress_leaf`` rounds them (``bf16(est + bf16(scale *
  q))``, bit for bit from the same payload), the mix against the
  reference's ``mix_compressed`` and d from the advanced estimates;
- ``segment_mix`` (gossip and mass) against ``ref.segment_mix_ref`` and
  ``segment_mix_push_sum_ref`` on bf16 inputs;
- top-k's advance of a bf16 estimate against ``ef_compress_leaf``, bit for
  bit.

Every output keeps bf16 (the new mass float32); tolerance 5e-2, the bf16
tolerance of tests/test_kernels.py, and each mode equals its float32 sums
of the bf16 values rounded once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compression import compressors as jcompressors  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.kernels.consensus_mix import ops as jops  # noqa: E402
from repro.kernels.consensus_mix import ref as jref  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant as tdequant  # noqa: E402
from repro_torch.kernels.consensus_mix import ops as tops  # noqa: E402
from repro_torch.kernels.consensus_mix import ref as tref  # noqa: E402
from repro_torch.kernels.consensus_mix import segment as tsegment  # noqa: E402

# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
MASS_TOL = dict(atol=5e-5, rtol=1e-4)
T = 4


def _close(got: torch.Tensor, want, what: str) -> None:
    assert got.dtype == torch.bfloat16, what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL,
                               err_msg=what)


def _case(topology: str, k: int, n: int, seed: int, *, column: bool = False):
    """bf16 parameters, a positive mass summing to K, and the graph's dense
    (K, K) W / Beta (column-stochastic W with ``column``) with their sparse
    operands."""
    rng = np.random.default_rng(seed)
    g = tgraph.build_graph(topology, k)
    sizes = rng.integers(50, 150, k)
    w = (tgraph.column_stochastic_matrix(g, "data_weighted", data_sizes=sizes) if column
         else tgraph.mixing_matrix(g, "data_weighted", data_sizes=sizes))
    beta = tgraph.affinity_matrix(g, data_sizes=sizes)
    x = rng.normal(size=(k, n)).astype(np.float32)
    y = rng.uniform(0.3, 2.0, k)
    mass = (k * y / y.sum()).astype(np.float32)
    ops = tops.sparse_from_matrices(w, beta)
    return (torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(mass), w, beta, ops, rng)


def _bf16_np(t: torch.Tensor) -> jax.Array:
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("topology,k", [("directed_ring", 8), ("complete", 20)])
def test_consensus_mix_bf16_mass_matches_reference_pallas(topology, k):
    x, mass, w, beta, ops, _ = _case(topology, k, 1031, seed=k, column=True)
    mixed, d, y_new = tops.consensus_mix_push_sum_stacked(x, mass, ops, T)
    j_mixed, j_d, j_y = jops.consensus_mix_push_sum_stacked(
        {"w": _bf16_np(x)}, jnp.asarray(mass.numpy()), *(jnp.asarray(t.numpy()) for t in ops),
        T, interpret=True)
    _close(mixed, j_mixed["w"], "mixed")
    _close(d, j_d["w"], "d")
    np.testing.assert_allclose(y_new.numpy(), np.asarray(j_y), **MASS_TOL)
    # the float32 sums of the bf16 values, divided by y', rounded once
    num, _, want_y = tref.consensus_mix_push_sum_stacked_ref(x.float(), mass, *ops, T)
    assert torch.equal(mixed, num.to(torch.bfloat16)) and torch.equal(y_new, want_y)


@pytest.mark.parametrize("mass_mode", [False, True])
def test_consensus_mix_bf16_snapshot_matches_reference(mass_mode):
    """The neighbor terms read the published snapshots P, the self term and
    d's own term the live x: gossip against the reference's one-peer oracle
    on P's rows, push-sum against ``mix_compressed`` with P as the
    estimates (d as in gossip)."""
    k, n = 8, 517
    x, mass, w, beta, ops, rng = _case("ring", k, n, seed=3 + mass_mode, column=mass_mode)
    pub = (x.float() + torch.as_tensor(0.05 * rng.normal(size=(k, n)), dtype=torch.float32)
           ).to(torch.bfloat16)
    if mass_mode:
        mixed, d, y_new = tops.consensus_mix_push_sum_snapshot_stacked(x, pub, mass, ops, T)
        state, want = jprotocols.get_protocol("push_sum").mix_compressed(
            jprotocols.PushSumState(mass=jnp.asarray(mass.numpy())), {"w": _bf16_np(x)},
            {"w": _bf16_np(pub)}, jprotocols.ProtocolConstants(jnp.asarray(w), jnp.asarray(beta)))
        _close(mixed, want["w"], "mixed")
        np.testing.assert_allclose(y_new.numpy(), np.asarray(state.mass), **MASS_TOL)
    else:
        mixed, d = tops.consensus_mix_snapshot_stacked(x, pub, ops, T)
        idx = ops.nbr_idx.long()
        j_mixed, _ = jax.vmap(lambda xk, nb, sw, wn, bt: jref.consensus_mix_ref(
            xk, nb, sw, wn, bt, T))(_bf16_np(x), _bf16_np(pub[idx]),
                                    *(jnp.asarray(t.numpy()) for t in (ops.self_w, ops.nbr_w,
                                                                       ops.beta)))
        _close(mixed, j_mixed, "mixed")
    has = beta.sum(axis=1) > 0
    want_d = np.where(has[:, None], (beta @ pub.float().numpy() - x.float().numpy()) / T, 0.0)
    _close(d, want_d, "d")
    want32 = tref.consensus_mix_stacked_ref(x.float(), *ops, T, published=pub.float())
    assert torch.equal(d, want32[1].to(torch.bfloat16))


@pytest.mark.parametrize("mass_mode", [False, True])
def test_consensus_mix_bf16_dense_matches_reference(mass_mode):
    """An adaptive round's dense (K, K) W and Beta, every j != k a candidate
    slot: the reference's ``consensus_mix_dense`` (push-sum: ``_push_sum_dense``)
    on a bf16 tree in interpret mode."""
    k, n = 6, 300
    x, mass, w, beta, _, _ = _case("complete", k, n, seed=7, column=mass_mode)
    wt, bt = torch.as_tensor(w, dtype=torch.float32), torch.as_tensor(beta, dtype=torch.float32)
    jw, jb = jnp.asarray(w, jnp.float32), jnp.asarray(beta, jnp.float32)
    if mass_mode:
        mixed, d, y_new = tops.consensus_mix_push_sum_dense(x, mass, wt, bt, T)
        j_mixed, j_d, j_y = jops.consensus_mix_push_sum_dense(
            {"w": _bf16_np(x)}, jnp.asarray(mass.numpy()), jw, jb, T, interpret=True)
        np.testing.assert_allclose(y_new.numpy(), np.asarray(j_y), **MASS_TOL)
    else:
        mixed, d = tops.consensus_mix_dense(x, wt, bt, T)
        j_mixed, j_d = jops.consensus_mix_dense({"w": _bf16_np(x)}, jw, jb, T, interpret=True)
    _close(mixed, j_mixed["w"], "mixed")
    _close(d, j_d["w"], "d")


def _reference_ef(comp_name: str, x: torch.Tensor, est: torch.Tensor, layout):
    """The reference's ``ef_compress_leaf`` of each leaf in bf16, jitted as
    its rounds run: the advanced estimate of every leaf, flat (K, row)."""
    comp = jcompressors.get_compressor(comp_name, topk_frac=0.1)
    k = x.shape[0]
    out = []
    for name, xv in layout.views(x).items():
        ev = layout.views(est)[name]
        _, new = jax.jit(lambda a, b: jcompressors.ef_compress_leaf(comp, a, b))(
            _bf16_np(xv.reshape(k, -1)), _bf16_np(ev.reshape(k, -1)))
        out.append(np.asarray(new, np.float32))
    flat = np.concatenate(out, axis=1)
    return np.pad(flat, ((0, 0), (0, layout.row - layout.size)))


def _bf16_layout(sizes):
    return tp2p.ParamLayout.block({f"l{i}": (s,) for i, s in enumerate(sizes)}, torch.bfloat16)


@pytest.mark.parametrize("mass_mode", [False, True])
def test_dequant_mix_bf16_matches_reference(mass_mode):
    """A bf16 step of the qint8 wire: the advanced estimates rounded as the
    reference's ``ef_compress_leaf`` rounds them, bit for bit from the same
    payload and within 5e-2 of the reference's own payload's; the mix
    against the reference's ``mix_compressed`` on them (the self term on the
    true x), d from them."""
    layout = _bf16_layout((300, 41, 512, 7))
    k, n = 8, layout.row
    x, mass, w, beta, ops, rng = _case("ring" if not mass_mode else "directed_ring", k, n,
                                       seed=11 + mass_mode, column=mass_mode)
    x[:, layout.size:] = 0
    est = (x.float() + torch.as_tensor(0.02 * rng.normal(size=(k, n)), dtype=torch.float32)
           ).to(torch.bfloat16)
    est[:, layout.size:] = 0
    payload = compression.get_compressor("qint8").ef_flat(x, est, layout)
    offs = layout.leaf_offsets
    if mass_mode:
        mixed, d, adv, y_new = tdequant.dequant_mix_push_sum_stacked(
            x, est, payload.q, payload.scale, mass, ops, offs, T)
    else:
        mixed, d, adv = tdequant.dequant_mix_stacked(x, est, payload.q, payload.scale, ops,
                                                     offs, T)
    assert adv.dtype == torch.bfloat16
    value = (payload.q.float() * tref.leaf_scale_columns(payload.scale, offs, n))
    assert torch.equal(adv, (est.float() + value.to(torch.bfloat16).float()).to(torch.bfloat16))
    _close(adv, _reference_ef("qint8", x, est, layout), "advanced estimates")
    consts = jprotocols.ProtocolConstants(jnp.asarray(w), jnp.asarray(beta))
    if mass_mode:
        state, want = jprotocols.get_protocol("push_sum").mix_compressed(
            jprotocols.PushSumState(mass=jnp.asarray(mass.numpy())), {"w": _bf16_np(x)},
            {"w": _bf16_np(adv)}, consts)
        np.testing.assert_allclose(y_new.numpy(), np.asarray(state.mass), **MASS_TOL)
    else:
        _, want = jprotocols.get_protocol("gossip").mix_compressed((), {"w": _bf16_np(x)},
                                                                    {"w": _bf16_np(adv)}, consts)
    _close(mixed, want["w"], "mixed")
    avg = jconsensus.mix_stacked(jnp.asarray(beta), {"w": _bf16_np(adv)})["w"]
    has = beta.sum(axis=1) > 0
    _close(d, np.where(has[:, None], (np.asarray(avg, np.float32) - adv.float().numpy()) / T, 0),
           "d")


def test_topk_bf16_advance_matches_reference():
    """Top-k on a bf16 stack: the difference and the advanced estimate in
    bf16, as the reference's ``ef_compress_leaf``; the kept values are the
    difference's own, so the advance is bit for bit the reference's."""
    layout = _bf16_layout((300, 41, 512))
    k = 4
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(k, layout.row)), dtype=torch.float32)
    x[:, layout.size:] = 0
    x = x.to(torch.bfloat16)
    est = (x.float() * 0.9).to(torch.bfloat16)
    payload = compression.get_compressor("topk", topk_frac=0.1).ef_flat(x, est, layout)
    assert payload.est.dtype == torch.bfloat16
    want = _reference_ef("topk", x, est, layout)
    np.testing.assert_array_equal(payload.est.float().numpy(), want)


@pytest.mark.parametrize("mass_mode", [False, True])
@pytest.mark.parametrize("topology,k", [("complete", 20), ("ring", 150)])
def test_segment_mix_bf16_matches_reference_oracle(topology, k, mass_mode):
    """The segment runtime's step on a bf16 buffer (either route's shapes:
    a complete graph below the tile cap, a ring above it) against the
    reference's dense oracles on bf16 inputs."""
    x, mass, w, beta, ops, _ = _case(topology, k, 129, seed=k + mass_mode, column=mass_mode)
    ops_s = tops.SparseOperands(*(t[None] for t in ops))
    if mass_mode:
        mixed, d, y_new = tsegment.segment_mix_push_sum_schedule(x, mass, 0, ops_s, T)
        j_mixed, j_d, j_y = jref.segment_mix_push_sum_ref(_bf16_np(x), jnp.asarray(mass.numpy()),
                                                          jnp.asarray(w), jnp.asarray(beta), T)
        np.testing.assert_allclose(y_new.numpy(), np.asarray(j_y), **MASS_TOL)
    else:
        mixed, d = tsegment.segment_mix_schedule(x, 0, ops_s, T)
        j_mixed, j_d = jref.segment_mix_ref(_bf16_np(x), jnp.asarray(w), jnp.asarray(beta), T)
    _close(mixed, j_mixed, "mixed")
    _close(d, j_d, "d")
    if not mass_mode:  # the float32 slot sums of the bf16 values, rounded once
        want = tref.segment_mix_stacked_ref(x.float(), *ops, T)
        assert torch.equal(mixed, want[0].to(torch.bfloat16))

"""Port parity, compressed gossip: the compressors against
``repro.compression`` on identical inputs, their properties (ported from
tests/test_compression.py), the flat-layout error-feedback step against the
reference's leaf-by-leaf one over a 2NN tree, and the compressed consensus
phase against ``repro.core.p2p.consensus_phase`` from one exported state.

Tolerance: float32 atol 5e-5 / rtol 1e-4 (tests/test_kernels.py's).  qint8's
q and scales are compared exactly: both packages divide and round half to
even in float32.  top-k's kept indices are compared exactly, ties included:
both packages order equal magnitudes by index.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compression as jcomp  # noqa: E402
from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import compression as tcomp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
TASK = ttask.get_task("mnist_mlp")
LAYOUT = tp2p.ParamLayout.of(TASK)


def _tree(k, seed):
    return jax.tree.map(np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(
        jax.random.PRNGKey(seed), k)))


def _noisy(tree, rng, scale):
    return jax.tree.map(lambda a: (a + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def test_registry_matches_reference():
    assert tcomp.compressor_names() == jcomp.compressor_names()
    for name in tcomp.compressor_names():
        t, j = tcomp.get_compressor(name, topk_frac=0.3), jcomp.get_compressor(name, topk_frac=0.3)
        assert (t.name, t.identity) == (j.name, j.identity)
    with pytest.raises(ValueError, match="unknown compressor"):
        tcomp.get_compressor("zip")
    with pytest.raises(ValueError):
        tcomp.TopKCompressor(0.0)
    cfg = tp2p.P2PConfig(compressor="topk", topk_frac=0.25)
    assert tcomp.from_config(cfg).frac == 0.25


@pytest.mark.parametrize("n", [1, 7, 10, 200, 2000, 156_800])
def test_topk_keep_matches_reference(n):
    for frac in (0.01, 0.05, 0.25, 0.5, 1.0):
        assert tcomp.TopKCompressor(frac).keep(n) == jcomp.TopKCompressor(frac).keep(n)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 7), (4, 1000)])
def test_qint8_payload_equal(shape):
    rng = np.random.default_rng(sum(shape))
    leaf = (rng.normal(size=shape) * rng.uniform(0.001, 10.0, size=(shape[0],) + (1,) * (
        len(shape) - 1))).astype(np.float32)
    leaf[0] = 0.0  # a zero row: scale 0, q 0
    got = tcomp.QInt8Compressor().compress(torch.as_tensor(leaf))
    # jitted, as the reference's rounds run it: XLA multiplies by 1/127
    want = jax.jit(jcomp.QInt8Compressor().compress)(jnp.asarray(leaf))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.q.dtype == torch.int8
    dec = tcomp.QInt8Compressor().decompress(got, torch.as_tensor(leaf))
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jcomp.QInt8Compressor().decompress(want, jnp.asarray(leaf))))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_payload_keeps_same_indices(frac):
    rng = np.random.default_rng(3)
    leaf = rng.normal(size=(4, 20, 30)).astype(np.float32)
    # ties of nonzero magnitudes (either sign) and zeros, across the boundary
    leaf[:, :5] = np.round(leaf[:, :5], 1)
    leaf[:, 5, :10] = 0.0
    got = tcomp.TopKCompressor(frac).compress(torch.as_tensor(leaf))
    want = jcomp.TopKCompressor(frac).compress(jnp.asarray(leaf))
    assert got.values.shape == want.values.shape
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    dec_t = tcomp.TopKCompressor(frac).decompress(got, torch.as_tensor(leaf))
    dec_j = jcomp.TopKCompressor(frac).decompress(want, jnp.asarray(leaf))
    np.testing.assert_array_equal(dec_t.numpy(), np.asarray(dec_j))


# -- properties, as tests/test_compression.py checks them for the reference --


def test_topk_keeps_exact_count_and_largest():
    comp = tcomp.TopKCompressor(0.25)
    leaf = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32))
    payload = comp.compress(leaf)
    assert payload.values.shape == (2, 4)  # keep(16) = 4
    dec = comp.decompress(payload, leaf)
    for row in range(2):
        kept = set(payload.indices[row].tolist())
        assert kept == set(torch.argsort(-leaf[row].abs())[:4].tolist())
        for i in kept:  # kept coordinates round-trip bit for bit
            assert dec[row, i] == leaf[row, i]


def test_topk_frac_one_is_lossless():
    comp = tcomp.TopKCompressor(1.0)
    leaf = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 4, 5)).astype(np.float32))
    assert torch.equal(comp.decompress(comp.compress(leaf), leaf), leaf)


def test_qint8_error_bounded_by_half_scale():
    comp = tcomp.QInt8Compressor()
    leaf = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32) * 10)
    payload = comp.compress(leaf)
    err = (comp.decompress(payload, leaf) - leaf).abs()
    assert bool((err <= payload.scale / 2.0 + 1e-7).all())


def test_qint8_zero_leaf_safe():
    comp = tcomp.QInt8Compressor()
    leaf = torch.zeros(2, 8)
    payload = comp.compress(leaf)
    assert float(payload.scale.max()) == 0.0
    assert torch.equal(comp.decompress(payload, leaf), torch.zeros(2, 8))


def test_estimate_warm_starts_at_params():
    params = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 12)).astype(np.float32))
    est = tcomp.TopKCompressor(0.25).init_estimate(params)
    assert torch.equal(est, params) and est.data_ptr() != params.data_ptr()
    assert tcomp.NoneCompressor().init_estimate(params) == ()


@pytest.mark.parametrize("name", ["topk", "qint8"])
def test_ef_estimate_converges_on_static_target(name):
    comp = tcomp.get_compressor(name, topk_frac=0.2)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(2, 40)).astype(np.float32))
    est = torch.zeros_like(x)
    errs = []
    for _ in range(60):
        _, est = tcomp.ef_compress_leaf(comp, x, est)
        errs.append(float((x - est).abs().max()))
    assert errs[-1] < 1e-3 * errs[0]


def test_ef_first_payload_is_zero_after_warm_start():
    params = interop.params_from_jax(_tree(3, 5))
    comp = tcomp.TopKCompressor(0.1)
    est = {name: leaf.clone() for name, leaf in params.items()}
    payloads, est2 = tcomp.ef_compress_tree(comp, params, est)
    assert all(float(p.values.abs().max()) == 0.0 for p in payloads)
    assert all(torch.equal(est[n], est2[n]) for n in est)


# -- error feedback over a 2NN tree, leaf form and flat-layout form --


@pytest.mark.parametrize("name", ["topk", "qint8"])
def test_ef_tree_matches_reference(name):
    rng = np.random.default_rng(6)
    x_tree = _tree(3, 6)
    est_tree = _noisy(x_tree, rng, 0.01)
    jc, tc = (mod.get_compressor(name, topk_frac=0.05) for mod in (jcomp, tcomp))
    _, want = jcomp.ef_compress_tree(jc, x_tree, est_tree)
    _, got = tcomp.ef_compress_tree(tc, interop.params_from_jax(x_tree),
                                    interop.params_from_jax(est_tree))
    for name_, value in interop.params_from_jax(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_allclose(got[name_].numpy(), value.numpy(), **TOL, err_msg=name_)


@pytest.mark.parametrize("name", ["topk", "qint8"])
def test_ef_flat_matches_reference_leaf_by_leaf(name):
    """``ef_flat`` over the (K, row) buffers: q and scales per leaf equal the
    reference's, q is 0 on the row's padding, and the advanced estimate is
    allclose to ``ef_compress_tree``'s."""
    rng = np.random.default_rng(7)
    x_tree = _tree(4, 7)
    est_tree = _noisy(x_tree, rng, 0.02)
    jc, tc = (mod.get_compressor(name, topk_frac=0.01) for mod in (jcomp, tcomp))
    # jitted, as the reference's rounds run it (qint8: XLA multiplies by 1/127)
    payloads, want = jax.jit(lambda x_, e_: jcomp.ef_compress_tree(jc, x_, e_))(x_tree,
                                                                              est_tree)
    x = LAYOUT.flatten(interop.params_from_jax(x_tree))
    est = LAYOUT.flatten(interop.params_from_jax(est_tree))
    got = tc.ef_flat(x, est, LAYOUT)
    want_flat = LAYOUT.flatten(interop.params_from_jax(jax.tree.map(np.asarray, want)))
    if name == "qint8":
        assert got.est is est and got.q.shape == x.shape
        assert torch.all(got.q[:, LAYOUT.size:] == 0)
        # jax's leaves run fc1.b, fc1.w, ...; the port's rows fc1.w, fc1.b, ...
        jleaves = dict(zip(sorted(TASK.param_shapes), payloads))
        q_views = LAYOUT.views(got.q)
        for i, name_ in enumerate(TASK.param_shapes):
            np.testing.assert_array_equal(q_views[name_].reshape(4, -1).numpy(),
                                          np.asarray(jleaves[name_].q))
            np.testing.assert_array_equal(got.scale[:, i].numpy(),
                                          np.asarray(jleaves[name_].scale)[:, 0])
        from repro_torch.kernels.consensus_mix import ref
        adv = est + got.q.float() * ref.leaf_scale_columns(got.scale, LAYOUT.leaf_offsets,
                                                           LAYOUT.row)
        np.testing.assert_allclose(adv.numpy(), want_flat.numpy(), **TOL)
    else:
        assert got.q is None and got.scale is None
        np.testing.assert_allclose(got.est.numpy(), want_flat.numpy(), **TOL)
        assert torch.all(got.est[:, LAYOUT.size:] == 0)


# -- the compressed consensus phase, from one exported state --


def _consensus_case(builder, compressor, schedule, **overrides):
    kw = dict(schedule=schedule)
    rep = dict(compressor=compressor, topk_frac=0.05, **overrides)
    jcfg = dataclasses.replace(getattr(jconfigs, builder)(**kw).p2p, **rep)
    tcfg = dataclasses.replace(getattr(tconfigs, builder)(**kw).p2p, **rep)
    return jcfg, tcfg


def _start_state(jcfg, sizes, seed):
    """A reference state mid-run: parameters drifted from their estimates,
    nonzero d and b."""
    rng = np.random.default_rng(seed)
    jstate = jp2p.init_state(jax.random.PRNGKey(seed), jtask.get_task("mnist_mlp"), jcfg,
                             data_sizes=sizes)
    jstate = jax.tree.map(np.asarray, jstate)
    return jstate._replace(params=_noisy(jstate.params, rng, 0.01),
                           d_bias=_noisy(jstate.d_bias, rng, 0.001),
                           b_bias=_noisy(jstate.b_bias, rng, 0.01))


# S=1 at K=8; S=2 (with eta_b) at K=2.  At K=8 the packages sum each row of
# the mix in another order, so step 1 leaves x about 1e-8 apart, and step 2's
# round(diff / scale) then differs by one quantization step on a fraction of
# the coordinates.  At K=2 every mix is one product plus another, summed in
# the same order by both, so step 2 starts from the same state.
CONSENSUS_CASES = [
    (builder, compressor, schedule, steps)
    for compressor in ("topk", "qint8")
    for schedule in ("static", "round_robin", "link_dropout")
    for builder, steps in (("timevarying_k8", 1), ("timevarying_k2", 2))
]


@pytest.mark.parametrize("builder,compressor,schedule,steps", CONSENSUS_CASES)
def test_consensus_phase_matches_reference(builder, compressor, schedule, steps):
    extra = dict(consensus_steps=steps, eta_b=0.1) if steps > 1 else {}
    jcfg, tcfg = _consensus_case(builder, compressor, schedule, **extra)
    k = jcfg.num_peers
    sizes = np.arange(1, k + 1) * 50
    jstate = _start_state(jcfg, sizes, seed=k + steps)
    consts, _ = jp2p.protocol_constants(jcfg, sizes)
    ops = tp2p.round_operands(tcfg, sizes, device="cpu")
    r = 1  # the second round of the period: the star of ring/star, a dropout draw
    want = jp2p.consensus_phase(
        jstate, jcfg, jprotocols.round_constants(consts, r % consts.w.shape[0]))
    got = tp2p.consensus_phase(interop.state_from_jax(jstate, TASK), tcfg, ops[r % len(ops)])
    want = interop.state_from_jax(jax.tree.map(np.asarray, want), TASK)
    assert got.round_idx == want.round_idx
    for field in ("params", "d_bias", "compression"):
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field).numpy(),
                                   **TOL, err_msg=field)
        assert torch.all(getattr(got, field)[:, LAYOUT.size:] == 0)


def test_none_takes_uncompressed_code_path(monkeypatch):
    """compressor='none' never reaches the compression machinery: a round with
    every compressed entry point booby-trapped still runs, through the same
    consensus_mix path as before."""
    def boom(*a, **k):  # pragma: no cover - must never run
        raise AssertionError("compression machinery entered on the none path")

    from repro_torch.core import protocols as tprotocols

    monkeypatch.setattr(tcomp.NoneCompressor, "compress", boom)
    monkeypatch.setattr(tp2p, "_consensus_phase_compressed", boom)
    monkeypatch.setattr(tprotocols.GossipProtocol, "mix_compressed", boom)
    cfg = tconfigs.timevarying_k8(schedule="round_robin").p2p
    state = tp2p.init_state(TASK, cfg, device="cpu")
    assert state.compression == ()
    ops = tp2p.round_operands(cfg, device="cpu")
    out = tp2p.consensus_phase(state, cfg, ops[0])
    assert torch.isfinite(out.params).all()


def test_init_state_warm_starts_estimate_after_max_norm_sync():
    cfg = tconfigs.timevarying_k8(schedule="round_robin", compressor="qint8").p2p
    assert cfg.use_max_norm_init
    state = tp2p.init_state(TASK, cfg, device="cpu", seed=3)
    assert torch.equal(state.compression, state.params)
    assert state.compression.data_ptr() != state.params.data_ptr()
    # max-norm sync: every peer starts from one row
    assert torch.equal(state.params, state.params[:1].expand_as(state.params))


def test_state_from_jax_carries_the_estimate_exactly():
    jcfg, _ = _consensus_case("timevarying_k8", "qint8", "static")
    jstate = _start_state(jcfg, np.arange(1, 9) * 50, seed=11)
    tstate = interop.state_from_jax(jstate, TASK)
    assert tstate.compression.shape == (8, LAYOUT.row)
    got = LAYOUT.views(tstate.compression)
    for name, value in interop.params_from_jax(jstate.compression).items():
        assert torch.equal(got[name], value)
    nocomp = jax.tree.map(np.asarray, jp2p.init_state(
        jax.random.PRNGKey(0), jtask.get_task("mnist_mlp"), dataclasses.replace(
            jcfg, compressor="none"), data_sizes=np.arange(1, 9)))
    assert interop.state_from_jax(nocomp, TASK).compression == ()

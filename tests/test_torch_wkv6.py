"""The port's chunked WKV6 (``repro_torch.kernels.rwkv6``) against the reference.

On the CPU the wrapper ``ops.wkv6`` takes the kernel's plain version
``ref.wkv6_chunked_ref``; these tests hold it to the reference's Pallas
kernel (interpret mode on the CPU, as tests/test_kernels.py runs it), to the
reference's sequential oracle with a nonzero initial state, and to the
reference model's chunk scan at a ragged length.  The CUDA kernel itself is
held to the plain version on the card by ``chip_smoke.py``.

Tolerances: float32 atol = rtol = 1e-3, the wkv6 tolerance of
tests/test_kernels.py (outputs reach ~70 at small decays; sums run in
another order); bf16 atol 0.15 / rtol 0.1, that file's bf16 scan tolerance.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels.rwkv6.ops import wkv6 as jwkv6  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jwkv6_ref  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.rwkv6 import ops, ref  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

F32_TOL = dict(atol=1e-3, rtol=1e-3)
BF16_TOL = dict(atol=0.15, rtol=0.1)
SWEEP = [(64, 2, 32, 16), (32, 4, 16, 8), (48, 1, 64, 48)]  # test_wkv6_sweep's shapes


def _inputs(b, t, h, dk, *, seed=0, ld_const=None, state=False):
    """numpy operands as tests/test_kernels.py draws them (and a state)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, dk)).astype(np.float32) for _ in range(3))
    if ld_const is None:
        ld = -rng.uniform(0.01, 4.0, size=(b, t, h, dk)).astype(np.float32)
    else:
        ld = np.full((b, t, h, dk), ld_const, np.float32)
    u = (rng.normal(size=(h, dk)) * 0.5).astype(np.float32)
    s0 = rng.normal(size=(b, h, dk, dk)).astype(np.float32) if state else None
    return r, k, v, ld, u, s0


def _t(a, dtype=torch.float32):
    return None if a is None else torch.as_tensor(a).to(dtype)


@pytest.mark.parametrize("t,h,dk,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ref_matches_pallas_kernel(t, h, dk, chunk, dtype):
    r, k, v, ld, u, _ = _inputs(2, t, h, dk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jwkv6(*(jnp.asarray(a, jdt) for a in (r, k, v)), jnp.asarray(ld), jnp.asarray(u),
                 chunk=chunk)
    got, final = ops.wkv6(_t(r, tdt), _t(k, tdt), _t(v, tdt), _t(ld), _t(u), chunk=chunk)
    assert got.dtype == tdt and final.dtype == torch.float32  # out in r's type, as Pallas
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    _, want_final = jwkv6_ref(*(jnp.asarray(a, jdt) for a in (r, k, v)), jnp.asarray(ld),
                              jnp.asarray(u))
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("t,chunk", [(64, 16), (37, 8), (5, 16), (33, 64)])
def test_chunked_ref_matches_sequential_oracle_from_a_state(t, chunk):
    """Output and final state from a nonzero initial state, ragged tails included."""
    r, k, v, ld, u, s0 = _inputs(2, t, 3, 32, seed=1, state=True)
    want, want_s = jwkv6_ref(*map(jnp.asarray, (r, k, v, ld, u)), initial_state=jnp.asarray(s0))
    got, got_s = ref.wkv6_chunked_ref(*map(_t, (r, k, v, ld, u, s0)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32_TOL)
    seq, seq_s = ref.wkv6_ref(*map(_t, (r, k, v, ld, u)), initial_state=_t(s0))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(seq_s.numpy(), np.asarray(want_s), **F32_TOL)


def test_wrapper_carries_state_across_calls():
    """Two calls over halves of a sequence, the first's final state fed to
    the second, give the one call over the whole (what prefill relies on)."""
    r, k, v, ld, u, s0 = _inputs(2, 40, 2, 16, seed=2, state=True)
    whole, whole_s = ops.wkv6(*map(_t, (r, k, v, ld, u)), state=_t(s0), chunk=8)
    first, mid = ops.wkv6(*(_t(a[:, :21]) for a in (r, k, v, ld)), _t(u), state=_t(s0), chunk=8)
    second, end = ops.wkv6(*(_t(a[:, 21:]) for a in (r, k, v, ld)), _t(u), state=mid, chunk=8)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, **F32_TOL)
    torch.testing.assert_close(end, whole_s, **F32_TOL)


def test_extreme_decay_stays_finite():
    """ld = -50 a step: the chunked form never takes an exp of a positive
    sum (tests/test_kernels.py:test_wkv6_extreme_decay_no_overflow)."""
    r, k, v, _, _, s0 = _inputs(1, 32, 1, 16, seed=3, state=True)
    ld = np.full(r.shape, -50.0, np.float32)
    u = np.zeros((1, 16), np.float32)
    got, got_s = ops.wkv6(*map(_t, (r, k, v, ld, u)), state=_t(s0), chunk=8)
    assert torch.isfinite(got).all() and torch.isfinite(got_s).all()
    want, want_s = jwkv6_ref(*map(jnp.asarray, (r, k, v, ld, u)), initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


@pytest.fixture(scope="module")
def time_mix_params():
    """Layer 0's time-mix parameters of the reduced rwkv6-7b, exported from
    the reference (head width 32, chunk 4)."""
    jcfg = jreduced(jget_config("rwkv6-7b"))
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0))
    jtm = jax.tree.map(lambda a: a[0], jparams["layers"]["time_mix"])
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    ttm = {name: p[0] for name, p in common.sub(tparams, "layers.time_mix.").items()}
    return jcfg, jtm, reduced(get_config("rwkv6-7b")), ttm


@pytest.mark.parametrize("length", [7, 10])
def test_time_mix_chunked_matches_reference_at_ragged_length(time_mix_params, length):
    """The model's chunked time-mix through ``ops.wkv6`` against the
    reference's chunk scan, which pads the ragged tail (chunk 4)."""
    jcfg, jtm, tcfg, ttm = time_mix_params
    rng = np.random.default_rng(4)
    d, h, dk = jcfg.d_model, jcfg.d_model // jcfg.ssm.head_dim, jcfg.ssm.head_dim
    x = rng.normal(size=(2, length, d)).astype(np.float32)
    prev = rng.normal(size=(2, d)).astype(np.float32)
    wkv = rng.normal(size=(2, h, dk, dk)).astype(np.float32)
    want, want_prev, want_wkv = jax.jit(jssm.rwkv6_time_mix_chunked, static_argnums=1)(
        jtm, jcfg.ssm, *map(jnp.asarray, (x, prev, wkv)))
    got, got_prev, got_wkv = tssm.rwkv6_time_mix_chunked(ttm, tcfg.ssm, *map(_t, (x, prev, wkv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(got_prev.numpy(), np.asarray(want_prev))
    np.testing.assert_allclose(got_wkv.numpy(), np.asarray(want_wkv), **F32_TOL)


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    ops.launches.reset()
    r, k, v, ld, u, s0 = _inputs(2, 12, 2, 16, state=True)
    for _ in range(3):
        ops.wkv6(*map(_t, (r, k, v, ld, u)), state=_t(s0), chunk=4)
    assert ops.launches.count == 0


def test_wrapper_has_no_fallback_around_the_kernel():
    tree = ast.parse(Path(ops.__file__).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def _bad(**change):
    r, k, v, ld, u, _ = _inputs(2, 8, 2, 16)
    args = dict(r=_t(r), k=_t(k), v=_t(v), logdecay=_t(ld), u=_t(u), state=None, chunk=4)
    args.update(change)
    return args


@pytest.mark.parametrize("change,exc,match", [
    (dict(v=torch.zeros(2, 8, 2, 32)), ValueError, "dv == dk"),
    (dict(r=torch.zeros(2, 8, 1, 32), k=torch.zeros(2, 8, 1, 32), v=torch.zeros(2, 8, 1, 32),
          logdecay=torch.zeros(2, 8, 1, 32), u=torch.zeros(1, 32)), None, None),
    (dict(r=torch.zeros(2, 8, 2, 8), k=torch.zeros(2, 8, 2, 8), v=torch.zeros(2, 8, 2, 8),
          logdecay=torch.zeros(2, 8, 2, 8), u=torch.zeros(2, 8)), ValueError, "head widths"),
    (dict(r=torch.zeros(2, 8, 2, 128), k=torch.zeros(2, 8, 2, 128), v=torch.zeros(2, 8, 2, 128),
          logdecay=torch.zeros(2, 8, 2, 128), u=torch.zeros(2, 128)), ValueError, "head widths"),
    (dict(r=torch.zeros(2, 70, 2, 16), k=torch.zeros(2, 70, 2, 16), v=torch.zeros(2, 70, 2, 16),
          logdecay=torch.zeros(2, 70, 2, 16), chunk=65), ValueError, "chunk"),
    (dict(chunk=0), ValueError, "chunk"),
    (dict(u=torch.zeros(3, 16)), ValueError, "u must be"),
    (dict(state=torch.zeros(2, 2, 16, 15)), ValueError, "state must be"),
    (dict(state=torch.zeros(2, 2, 16, 16, dtype=torch.bfloat16)), ValueError, "state must be"),
    (dict(k=torch.zeros(2, 8, 2, 16, dtype=torch.float64)), TypeError, "float32 or bfloat16"),
    (dict(r=torch.zeros(2, 0, 2, 16), k=torch.zeros(2, 0, 2, 16), v=torch.zeros(2, 0, 2, 16),
          logdecay=torch.zeros(2, 0, 2, 16)), ValueError, "T >= 1"),
])
def test_wrapper_validates_its_operands(change, exc, match):
    args = _bad(**change)
    r, k, v, ld, u = (args.pop(n) for n in ("r", "k", "v", "logdecay", "u"))
    if exc is None:  # a head width the kernel is built for
        out, final = ops.wkv6(r, k, v, ld, u, **args)
        assert out.shape == r.shape and final.shape == (2, 1, 32, 32)
        return
    with pytest.raises(exc, match=match):
        ops.wkv6(r, k, v, ld, u, **args)


def test_wrapper_raises_off_cpu_and_cuda():
    x = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.wkv6(x, x, x, x, torch.zeros(1, 16, device="meta"))


@pytest.mark.parametrize("state,chunk", [(False, 16), (True, 5)])
def test_bf16_operands_give_the_float32_result_rounded_once(state, chunk):
    """bf16 r, k, v (the served type) are computed in float32 and the output
    comes back in bf16: exactly the wrapper's float32 result on the same
    values, rounded to bf16 once; the state stays float32."""
    r, k, v, ld, u, s0 = _inputs(2, 12, 2, 16, state=state, seed=3)
    rb, kb, vb = (_t(a, torch.bfloat16) for a in (r, k, v))
    out, final = ops.wkv6(rb, kb, vb, _t(ld), _t(u), state=_t(s0), chunk=chunk)
    want, want_final = ops.wkv6(rb.float(), kb.float(), vb.float(), _t(ld), _t(u), state=_t(s0),
                                chunk=chunk)
    assert out.dtype == torch.bfloat16 and final.dtype == torch.float32
    assert torch.equal(out, want.to(torch.bfloat16))
    assert torch.equal(final, want_final)

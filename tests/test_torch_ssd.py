"""The port's chunked Mamba2 SSD (``repro_torch.kernels.mamba2``) against the reference.

On the CPU the wrapper ``ops.ssd`` takes the kernel's plain version
``ref.ssd_chunked_ref``; these tests hold it to the reference's sequential
oracle ``ssd_ref`` (from a zero and from a random state, final state
included) and to the reference's Pallas kernel ``ssd_chunked`` (interpret
mode on the CPU, as tests/test_kernels.py runs it), over
tests/test_kernels.py:test_ssd_sweep's grid, at ragged lengths, under strong
decay and with grouped B/C.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``.

Tolerances: atol 5e-5 / rtol 1e-4, the float32 tolerance of
tests/test_kernels.py, for float32 and bf16 operands alike: both sides
widen bf16 x, B and C to the same float32 values and compute in float32.
The one exception is the Pallas kernel's bf16 output, which it rounds to
bf16: there the port's float32 output, rounded to bf16 too, may differ by
one bf16 step (2**-7 relative, rtol 2**-7).
"""
import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.mamba2.mamba2 import ssd_chunked as jssd_chunked  # noqa: E402
from repro.kernels.mamba2.ref import ssd_ref as jssd_ref  # noqa: E402
from repro_torch.kernels.mamba2 import ops, ref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

F32_TOL = dict(atol=5e-5, rtol=1e-4)
BF16_OUT_TOL = dict(atol=1e-6, rtol=2**-7)  # one bf16 step of the Pallas kernel's output
SWEEP = [(64, 2, 32, 16, 16), (32, 3, 16, 8, 8), (48, 1, 64, 32, 48)]  # test_ssd_sweep's grid


def _inputs(b, t, h, p, n, *, g=None, seed=0, state=False, dt_a=None):
    """numpy operands as tests/test_kernels.py draws them (B/C in ``g``
    groups, default one per head), and a state; ``dt_a`` fixes dt * a."""
    rng = np.random.default_rng(seed)
    g = h if g is None else g
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    bm = rng.normal(size=(b, t, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, g, n)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, size=(b, t, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    if dt_a is not None:
        dt = np.ones((b, t, h), np.float32)
        a = np.full((h,), dt_a, np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if state else None
    return x, bm, cm, dt, a, s0


def _t(arr, dtype=torch.float32):
    return None if arr is None else torch.as_tensor(arr).to(dtype)


def _j(arr, dtype=jnp.float32):
    return None if arr is None else jnp.asarray(arr, dtype)


def _round_trip(arr, dtype):
    """``arr`` as the values a ``dtype`` operand holds, in float32."""
    return np.asarray(jnp.asarray(arr, dtype), np.float32)


@pytest.fixture(scope="module")
def sweep_refs():
    """The reference's results over the sweep, computed once per module:
    {(shape, dtype): (Pallas output, oracle output, oracle final state)}."""
    out = {}
    for shape in SWEEP:
        t, h, p, n, chunk = shape
        x, bm, cm, dt, a, _ = _inputs(2, t, h, p, n)
        for dtype in ("float32", "bfloat16"):
            jdt = getattr(jnp, dtype)
            pallas = jssd_chunked(_j(x, jdt), _j(bm, jdt), _j(cm, jdt), _j(dt), _j(a),
                                  chunk=chunk, interpret=True)
            want, want_s = jssd_ref(_j(x, jdt), _j(bm, jdt), _j(cm, jdt), _j(dt), _j(a))
            out[shape, dtype] = tuple(np.asarray(v, np.float32) for v in (pallas, want, want_s))
    return out


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ref_matches_reference_over_the_sweep(sweep_refs, shape, dtype):
    t, h, p, n, chunk = shape
    x, bm, cm, dt, a, _ = _inputs(2, t, h, p, n)
    tdt = getattr(torch, dtype)
    got, final = ops.ssd(_t(x, tdt), _t(bm, tdt), _t(cm, tdt), _t(dt), _t(a), chunk=chunk)
    assert got.dtype == torch.float32 and final.dtype == torch.float32
    assert got.shape == x.shape and final.shape == (2, h, p, n)
    pallas, want, want_s = sweep_refs[shape, dtype]
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(final.numpy(), want_s, **F32_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)
    else:  # the Pallas kernel rounds its output to bf16
        np.testing.assert_allclose(_round_trip(got.numpy(), jnp.bfloat16), pallas,
                                   **BF16_OUT_TOL)


@pytest.mark.parametrize("t,chunk", [(64, 16), (37, 8), (5, 16), (33, 64), (1, 64)])
def test_chunked_ref_from_a_state_matches_sequential_oracle(t, chunk):
    """Output and final state from a random initial state, ragged tails and
    T < chunk included."""
    x, bm, cm, dt, a, s0 = _inputs(2, t, 3, 32, 16, seed=1, state=True)
    want, want_s = jssd_ref(*map(_j, (x, bm, cm, dt, a)), initial_state=_j(s0))
    got, got_s = ops.ssd(*map(_t, (x, bm, cm, dt, a)), state=_t(s0), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32_TOL)


@pytest.mark.parametrize("t,chunk", [(37, 8), (21, 16)])
def test_ragged_length_matches_zero_padded_chunk_scan(t, chunk):
    """A ragged T against the Pallas chunk scan of the zero-padded sequence
    (dt = 0 on the padding: the state passes through unchanged)."""
    x, bm, cm, dt, a, _ = _inputs(2, t, 2, 16, 8, seed=2)
    pad = (-t) % chunk
    padded = [np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2)) for v in (x, bm, cm, dt)]
    want = jssd_chunked(*map(_j, padded), _j(a), chunk=chunk, interpret=True)
    _, want_s = jssd_ref(*map(_j, padded), _j(a))
    got, got_s = ops.ssd(*map(_t, (x, bm, cm, dt, a)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :t], **F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32_TOL)


def test_strong_decay_stays_finite_and_matches():
    """dt * a = -50 a step: the chunk form never takes an exp of a positive
    sum, and keeps only each step's own input."""
    x, bm, cm, dt, a, s0 = _inputs(2, 40, 2, 16, 8, seed=3, state=True, dt_a=-50.0)
    got, got_s = ops.ssd(*map(_t, (x, bm, cm, dt, a)), state=_t(s0), chunk=16)
    assert torch.isfinite(got).all() and torch.isfinite(got_s).all()
    want, want_s = jssd_ref(*map(_j, (x, bm, cm, dt, a)), initial_state=_j(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32_TOL)


def test_groups_match_the_repeated_form():
    """G = 2 groups over H = 4 heads: head h reads group h // 2, as the
    reference's ``_expand_groups`` repeats them."""
    x, bm, cm, dt, a, s0 = _inputs(2, 24, 4, 16, 8, g=2, seed=4, state=True)
    got, got_s = ops.ssd(*map(_t, (x, bm, cm, dt, a)), state=_t(s0), chunk=8)
    rep = [jnp.repeat(_j(m), 2, axis=2) for m in (bm, cm)]
    want, want_s = jssd_ref(_j(x), *rep, _j(dt), _j(a), initial_state=_j(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32_TOL)
    head3 = ref.expand_groups(_t(bm), 4)[:, :, 3]
    assert torch.equal(head3, _t(bm)[:, :, 1])


def test_wrapper_carries_state_across_calls():
    """Two calls over parts of a sequence, the first's final state fed to the
    second, give the one call over the whole (what prefill then decode relies on)."""
    x, bm, cm, dt, a, s0 = _inputs(2, 40, 2, 16, 8, seed=5, state=True)
    whole, whole_s = ops.ssd(*map(_t, (x, bm, cm, dt, a)), state=_t(s0), chunk=8)
    first, mid = ops.ssd(*(_t(v[:, :21]) for v in (x, bm, cm, dt)), _t(a), state=_t(s0),
                         chunk=8)
    second, end = ops.ssd(*(_t(v[:, 21:]) for v in (x, bm, cm, dt)), _t(a), state=mid, chunk=8)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole, **F32_TOL)
    torch.testing.assert_close(end, whole_s, **F32_TOL)


def test_model_slices_reach_the_kernel_in_place():
    """x, B and C as the model passes them (views of the convolution's
    output) satisfy the kernel's layout as they are; a transposed operand is
    copied."""
    conv = torch.zeros(2, 9, 4 * 16 + 2 * 8)
    xh = conv[..., :64].unflatten(-1, (4, 16))
    bm = conv[..., 64:72].unflatten(-1, (1, 8))
    assert ops._kernel_operand(xh) is xh and ops._kernel_operand(bm) is bm
    swapped = torch.zeros(2, 9, 16, 4).transpose(2, 3)
    assert ops._kernel_operand(swapped).is_contiguous()


def test_kernel_is_built_for_every_shape_the_wrapper_takes():
    src = (Path(ops.__file__).parent / "csrc" / "ssd.cu").read_text()
    body = src[src.index('extern "C" int ssd_fwd'):]
    cases = {(int(m[:-3]), int(m[-3:])) for m in re.findall(r"case (\d+):", body)}
    assert cases == set(ops.SHAPES)


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    ops.launches.reset()
    x, bm, cm, dt, a, s0 = _inputs(2, 12, 2, 16, 8, state=True)
    for _ in range(3):
        ops.ssd(*map(_t, (x, bm, cm, dt, a)), state=_t(s0), chunk=4)
    assert ops.launches.count == 0


def test_wrapper_has_no_fallback_around_the_kernel():
    tree = ast.parse(Path(ops.__file__).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def _bad(**change):
    x, bm, cm, dt, a, _ = _inputs(2, 8, 2, 16, 8)
    args = dict(x=_t(x), b=_t(bm), c=_t(cm), dt=_t(dt), a=_t(a), state=None, chunk=4)
    args.update(change)
    return args


@pytest.mark.parametrize("change,exc,match", [
    (dict(x=torch.zeros(2, 8, 2, 64), b=torch.zeros(2, 8, 1, 32), c=torch.zeros(2, 8, 1, 32)),
     None, None),
    (dict(x=torch.zeros(2, 8, 2, 24)), ValueError, r"\(P, N\)"),
    (dict(b=torch.zeros(2, 8, 2, 12), c=torch.zeros(2, 8, 2, 12)), ValueError, r"\(P, N\)"),
    (dict(b=torch.zeros(2, 8, 3, 8), c=torch.zeros(2, 8, 3, 8)), ValueError, "groups"),
    (dict(c=torch.zeros(2, 7, 2, 8)), ValueError, "b and c"),
    (dict(b=torch.zeros(2, 8, 2, 8, dtype=torch.bfloat16)), TypeError, "x is"),
    (dict(x=torch.zeros(2, 8, 2, 16, dtype=torch.float64)), TypeError, "float32 or bfloat16"),
    (dict(dt=torch.zeros(2, 8, 2, dtype=torch.bfloat16)), ValueError, "dt must be"),
    (dict(a=torch.zeros(3)), ValueError, "a must be"),
    (dict(state=torch.zeros(2, 2, 16, 7)), ValueError, "state must be"),
    (dict(chunk=65, x=torch.zeros(2, 70, 2, 16), b=torch.zeros(2, 70, 2, 8),
          c=torch.zeros(2, 70, 2, 8), dt=torch.zeros(2, 70, 2)), ValueError, "chunk"),
    (dict(chunk=0), ValueError, "chunk"),
    (dict(x=torch.zeros(2, 0, 2, 16), b=torch.zeros(2, 0, 2, 8), c=torch.zeros(2, 0, 2, 8),
          dt=torch.zeros(2, 0, 2)), ValueError, "T >= 1"),
])
def test_wrapper_validates_its_operands(change, exc, match):
    args = _bad(**change)
    x, b, c, dt, a = (args.pop(k) for k in ("x", "b", "c", "dt", "a"))
    if exc is None:  # zamba2's (P, N), one group over two heads
        y, final = ops.ssd(x, b, c, dt, a, **args)
        assert y.shape == x.shape and final.shape == (2, 2, 64, 32)
        return
    with pytest.raises(exc, match=match):
        ops.ssd(x, b, c, dt, a, **args)


def test_wrapper_raises_off_cpu_and_cuda():
    x = torch.zeros(1, 4, 1, 16, device="meta")
    bc = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ssd(x, bc, bc, torch.zeros(1, 4, 1, device="meta"), torch.zeros(1, device="meta"))

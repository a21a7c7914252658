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


# --- the CUDA kernel's numerics and its split of P, emulated on the CPU ---
#
# The kernel runs its four chunk products on the tensor cores in TF32, each
# float32 operand split as hi = rna(v), lo = rna(v - hi) and the product
# summed as lo * hi + hi * lo + hi * hi (bf16 operands are exact in TF32 and
# are not split).  Emulated here with TF32 rounding done by masking bits and
# each pass a float32 matmul (a product of two TF32 values is exact in
# float32), and held to the plain version at the card's check: atol 5e-5 /
# rtol 1e-4 and a relative norm error under 1e-5 (chip_smoke.py's).

CARD_REL_NORM = 1e-5


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32, to nearest with ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, split_a: bool, split_b: bool, *, one_pass=False):
    """a @ b as the kernel's TF32 passes compute it: an operand marked split
    is a float32 value taken as hi + lo, else it is exact in TF32."""
    if one_pass:
        return _tf32(a) @ _tf32(b)
    a_hi, b_hi = (_tf32(m) if split else m for m, split in ((a, split_a), (b, split_b)))
    out = a_hi @ b_hi
    if split_a:
        out = out + _tf32(a - a_hi) @ b_hi
    if split_b:
        out = out + a_hi @ _tf32(b - b_hi)
    return out


def _emulated_ssd(x, b, c, dt, a, *, state=None, chunk=64, one_pass=False):
    """ref.ssd_chunked_ref's chunk form with its four products in the
    kernel's TF32 passes: C B^T in one pass for bf16 inputs, att x, C S^T and
    x^T (B w) in two (their float32 operand split); every product in three
    for float32 inputs.  ``one_pass`` rounds every operand to TF32 once."""
    bs, t, h, p = x.shape
    n = b.shape[3]
    split_in = x.dtype == torch.float32
    xf = x.float().transpose(1, 2)  # (B, H, T, P)
    bf, cf = (ref.expand_groups(m, h).float().transpose(1, 2) for m in (b, c))
    dtf = dt.float().transpose(1, 2)  # (B, H, T)
    s = torch.zeros(bs, h, p, n) if state is None else state.float().clone()
    ys = []
    for start in range(0, t, chunk):
        xq, bq, cq, dq = (m[:, :, start:start + chunk] for m in (xf, bf, cf, dtf))
        rows = xq.shape[2]
        cum = torch.cumsum(dq * a[:, None], dim=2)  # (B, H, rows)
        g = _product(cq, bq.transpose(2, 3), split_in, split_in, one_pass=one_pass)
        tri = torch.tril(torch.ones(rows, rows, dtype=torch.bool))
        pair = torch.where(tri, cum[..., :, None] - cum[..., None, :], float("-inf"))
        att = torch.exp(pair) * g * dq[..., None, :]
        y = torch.exp(cum)[..., None] * _product(cq, s.transpose(2, 3), split_in, True,
                                                 one_pass=one_pass)
        y = y + _product(att, xq, True, split_in, one_pass=one_pass)
        w = dq * torch.exp(cum[..., -1:] - cum)
        s = torch.exp(cum[..., -1])[..., None, None] * s + _product(
            xq.transpose(2, 3), bq * w[..., None], split_in, True, one_pass=one_pass)
        ys.append(y)
    return torch.cat(ys, dim=2).transpose(1, 2), s


def _card_check(got, want):
    torch.testing.assert_close(got, want, **F32_TOL)
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert rel < CARD_REL_NORM, rel
    return rel


def _emulation_inputs(dtype):
    x, bm, cm, dt, a, s0 = _inputs(1, 256, 2, 64, 64, g=1, seed=20, state=True)
    return (*(_t(v, dtype) for v in (x, bm, cm)), _t(dt), _t(a), _t(s0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_tf32_products_hold_the_float32_check(dtype):
    """The kernel's split-TF32 passes (two for bf16 inputs, three for
    float32) stay within the card's float32 check of the plain version,
    output and final state."""
    x, bm, cm, dt, a, s0 = _emulation_inputs(dtype)
    got, got_s = _emulated_ssd(x, bm, cm, dt, a, state=s0)
    want, want_s = ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=64)
    assert _card_check(got, want) < 1e-6
    _card_check(got_s, want_s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_pass_tf32_fails_the_float32_check(dtype):
    """Why the kernel splits its float32 operands: one TF32 pass a product
    misses the card's relative norm check by more than tenfold."""
    x, bm, cm, dt, a, s0 = _emulation_inputs(dtype)
    got, _ = _emulated_ssd(x, bm, cm, dt, a, state=s0, one_pass=True)
    want, _ = ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=64)
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert rel > 10 * CARD_REL_NORM
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **F32_TOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    v = torch.tensor([1.0 + 2**-11, 1.0 + 2**-11 + 2**-20, -(1.0 + 2**-11), 1.0 + 2**-12, 3.0])
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 3.0])
    assert torch.equal(_tf32(v), want)
    lo = _tf32(v - _tf32(v))
    assert torch.equal(_tf32(v) + lo, v)  # these values fit hi + lo exactly


def _cuda_constants() -> dict:
    src = (Path(ops.__file__).parent / "csrc" / "ssd.cu").read_text()
    consts = {name: int(val) for name, val in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    for name in ("kWidest", "kNarrowest"):
        bf16, f32 = re.search(name + r" = sizeof\(T\) == 2 \? (\d+) : (\d+);", src).groups()
        consts[name] = {torch.bfloat16: int(bf16), torch.float32: int(f32)}
    return consts


def test_split_rule_matches_the_cuda_source():
    consts = _cuda_constants()
    assert consts["kBlocksPerSm"] == ops.BLOCKS_PER_SM
    assert consts["kMaxChunk"] == ops.MAX_CHUNK
    for dtype, (narrowest, widest) in ops.SLICES.items():
        assert consts["kNarrowest"][dtype] == narrowest and consts["kWidest"][dtype] == widest


BHS = (1, 2, 79, 80, 131, 132, 133, 263, 264, 265, 320, 1000)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n", ops.SHAPES)
def test_split_covers_p_with_an_instantiated_slice(p, n, dtype):
    """Every split the rule picks divides P into slices the CUDA source
    instantiates for (P, N) and the type (``kTakes``: 16 <= slice <= the
    type's widest, and at least its narrowest unless the slice is all of P)."""
    narrowest, widest = ops.SLICES[dtype]
    for sm_count in (114, 132):
        for bh in BHS:
            split = ops.kernel_split(bh, p, dtype, sm_count)
            assert split in ops.SPLITS and p % split == 0
            slice_ = p // split
            assert 16 <= slice_ <= widest and (slice_ >= narrowest or slice_ == p)
            bigger = ops.kernel_split(2 * bh, p, dtype, sm_count)
            assert bigger <= split  # more (b, h) pairs never split P finer


@pytest.mark.parametrize("bh,sm_count,dtype,want", [
    (320, 132, torch.bfloat16, 1),  # zamba2's served prefill: B 4, H 80
    (80, 132, torch.bfloat16, 4),  # B 1, H 80: the rule changes
    (131, 132, torch.bfloat16, 4),
    (132, 132, torch.bfloat16, 2),
    (263, 132, torch.bfloat16, 2),
    (264, 132, torch.bfloat16, 1),
    (320, 132, torch.float32, 2),
    (80, 132, torch.float32, 2),
    (264, 114, torch.bfloat16, 1),
])
def test_split_rule_at_its_boundaries(bh, sm_count, dtype, want):
    assert ops.kernel_split(bh, 64, dtype, sm_count) == want


def test_served_shape_takes_the_tensor_core_route():
    assert ops.kernel_route(torch.bfloat16) == "tf32x2"
    assert ops.kernel_route(torch.float32) == "tf32x3"
    assert set(ops.ROUTES.values()) == {"tf32x2", "tf32x3"}


def test_misaligned_operands_are_copied():
    """The kernel copies 16 bytes at a time: a view whose token stride is
    not a multiple of 16 bytes is copied to a contiguous tensor."""
    conv = torch.zeros(2, 9, 4 * 16 + 2 * 8 + 1)
    xh = conv[..., :64].unflatten(-1, (4, 16))
    got = ops._kernel_operand(xh)
    assert got is not xh and got.is_contiguous()
    bf = torch.zeros(2, 9, 72, dtype=torch.bfloat16)[..., 8:72].unflatten(-1, (1, 64))
    assert ops._kernel_operand(bf) is bf  # 16-byte offset and strides: read in place

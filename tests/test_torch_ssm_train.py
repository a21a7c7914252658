"""The backward of the port's WKV6 and SSD (``repro_torch.kernels.rwkv6``,
``repro_torch.kernels.mamba2``) against the reference, on the CPU.

The reference trains through its jnp recurrences, which JAX differentiates;
the port's wrappers are ``autograd.Function``s whose backward is a kernel on
the card and the plain backward (``ref.wkv6_bwd_ref``, ``ref.ssd_bwd_ref``)
on the CPU.  These tests hold the plain backwards to ``jax.vjp`` of the
reference's sequential oracles (``repro/kernels/rwkv6/ref.py:wkv6_ref``,
``repro/kernels/mamba2/ref.py:ssd_ref``) with a nonzero initial state and a
nonzero gradient of the final state, in float32 and bf16, at ragged
lengths, under extreme decay and, for the SSD, with B/C groups G < H; to
through the chunked forms; the backward kernels' chunked decompositions
(``ref.ssd_bwd_chunked_ref``, ``ref.wkv6_bwd_chunked_ref``) against the
plain backwards and ``jax.vjp``, and with their TF32 passes emulated
against the card's float32 check and float64; the Functions under
``torch.func.vmap`` (the peers folded into the batch, each with its own u
or a) against a loop over the peers; and the wrappers' dispatch: every call
through its Function, no fallback, the plain backward on CPU tensors only.
The CUDA kernels are held to the plain backwards on the card by
``chip_smoke.py``.

Tolerances: float32 rtol 1e-4 with atol 1e-5 of the largest entry of the
gradient held (sums of up to T terms taken in another order; the two
backwards differ by a few float32 steps of the largest terms); extreme
decay (log-decay -50 a step, where the log-decays' gradient is the
cancellation of sums of terms of the size of the other gradients) atol 1e-5
of the largest gradient of any operand (1e-4 for the SSD's dt, which
carries that error times |a| = 50); bf16 operands: each gradient in its
operand's type, within one bf16 rounding (rtol 2**-7) and atol 1e-2 of the
largest entry.
"""
import ast
import functools
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.mamba2.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jwkv6_ref  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv6_ref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

WKV6_NAMES = ("r", "k", "v", "logdecay", "u", "state")
SSD_NAMES = ("x", "b", "c", "dt", "a", "state")


def _close(got, want, *, scale=None, what=""):
    """float32: rtol 1e-4, atol 1e-5 of ``scale`` (default the largest
    entry of ``want``)."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=what)


def _wkv6_inputs(b, t, h, dk, *, seed=0, ld_const=None, groups=None):
    """numpy operands as tests/test_kernels.py draws them, a state, the
    incoming gradients of (out, final state), and u of ``groups`` rows."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=(b, t, h, dk)).astype(np.float32) for _ in range(4))
    ld = (np.full((b, t, h, dk), ld_const, np.float32) if ld_const is not None
          else -rng.uniform(0.01, 4.0, size=(b, t, h, dk)).astype(np.float32))
    u_shape = (h, dk) if groups is None else (groups, h, dk)
    u = (0.5 * rng.normal(size=u_shape)).astype(np.float32)
    s0, ds = (rng.normal(size=(b, h, dk, dk)).astype(np.float32) for _ in range(2))
    return (r, k, v, ld, u, s0), (do, ds)


def _ssd_inputs(b, t, h, p, n, g, *, seed=0, dt_a=None, groups=None):
    """numpy operands as tests/test_kernels.py draws them (B/C in ``g``
    groups), a state, the incoming gradients of (y, final state), and a of
    ``groups`` rows; ``dt_a`` fixes dt * a."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.normal(size=(b, t, h, p)).astype(np.float32) for _ in range(2))
    bm, cm = (rng.normal(size=(b, t, g, n)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.01, 1.0, size=(b, t, h)).astype(np.float32)
    a_shape = (h,) if groups is None else (groups, h)
    a = -rng.uniform(0.5, 2.0, size=a_shape).astype(np.float32)
    if dt_a is not None:
        dt, a = np.ones_like(dt), np.full(a_shape, dt_a, np.float32)
    s0, ds = (rng.normal(size=(b, h, p, n)).astype(np.float32) for _ in range(2))
    return (x, bm, cm, dt, a, s0), (dy, ds)


def _t(arr, dtype=torch.float32):
    return torch.as_tensor(arr).to(dtype)


def _jax_wkv6_vjp(ops_, grads, dtype=jnp.float32):
    r, k, v, ld, u, s0 = ops_
    prim = (*(jnp.asarray(x, dtype) for x in (r, k, v)), *map(jnp.asarray, (ld, u, s0)))
    _, vjp = jax.vjp(lambda *a: jwkv6_ref(*a[:5], initial_state=a[5]), *prim)
    # the reference's output is float32 whatever r's type: its cotangent is
    # the port's output gradient (in r's type) widened
    do, ds = grads
    return vjp((jnp.asarray(jnp.asarray(do, dtype), jnp.float32), jnp.asarray(ds)))


def _jax_ssd_vjp(ops_, grads, dtype=jnp.float32):
    x, bm, cm, dt, a, s0 = ops_
    rep = x.shape[2] // bm.shape[2]

    def f(x, bm, cm, dt, a, s0):  # the reference takes B/C per head
        return jssd_ref(x, jnp.repeat(bm, rep, 2), jnp.repeat(cm, rep, 2), dt, a, s0)

    prim = (*(jnp.asarray(m, dtype) for m in (x, bm, cm)), *map(jnp.asarray, (dt, a, s0)))
    _, vjp = jax.vjp(f, *prim)
    return vjp(tuple(map(jnp.asarray, grads)))


# ---------------------------------------------------------------------------
# the plain backwards against jax.vjp of the reference's oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,t,h,dk", [(2, 16, 2, 16), (2, 13, 3, 32), (1, 37, 1, 64)])
def test_wkv6_bwd_ref_matches_jax_vjp(b, t, h, dk):
    """Ragged lengths (13, 37), every head width the kernel takes, a random
    initial state and a random gradient of the final state."""
    ops_, grads = _wkv6_inputs(b, t, h, dk, seed=t)
    want = _jax_wkv6_vjp(ops_, grads)
    got = wkv6_ref.wkv6_bwd_ref(*map(_t, ops_), *map(_t, grads))
    for name, g, w in zip(WKV6_NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w, what=name)


def test_wkv6_bwd_ref_extreme_decay_stays_finite():
    """ld = -50 a step (tests/test_kernels.py's extreme decay): finite, and
    within atol of the reference's gradients on the scale of the largest."""
    ops_, grads = _wkv6_inputs(1, 32, 2, 16, seed=3, ld_const=-50.0)
    want = _jax_wkv6_vjp(ops_, grads)
    got = wkv6_ref.wkv6_bwd_ref(*map(_t, ops_), *map(_t, grads))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, g, w in zip(WKV6_NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, scale=scale, what=name)


def test_wkv6_bwd_ref_matches_autograd_through_the_chunked_form():
    """The plain backward against torch autograd through
    ``wkv6_chunked_ref`` (a ragged last chunk, u of one row per two batch
    elements, as a vmapped call folds its peers)."""
    ops_, grads = _wkv6_inputs(4, 11, 2, 16, seed=5, groups=2)
    leaves = [_t(x).requires_grad_(True) for x in ops_]
    out, final = wkv6_ref.wkv6_chunked_ref(*leaves, chunk=4)
    want = torch.autograd.grad((out * _t(grads[0])).sum() + (final * _t(grads[1])).sum(),
                               leaves)
    got = wkv6_ref.wkv6_bwd_ref(*map(_t, ops_), *map(_t, grads))
    for name, g, w in zip(WKV6_NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w.numpy(), what=name)


def test_wkv6_bf16_gradients_in_their_operands_types():
    """bf16 r, k, v and a bf16 gradient of the output (the served and
    trained type): dr, dk, dv come back bf16, the rest float32, each within
    one bf16 rounding of ``jax.vjp`` of the reference on bf16 operands."""
    ops_, grads = _wkv6_inputs(2, 20, 2, 16, seed=7)
    want = _jax_wkv6_vjp(ops_, grads, jnp.bfloat16)
    tops = (*(_t(x, torch.bfloat16) for x in ops_[:3]), *map(_t, ops_[3:]))
    got = wkv6_ops.wkv6_bwd(*tops, _t(grads[0], torch.bfloat16), _t(grads[1]))
    for name, g, w, x in zip(WKV6_NAMES, got, want, tops):
        assert g.dtype == x.dtype, name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2**-7,
                                   atol=1e-2 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("b,t,h,p,n,g", [(2, 16, 4, 16, 8, 2), (2, 21, 4, 32, 16, 1),
                                         (1, 37, 2, 64, 32, 2)])
def test_ssd_bwd_ref_matches_jax_vjp(b, t, h, p, n, g):
    """Groups G < H (and G = H), ragged lengths (21, 37), a random initial
    state and a random gradient of the final state; dB and dC are the
    reference's gradients of the grouped B and C it repeats over the
    heads."""
    ops_, grads = _ssd_inputs(b, t, h, p, n, g, seed=t)
    want = _jax_ssd_vjp(ops_, grads)
    got = ssd_ref.ssd_bwd_ref(*map(_t, ops_), *map(_t, grads))
    for name, gr, w in zip(SSD_NAMES, got, want):
        assert gr.shape == np.shape(w), name
        _close(gr, w, what=name)


def test_ssd_bwd_ref_strong_decay_stays_finite():
    """dt a = -50 a step: finite, and within atol of the reference's
    gradients on the scale of the largest (1e-4 of it: ddt = x . (G B) +
    a dl carries dl's absolute error times |a| = 50)."""
    ops_, grads = _ssd_inputs(1, 24, 2, 16, 8, 1, seed=9, dt_a=-50.0)
    want = _jax_ssd_vjp(ops_, grads)
    got = ssd_ref.ssd_bwd_ref(*map(_t, ops_), *map(_t, grads))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, gr, w in zip(SSD_NAMES, got, want):
        assert torch.isfinite(gr).all(), name
        _close(gr, w, scale=10 * scale, what=name)


@functools.cache
def _long_memory_case():
    """A long memory (dt a about -0.03 a step, 1024 tokens, P = N = 64, no
    state): the operands and float64 autograd's dx, ddt and da through the
    recurrence."""
    rng = np.random.default_rng(25)
    b, t, h, p, n = 1, 1024, 2, 64, 64
    x, dy = (rng.normal(size=(b, t, h, p)).astype(np.float32) for _ in range(2))
    bm, cm = (rng.normal(size=(b, t, 1, n)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.01, 0.05, size=(b, t, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    xx, dd, aa = (torch.as_tensor(m).double().requires_grad_(True) for m in (x, dt, a))
    bb, cc = (torch.as_tensor(m).double().expand(b, t, h, n) for m in (bm, cm))
    s, ys = torch.zeros(b, h, p, n, dtype=torch.float64), []
    for i in range(t):
        s = (torch.exp(dd[:, i] * aa)[..., None, None] * s
             + (dd[:, i, :, None] * xx[:, i])[..., None] * bb[:, i][:, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cc[:, i]))
    want = torch.autograd.grad((torch.stack(ys, 1) * _t(dy).double()).sum(), (xx, dd, aa))
    return (x, bm, cm, dt, a), dy, want


def test_ssd_bwd_ref_long_memory_matches_float64():
    """A long memory (dt a about -0.03 a step, 1024 tokens, P = N = 64):
    da and ddt within a relative norm error of 2e-6 of float64 autograd
    through the recurrence.  The log-decays' running sum restarts every
    ``BWD_CHUNK`` tokens from a direct inner product; run end to end it
    misses this bound here (tools/bwd_precision.py: 2.8e-4 of da at
    zamba2's head shape)."""
    ops_, dy, (_, gdt, ga) = _long_memory_case()
    got = ssd_ref.ssd_bwd_ref(*map(_t, ops_), None, _t(dy), None)
    for name, g, w in (("ddt", got[3], gdt), ("da", got[4], ga)):
        err = float((g.double() - w).norm() / w.norm())
        assert err < 2e-6, (name, err)


def test_ssd_bwd_ref_matches_autograd_through_the_chunked_form():
    """The plain backward against torch autograd through
    ``ssd_chunked_ref`` (a ragged last chunk, G = 2 over H = 4, a of one
    row per two batch elements, as a vmapped call folds its peers)."""
    ops_, grads = _ssd_inputs(4, 11, 4, 16, 8, 2, seed=11, groups=2)
    leaves = [_t(m).requires_grad_(True) for m in ops_]
    y, final = ssd_ref.ssd_chunked_ref(*leaves[:5], state=leaves[5], chunk=4)
    want = torch.autograd.grad((y * _t(grads[0])).sum() + (final * _t(grads[1])).sum(), leaves)
    got = ssd_ref.ssd_bwd_ref(*map(_t, ops_), *map(_t, grads))
    for name, gr, w in zip(SSD_NAMES, got, want):
        assert gr.shape == w.shape, name
        _close(gr, w.numpy(), what=name)


def test_ssd_bf16_gradients_in_their_operands_types():
    """bf16 x, B and C (the served and trained type): dx, dB, dC come back
    bf16, the rest float32, each within one bf16 rounding of ``jax.vjp`` of
    the reference on bf16 operands."""
    ops_, grads = _ssd_inputs(2, 20, 4, 16, 8, 2, seed=13)
    want = _jax_ssd_vjp(ops_, grads, jnp.bfloat16)
    tops = (*(_t(m, torch.bfloat16) for m in ops_[:3]), *map(_t, ops_[3:]))
    got = ssd_ops.ssd_bwd(*tops, *map(_t, grads))
    for name, gr, w, m in zip(SSD_NAMES, got, want, tops):
        assert gr.dtype == m.dtype, name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(gr.float().numpy(), w, rtol=2**-7,
                                   atol=1e-2 * float(np.abs(w).max()), err_msg=name)


# ---------------------------------------------------------------------------
# the backward kernel's chunked decomposition (csrc/ssd_bwd.cu), and its TF32
# passes emulated (the card's float32 check: chip_smoke.BWD_REL_NORM, 1e-4)
# ---------------------------------------------------------------------------

CARD_BWD_REL_NORM = 1e-4


def _rel(got, want):
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("b,t,h,p,n,g,chunk", [
    (2, 16, 4, 16, 8, 2, 64), (2, 21, 4, 32, 16, 1, 64), (1, 37, 2, 64, 32, 2, 64),
    (1, 37, 2, 64, 32, 2, 8), (2, 150, 2, 32, 16, 1, 64)])
def test_ssd_bwd_chunked_ref_matches_plain_and_jax(b, t, h, p, n, g, chunk):
    """The chunked decomposition (one ragged chunk of 64; several chunks of
    8 or 64 with a ragged last one; G < H and G = H; a state in and a
    final-state gradient) against ``jax.vjp`` of the reference's oracle and
    against the plain backward (the token recurrence), at the float32
    tolerance."""
    ops_, grads = _ssd_inputs(b, t, h, p, n, g, seed=t + chunk)
    want = _jax_ssd_vjp(ops_, grads)
    plain = ssd_ref.ssd_bwd_ref(*map(_t, ops_), *map(_t, grads))
    got = ssd_ref.ssd_bwd_chunked_ref(*map(_t, ops_), *map(_t, grads), chunk=chunk)
    for name, gr, pl, w in zip(SSD_NAMES, got, plain, want):
        assert gr.shape == pl.shape == np.shape(w), name
        _close(gr, w, what=name)
        _close(gr, pl.numpy(), what=name)


def test_ssd_bwd_chunked_ref_takes_a_row_of_a_a_peer():
    """a of one row per two batch elements (a vmapped call's peers folded
    into the batch), a ragged chunk: the chunked form against the plain
    backward."""
    ops_, grads = _ssd_inputs(4, 75, 4, 16, 8, 2, seed=11, groups=2)
    want = ssd_ref.ssd_bwd_ref(*map(_t, ops_), *map(_t, grads))
    got = ssd_ref.ssd_bwd_chunked_ref(*map(_t, ops_), *map(_t, grads))
    for name, gr, w in zip(SSD_NAMES, got, want):
        assert gr.shape == w.shape, name
        _close(gr, w.numpy(), what=name)


@pytest.mark.parametrize("t", [24, 150])
def test_ssd_bwd_chunked_ref_strong_decay_stays_finite(t):
    """dt a = -50 a step in one chunk and across three: every exponent the
    decomposition takes is a difference cum_t - cum_s with s <= t, so
    nothing overflows; within atol of the reference's gradients on the scale
    of the largest (1e-4 of it, as the plain backward's test)."""
    ops_, grads = _ssd_inputs(1, t, 2, 16, 8, 1, seed=9, dt_a=-50.0)
    want = _jax_ssd_vjp(ops_, grads)
    got = ssd_ref.ssd_bwd_chunked_ref(*map(_t, ops_), *map(_t, grads))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, gr, w in zip(SSD_NAMES, got, want):
        assert torch.isfinite(gr).all(), name
        _close(gr, w, scale=10 * scale, what=name)


@pytest.mark.parametrize("emulated", [False, True])
def test_ssd_bwd_chunked_ref_long_memory_matches_float64(emulated):
    """The long memory of the plain backward's test: no running sum of the
    decomposition spans more than a chunk of 64 (each restarts from the
    direct <G, S> at the chunk's end), and dx, ddt and da stay within 2e-6
    of float64 autograd, with the kernel's TF32 passes too."""
    ops_, dy, want = _long_memory_case()
    product = ssd_ref.tf32_product if emulated else None
    got = ssd_ref.ssd_bwd_chunked_ref(*map(_t, ops_), None, _t(dy), None, product=product)
    for name, g, w in (("dx", got[0], want[0]), ("ddt", got[3], want[1]),
                       ("da", got[4], want[2])):
        err = float((g.double() - w).norm() / w.norm())
        assert err < 2e-6, (name, err)


def _emulated_bwd(dtype, *, one_pass):
    ops_, grads = _ssd_inputs(1, 256, 2, 64, 64, 1, seed=20)
    tops = (*(_t(m, dtype) for m in ops_[:3]), *map(_t, ops_[3:]))
    want = ssd_ref.ssd_bwd_ref(*tops, *map(_t, grads))

    def product(m1, m2, s1, s2):
        return ssd_ref.tf32_product(m1, m2, s1, s2, one_pass=one_pass)

    got = ssd_ref.ssd_bwd_chunked_ref(*tops, *map(_t, grads), product=product)
    return {name: _rel(g, w) for name, g, w in zip(SSD_NAMES, got, want)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_tf32_backward_holds_the_float32_check(dtype):
    """The kernel's split-TF32 passes (the float32 operand of every product
    split, bf16 x, B and C exact; every operand split for float32 inputs)
    keep every gradient within the card's float32 check of the plain
    backward."""
    rels = _emulated_bwd(dtype, one_pass=False)
    assert max(rels.values()) < CARD_BWD_REL_NORM / 10, rels


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_pass_tf32_backward_fails_the_float32_check(dtype):
    """Why the kernel splits: one TF32 pass a product misses the card's
    float32 check of the plain backward."""
    rels = _emulated_bwd(dtype, one_pass=True)
    assert max(rels.values()) > CARD_BWD_REL_NORM, rels


# ---------------------------------------------------------------------------
# the wkv6 backward kernel's chunked decomposition (csrc/wkv6_bwd.cu), and its
# TF32 passes emulated
# ---------------------------------------------------------------------------


def _jax_wkv6_vjp_rows(ops_, grads):
    """``_jax_wkv6_vjp`` for u of one row (H, dk) or of a row per group of
    batch elements (G, H, dk): the reference takes one u, so each group is
    its own call, and du is each group's."""
    r, k, v, ld, u, s0 = ops_
    if u.ndim == 2:
        return _jax_wkv6_vjp(ops_, grads)
    per = r.shape[0] // u.shape[0]
    parts = []
    for g in range(u.shape[0]):
        rows = slice(g * per, (g + 1) * per)
        parts.append(_jax_wkv6_vjp((r[rows], k[rows], v[rows], ld[rows], u[g], s0[rows]),
                                   tuple(x[rows] for x in grads)))
    cat = lambda i: np.concatenate([np.asarray(p[i]) for p in parts])  # noqa: E731
    return (cat(0), cat(1), cat(2), cat(3), np.stack([np.asarray(p[4]) for p in parts]),
            cat(5))


@pytest.mark.parametrize("b,t,h,dk,chunk,sub,state,dstate,groups", [
    (2, 16, 2, 16, 16, 4, True, True, None),    # T equal to the chunk
    (4, 13, 2, 32, 16, 4, True, False, 2),      # T below it, u a row per peer
    (1, 37, 1, 64, 16, 8, False, True, None),   # ragged past it, several chunks
    (2, 1, 2, 16, 8, 4, False, False, None),    # one token
    (2, 40, 2, 32, 64, 16, True, True, 2),      # the kernel's sizes, below a chunk
    (1, 150, 1, 16, 64, 16, True, True, None),  # the kernel's sizes, ragged past two
])
def test_wkv6_bwd_chunked_ref_matches_plain_and_jax(b, t, h, dk, chunk, sub, state, dstate,
                                                    groups):
    """The chunked decomposition against ``jax.vjp`` of the reference's
    oracle and against the plain backward (the token recurrence), at the
    float32 tolerance: every head width the kernel takes, T at, below and
    ragged past the chunk, one token, a state and a final-state gradient
    each given or not, u of one row and of a row per peer."""
    ops_, grads = _wkv6_inputs(b, t, h, dk, seed=t + chunk + dk, groups=groups)
    if not state:
        ops_ = (*ops_[:5], np.zeros_like(ops_[5]))
    if not dstate:
        grads = (grads[0], np.zeros_like(grads[1]))
    want = _jax_wkv6_vjp_rows(ops_, grads)
    args = (*map(_t, ops_[:5]), _t(ops_[5]) if state else None, _t(grads[0]),
            _t(grads[1]) if dstate else None)
    plain = wkv6_ref.wkv6_bwd_ref(*args)
    got = wkv6_ref.wkv6_bwd_chunked_ref(*args, chunk=chunk, sub=sub)
    for name, g, pl, w in zip(WKV6_NAMES, got, plain, want):
        assert g.shape == pl.shape == np.shape(w), name
        _close(g, w, what=name)
        _close(g, pl.numpy(), what=name)


@pytest.mark.parametrize("t", [24, 150])
def test_wkv6_bwd_chunked_ref_extreme_decay_stays_finite(t):
    """ld = -50 a step within a chunk and across three (the kernel's chunk
    and sub-chunk): every exponent the decomposition takes is a sum of
    log-decays, so nothing overflows; within atol of the reference's
    gradients on the scale of the largest, as the plain backward's test."""
    ops_, grads = _wkv6_inputs(1, t, 2, 16, seed=t, ld_const=-50.0)
    want = _jax_wkv6_vjp(ops_, grads)
    got = wkv6_ref.wkv6_bwd_chunked_ref(*map(_t, ops_), *map(_t, grads))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, g, w in zip(WKV6_NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, scale=scale, what=name)


@functools.cache
def _wkv6_long_memory_case():
    """A long memory (log-decays in [-2e-3, -1e-4], the state surviving all
    1024 tokens, dk 64, a state in and a final-state gradient): the
    operands and float64 autograd's gradients through the recurrence."""
    ops_, grads = _wkv6_inputs(1, 1024, 2, 64, seed=27)
    rng = np.random.default_rng(28)
    ld = -rng.uniform(1e-4, 2e-3, size=ops_[3].shape).astype(np.float32)
    ops_ = (*ops_[:3], ld, *ops_[4:])
    leaves = [torch.as_tensor(x).double().requires_grad_(True) for x in ops_]
    r, k, v, ld_, u, s = leaves
    outs = []
    for i in range(r.shape[1]):
        rt, kt, vt = r[:, i], k[:, i], v[:, i]
        outs.append(torch.einsum("bhi,bhij->bhj", rt, s)
                    + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = torch.exp(ld_[:, i])[..., None] * s + kt[..., None] * vt[..., None, :]
    loss = ((torch.stack(outs, 1) * torch.as_tensor(grads[0]).double()).sum()
            + (s * torch.as_tensor(grads[1]).double()).sum())
    return ops_, grads, torch.autograd.grad(loss, leaves)


def _wkv6_long_memory_rels(*, one_pass):
    ops_, grads, want = _wkv6_long_memory_case()

    def product(m1, m2, s1, s2):
        return ssd_ref.tf32_product(m1, m2, s1, s2, one_pass=one_pass)

    got = wkv6_ref.wkv6_bwd_chunked_ref(*map(_t, ops_), *map(_t, grads), product=product)
    return {name: float((g.double() - w).norm() / w.norm())
            for name, g, w in zip(WKV6_NAMES, got, want)}


def test_wkv6_bwd_chunked_ref_long_memory_matches_float64():
    """The long memory with the kernel's split TF32 passes emulated: every
    gradient within the card's float32 check (1e-4) of float64 autograd
    through the recurrence: no running sum spans more than a chunk, and no
    exponent is the difference of two long prefix sums."""
    rels = _wkv6_long_memory_rels(one_pass=False)
    assert max(rels.values()) < CARD_BWD_REL_NORM, rels


def test_wkv6_one_pass_tf32_backward_fails_the_long_memory_check():
    """Why the kernel splits its float32 operands: one TF32 pass a product
    misses the card's float32 check against float64 on the long memory."""
    rels = _wkv6_long_memory_rels(one_pass=True)
    assert max(rels.values()) > CARD_BWD_REL_NORM, rels


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_split_tf32_backward_holds_the_float32_check(dtype):
    """The kernel's split-TF32 passes (every float32 operand split, bf16 r,
    k, v and do exact) at its chunk and sub-chunk, u a row per peer, a state
    and a final-state gradient: every gradient within a tenth of the card's
    float32 check of the plain backward on the same operands."""
    ops_, grads = _wkv6_inputs(4, 200, 2, 64, seed=29, groups=2)
    tops = (*(_t(x, dtype) for x in ops_[:3]), *map(_t, ops_[3:]))
    args = (*tops, _t(grads[0], dtype), _t(grads[1]))
    want = wkv6_ref.wkv6_bwd_ref(*args)
    got = wkv6_ref.wkv6_bwd_chunked_ref(*args, product=ssd_ref.tf32_product)
    rels = {name: _rel(g, w) for name, g, w in zip(WKV6_NAMES, got, want)}
    assert max(rels.values()) < CARD_BWD_REL_NORM / 10, rels


# ---------------------------------------------------------------------------
# the Functions under torch.func.vmap, against a loop over the peers
# ---------------------------------------------------------------------------


def _peer_grads(fn, stacked, weights, *, vmapped):
    """Gradients of sum_k <fn(peer k's operands), weights_k> against every
    stacked leaf: one vmapped call, or a loop of calls over the peers."""
    leaves = [x.clone().requires_grad_(True) for x in stacked]
    if vmapped:
        outs = torch.func.vmap(fn)(*leaves)
    else:
        per = [fn(*(x[i] for x in leaves)) for i in range(leaves[0].shape[0])]
        outs = tuple(torch.stack(o) for o in zip(*per))
    loss = sum((o * w).sum() for o, w in zip(outs, weights))
    return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)


def test_wkv6_function_under_vmap_matches_a_loop_over_peers():
    """K = 3 peers, each with its own u and state, batch 2, ragged T 10 at
    chunk 4: one vmapped call (the peers folded into the batch) gives every
    peer's output, final state and gradients as three calls do."""
    k_peers, rng = 3, np.random.default_rng(17)
    shape = (k_peers, 2, 10, 2, 16)
    r, k, v, w_out = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    ld = -rng.uniform(0.01, 4.0, size=shape).astype(np.float32)
    u = (0.5 * rng.normal(size=(k_peers, 2, 16))).astype(np.float32)
    s0, w_fin = (rng.normal(size=(k_peers, 2, 2, 16, 16)).astype(np.float32) for _ in range(2))
    stacked = [_t(x) for x in (r, k, v, ld, u, s0)]

    def fn(r, k, v, ld, u, s0):
        return wkv6_ops.wkv6(r, k, v, ld, u, state=s0, chunk=4)

    weights = (_t(w_out), _t(w_fin))
    outs_v, grads_v = _peer_grads(fn, stacked, weights, vmapped=True)
    outs_l, grads_l = _peer_grads(fn, stacked, weights, vmapped=False)
    for a, b in zip(outs_v, outs_l):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    for name, a, b in zip(WKV6_NAMES, grads_v, grads_l):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_ssd_function_under_vmap_matches_a_loop_over_peers():
    """K = 3 peers, each with its own a and state, batch 2, G = 2 over H = 4,
    ragged T 11 at chunk 4: one vmapped call gives every peer's output,
    final state and gradients as three calls do."""
    k_peers, rng = 3, np.random.default_rng(19)
    x, w_out = (rng.normal(size=(k_peers, 2, 11, 4, 16)).astype(np.float32) for _ in range(2))
    bm, cm = (rng.normal(size=(k_peers, 2, 11, 2, 8)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.01, 1.0, size=(k_peers, 2, 11, 4)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(k_peers, 4)).astype(np.float32)
    s0, w_fin = (rng.normal(size=(k_peers, 2, 4, 16, 8)).astype(np.float32) for _ in range(2))
    stacked = [_t(m) for m in (x, bm, cm, dt, a, s0)]

    def fn(x, bm, cm, dt, a, s0):
        return ssd_ops.ssd(x, bm, cm, dt, a, state=s0, chunk=4)

    weights = (_t(w_out), _t(w_fin))
    outs_v, grads_v = _peer_grads(fn, stacked, weights, vmapped=True)
    outs_l, grads_l = _peer_grads(fn, stacked, weights, vmapped=False)
    for a_, b_ in zip(outs_v, outs_l):
        torch.testing.assert_close(a_, b_, atol=1e-5, rtol=1e-5)
    for name, a_, b_ in zip(SSD_NAMES, grads_v, grads_l):
        torch.testing.assert_close(a_, b_, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("ops_mod,fn_name", [(wkv6_ops, "wkv6"), (ssd_ops, "ssd")])
def test_final_state_alone_reaches_the_operands(ops_mod, fn_name):
    """A loss of the final state alone (no gradient of the output) still
    reaches every operand: the Function takes the missing output gradient
    as zeros."""
    if fn_name == "wkv6":
        ops_, _ = _wkv6_inputs(1, 9, 2, 16, seed=21)
        leaves = [_t(x).requires_grad_(True) for x in ops_]
        _, final = ops_mod.wkv6(*leaves[:5], state=leaves[5], chunk=4)
        want_final = wkv6_ref.wkv6_chunked_ref(*leaves, chunk=4)[1]
    else:
        ops_, _ = _ssd_inputs(1, 9, 2, 16, 8, 1, seed=21)
        leaves = [_t(m).requires_grad_(True) for m in ops_]
        _, final = ops_mod.ssd(*leaves[:5], state=leaves[5], chunk=4)
        want_final = ssd_ref.ssd_chunked_ref(*leaves[:5], state=leaves[5], chunk=4)[1]
    got = torch.autograd.grad(final.square().sum(), leaves)
    # the plain forward's final state does not reach r (nor c): zeros there
    want = torch.autograd.grad(want_final.square().sum(), leaves, allow_unused=True,
                               materialize_grads=True)
    for g, w in zip(got, want):
        _close(g, w.numpy())


# ---------------------------------------------------------------------------
# dispatch: every call through the Function, no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ops_mod,wrapper,function,bwd", [
    (wkv6_ops, "wkv6", "WKV6", "wkv6_bwd"), (ssd_ops, "ssd", "SSD", "ssd_bwd")])
def test_wrapper_cuda_path_goes_through_its_function(ops_mod, wrapper, function, bwd):
    """Each wrapper calls its ``autograd.Function``, whose forward launches
    the kernel on a CUDA tensor and whose backward launches the backward
    kernel (the plain backward on CPU tensors only), so the graph is never
    cut and the card never runs a plain version."""
    src = inspect.getsource(getattr(ops_mod, wrapper))
    assert "check_no_grad" not in src and f"{function}.apply(" in src
    fwd = inspect.getsource(ops_mod._forward)
    assert fwd.index('device.type == "cpu"') < fwd.index("launch(")
    assert f"{bwd}(" in inspect.getsource(getattr(ops_mod, function).backward)
    dispatch = inspect.getsource(getattr(ops_mod, bwd))
    assert dispatch.index('device.type == "cpu"') < dispatch.index("launch_bwd(")
    if wrapper == "wkv6":
        ops_, _ = _wkv6_inputs(1, 4, 1, 16)
        out = ops_mod.wkv6(*(_t(x).requires_grad_(True) for x in ops_[:5]), chunk=4)[0]
    else:
        ops_, _ = _ssd_inputs(1, 4, 1, 16, 8, 1)
        out = ops_mod.ssd(*(_t(m).requires_grad_(True) for m in ops_[:5]), chunk=4)[0]
    assert type(out.grad_fn).__name__.startswith(function)


@pytest.mark.parametrize("ops_mod", [wkv6_ops, ssd_ops])
def test_cpu_backward_leaves_launch_counters_at_zero(ops_mod):
    ops_mod.launches.reset()
    ops_mod.bwd_launches.reset()
    if ops_mod is wkv6_ops:
        ops_, _ = _wkv6_inputs(2, 12, 2, 16, seed=23)
        leaves = [_t(x).requires_grad_(True) for x in ops_]
        out, final = ops_mod.wkv6(*leaves[:5], state=leaves[5], chunk=4)
    else:
        ops_, _ = _ssd_inputs(2, 12, 2, 16, 8, 1, seed=23)
        leaves = [_t(m).requires_grad_(True) for m in ops_]
        out, final = ops_mod.ssd(*leaves[:5], state=leaves[5], chunk=4)
    torch.autograd.grad(out.sum() + final.sum(), leaves)
    assert ops_mod.launches.count == ops_mod.bwd_launches.count == 0


@pytest.mark.parametrize("ops_mod,source,entry,want", [
    (wkv6_ops, "wkv6_bwd.cu", "wkv6_bwd", {str(d) for d in wkv6_ops.HEAD_DIMS}),
    (ssd_ops, "ssd_bwd.cu", "ssd_bwd", {f"{p}{n:03d}" for p, n in ssd_ops.SHAPES})])
def test_backward_kernel_is_built_for_every_shape_the_wrapper_takes(ops_mod, source, entry,
                                                                     want):
    src = (Path(ops_mod.__file__).parent / "csrc" / source).read_text()
    assert Path(ops_mod.BWD_SOURCES[0]).name == source
    body = src[src.index(f'extern "C" int {entry}'):] if entry == "ssd_bwd" else \
        src[src.index("cudaError_t dispatch("):]
    assert set(re.findall(r"case (\d+):", body)) == want


def test_no_forward_only_guard_is_left():
    """``build.check_no_grad`` went with the last forward-only kernel:
    nothing in the port refers to it, and no wrapper catches an error."""
    root = Path(wkv6_ops.__file__).parents[2]
    for path in root.rglob("*.py"):
        assert "check_no_grad" not in path.read_text(), path
    for mod in (wkv6_ops, ssd_ops):
        tree = ast.parse(Path(mod.__file__).read_text())
        assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))

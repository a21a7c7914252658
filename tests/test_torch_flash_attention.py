"""The port's flash attention (``repro_torch.kernels.flash_attention``) against
the reference, on the CPU.

On the CPU the wrappers take the kernel's plain versions; these tests hold
them to the reference's oracle ``attention_ref`` and to its Pallas kernel
(interpret mode on the CPU, as tests/test_kernels.py runs it, at S <= 256)
over ``test_flash_attention_sweep``'s grid, the model-layout GQA form to the
reference's ``ops.gqa_flash_attention`` (Pallas and ref) at groups 2, 3 and
3 with 8 KV heads, and a ragged S = 100 (which the Pallas kernel does not
take) to the oracle.  The CUDA kernel itself is held to the plain version on
the card by ``chip_smoke.py``.

The backward: the plain backward ``ref.gqa_attention_bwd_ref`` (the CPU
path of ``ops.FlashAttention`` and the oracle of the backward kernel) against
torch.autograd through ``gqa_attention_ref`` and against ``jax.grad`` of the
reference's ``attention_ref`` with repeated KV heads, float32 atol 5e-5 /
rtol 1e-4; the Function under ``torch.func.vmap`` against a loop over the
mapped axis.

Tolerances: tests/test_kernels.py's, float32 atol 5e-5 / rtol 1e-4 and bf16
atol = rtol = 5e-2.
"""
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ops import gqa_flash_attention as jgqa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

TOL = {"float32": dict(atol=5e-5, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
SWEEP = [(128, 32, 32, 32), (256, 64, 64, 128), (64, 128, 64, 16)]  # (s, d, block_q, block_k)
MASKS = [(True, None), (True, 64), (False, None)]


def _draw(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(a, dtype):
    """The same numpy draw as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.as_tensor(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("s,d,bq,bk", SWEEP)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle_and_pallas(s, d, bq, bk, causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_draw((1, 2, s, d), i), dtype) for i in range(3))
    want = jattention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = jflash(jq, jk, jv, causal=causal, window=window, block_q=bq, block_k=bk)
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    wrapped = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    for out in (got, wrapped):
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("h,kh", [(4, 2), (9, 3), (24, 8)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_gqa_form_matches_reference_ops(h, kh, causal, window):
    b, s, d = 2, 64, 32
    jq, tq = _pair(_draw((b, s, h, d), 0), "float32")
    (jk, tk), (jv, tv) = (_pair(_draw((b, s, kh, d), i), "float32") for i in (1, 2))
    got = ops.gqa_flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(jgqa(jq, jk, jv, causal=causal, window=window,
                                                     impl="ref")), **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), _np(jgqa(jq, jk, jv, causal=causal, window=window,
                                                     block_q=32, block_k=32)),
                               **TOL["float32"])
    # the per-KV-head loop equals the expanded oracle
    expand = lambda x: x.repeat_interleave(h // kh, dim=2).transpose(1, 2)  # noqa: E731
    want = ref.attention_ref(tq.transpose(1, 2), expand(tk), expand(tv), causal=causal,
                             window=window).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_length_matches_oracle(causal, window, dtype):
    """S = 100 is no multiple of any tile; the Pallas kernel asserts
    S % block == 0, the port's wrapper takes any S."""
    s, h, kh, d = 100, 4, 2, 32
    jq, tq = _pair(_draw((1, s, h, d), 3), dtype)
    (jk, tk), (jv, tv) = (_pair(_draw((1, s, kh, d), i), dtype) for i in (4, 5))
    got = ops.gqa_flash_attention(tq, tk, tv, causal=causal, window=window)
    rep = lambda x: jnp.repeat(x.transpose(0, 2, 1, 3), h // kh, axis=1)  # noqa: E731
    want = jattention_ref(jq.transpose(0, 2, 1, 3), rep(jk), rep(jv), causal=causal,
                          window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_scale_and_tiny_lengths():
    for s in (1, 5):
        q, k, v = (torch.as_tensor(_draw((2, s, 4, 32), i)) for i in range(3))
        for scale in (None, 0.3):
            got = ops.gqa_flash_attention(q, k, v, scale=scale)
            want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     scale=scale).transpose(1, 2)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])
    # one visible key: the first row's output is its own value
    np.testing.assert_allclose(got[:, 0].numpy(), v[:, 0].numpy(), **TOL["float32"])


def test_cpu_calls_count_no_launch():
    ops.launches.reset()
    q, k, v = (torch.as_tensor(_draw((1, 16, 2, 32), i)) for i in range(3))
    ops.gqa_flash_attention(q, k, v)
    ops.flash_attention(q, k, v, window=4)
    assert ops.launches.count == 0


def test_kernel_operand_layouts():
    """What the kernel reads in place and what the wrapper copies first."""
    x = torch.zeros(2, 8, 4, 32, dtype=torch.bfloat16)
    assert ops._kernel_operand(x) is x
    view = x.transpose(1, 2)  # (B, H, S, D) view: strides multiples of 8, unit last
    assert ops._kernel_operand(view) is view
    odd = x[..., 1:17]  # bf16 data 2 bytes past a 16-byte boundary
    assert ops._kernel_operand(odd) is not odd and ops._kernel_operand(odd).is_contiguous()
    f32 = torch.zeros(2, 8, 4, 32)[..., 1:17]  # float32 reads need only a unit last stride
    assert ops._kernel_operand(f32) is f32
    assert ops._kernel_operand(x.transpose(2, 3)).is_contiguous()


@pytest.mark.parametrize("case,exc", [
    (dict(q=(1, 8, 4, 32), k=(1, 8, 3, 32)), ValueError),  # heads not a multiple
    (dict(q=(1, 8, 4, 32), k=(1, 9, 2, 32)), ValueError),  # lengths differ
    (dict(q=(1, 8, 4, 32), k=(1, 8, 2, 16)), ValueError),  # widths differ
    (dict(q=(8, 4, 32), k=(8, 2, 32)), ValueError),  # not 4-d
    (dict(q=(1, 8, 4, 32), k=(1, 8, 2, 32), dtype=torch.float16), TypeError),
    (dict(q=(1, 8, 4, 32), k=(1, 8, 2, 32), window=0), ValueError),
    (dict(q=(1, 8, 4, 32), k=(1, 8, 2, 32), device="meta"), ValueError),
])
def test_bad_operands_raise(case, exc):
    dtype, device = case.get("dtype", torch.float32), case.get("device", "cpu")
    q = torch.zeros(case["q"], dtype=dtype, device=device)
    k = torch.zeros(case["k"], dtype=dtype, device=device)
    with pytest.raises(exc):
        ops.gqa_flash_attention(q, k, k, window=case.get("window"))


def test_mixed_types_raise():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(TypeError):
        ops.gqa_flash_attention(q, q.bfloat16(), q.bfloat16())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 32, "float32"), (torch.float32, 128, "float32"),
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 128, "wgmma"),
])
def test_kernel_route(dtype, d, route):
    """bf16 at D = 64, 80 and 128 takes the forward's wgmma + TMA code, D =
    32 mma.sync; the CUDA source's route function is the same rule."""
    assert ops.kernel_route(dtype, d) == route
    src = Path(ops.SOURCES[0]).read_text()
    assert "(d == 64 || d == 80 || d == 128) ? 2 : 1" in src
    assert ops.ROUTES[2] == "wgmma" and set(ops.WGMMA_HEAD_DIMS) == {64, 80, 128}


def _source_route(src: str, dtype: torch.dtype, d: int) -> str:
    """The route a CUDA source's one-line ``int route(int dtype, int d)``
    returns for (dtype, d): it must read ``dtype == 0 ? 0 : (d == a || ...)
    ? 2 : 1``, the widths a, ... on wgmma."""
    line = next(x for x in src.splitlines() if x.startswith("int route(int dtype, int d)"))
    m = re.fullmatch(r"int route\(int dtype, int d\) \{ return dtype == 0 \? 0 : "
                     r"\(((?:d == \d+(?: \|\| )?)+)\) \? 2 : 1; \}", line)
    assert m, line
    wgmma = {int(w) for w in re.findall(r"d == (\d+)", m.group(1))}
    return ops.ROUTES[0 if dtype == torch.float32 else 2 if d in wgmma else 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_bwd_kernel_route(dtype, d):
    """The backward's route (bf16 at D = 64 and 128 on wgmma + TMA, D = 32
    and 80 on mma.sync, float32 on the float32 pipes): ``ops.bwd_kernel_route``
    is the backward source's ``route`` for every (dtype, D), and the forward's
    ``kernel_route`` its source's."""
    bwd = Path(ops.BWD_SOURCES[0]).read_text()
    assert ops.bwd_kernel_route(dtype, d) == _source_route(bwd, dtype, d)
    assert ops.kernel_route(dtype, d) == _source_route(Path(ops.SOURCES[0]).read_text(), dtype, d)
    want = ("float32" if dtype == torch.float32 else
            "wgmma" if d in (64, 128) else "mma_sync")
    assert ops.bwd_kernel_route(dtype, d) == want
    assert '#include "hopper.cuh"' in bwd


@pytest.mark.parametrize("d", [80, 128])
def test_tma_operand_rule(d):
    """The TMA maps take any strides that are multiples of 16 bytes from a
    16-byte-aligned base: the (B, H, S, D) entry's transposed views and the
    model's layouts pass uncopied; a view off alignment or with a row stride
    of an odd number of elements is copied, contiguous."""
    bhsd = torch.zeros(2, 4, 16, d, dtype=torch.bfloat16)
    view = bhsd.transpose(1, 2)  # (B, S, H, D) view of (B, H, S, D)
    assert ops._kernel_operand(view) is view
    model = torch.zeros(2, 16, 4, d, dtype=torch.bfloat16)
    assert ops._kernel_operand(model) is model
    flat = torch.zeros(2 * 16 * 4 * d + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 16, 4, d)  # 2 bytes past a 16-byte boundary
    copied = ops._kernel_operand(shifted)
    assert copied is not shifted and copied.is_contiguous() and copied.data_ptr() % 16 == 0
    odd = torch.zeros(2, 16, 4, d + 1, dtype=torch.bfloat16)[..., :d]  # head stride d + 1
    assert ops._kernel_operand(odd).is_contiguous()
    torch.testing.assert_close(ops._kernel_operand(odd), odd)


# ---------------------------------------------------------------------------
# the backward: the plain backward, the autograd Function and its vmap rule
# ---------------------------------------------------------------------------

BWD_CASES = [(s, h, kh, causal, window) for s in (64, 100) for h, kh in ((2, 2), (4, 2), (6, 2))
             for causal, window in MASKS]


@pytest.mark.parametrize("s,h,kh,causal,window", BWD_CASES)
def test_plain_backward_matches_autograd_and_jax(s, h, kh, causal, window):
    """Groups 1, 2 and 3, causal, windowed and non-causal, S = 64 and a
    ragged 100."""
    b, d = 2, 32
    seed = s + 10 * h + (window or 0)
    q, k, v = (torch.as_tensor(_draw(shape, seed + i))
               for i, shape in enumerate(((b, s, h, d), (b, s, kh, d), (b, s, kh, d))))
    dout = torch.as_tensor(_draw((b, s, h, d), seed + 3))
    out, lse = ref.gqa_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    got = ref.gqa_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window)

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ref.gqa_attention_ref(*leaves, causal=causal, window=window),
                               leaves, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL["float32"])

    def jloss(jq, jk, jv):
        rep = lambda x: jnp.repeat(x.transpose(0, 2, 1, 3), h // kh, axis=1)  # noqa: E731
        o = jattention_ref(jq.transpose(0, 2, 1, 3), rep(jk), rep(jv), causal=causal,
                           window=window).transpose(0, 2, 1, 3)
        return jnp.sum(o * jnp.asarray(dout.numpy()))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for g, w in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL["float32"])
    # the log-sum-exp is the one of the masked scaled scores
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(h // kh, dim=2)) * d**-0.5
    mask = ref._mask(s, causal=causal, window=window, device="cpu")
    want_lse = torch.logsumexp(torch.where(mask, scores, ref.NEG_INF), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_gradients_match_plain_backward(dtype):
    """The wrapper under autograd goes through ``FlashAttention``: its
    gradients are the plain backward's, in the operands' type."""
    tdtype = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(_draw(shape, 20 + i)).to(tdtype).requires_grad_(True)
               for i, shape in enumerate(((2, 40, 6, 32), (2, 40, 2, 32), (2, 40, 2, 32))))
    dout = torch.as_tensor(_draw((2, 40, 6, 32), 23)).to(tdtype)
    out = ops.gqa_flash_attention(q, k, v, window=16)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad(out, (q, k, v), dout)
    o, lse = ref.gqa_attention_ref(q.detach(), k.detach(), v.detach(), window=16,
                                   return_lse=True)
    want = ref.gqa_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, dout, lse,
                                     window=16)
    for g, w in zip(got, want):
        assert g.dtype == tdtype and g.shape == w.shape
        assert torch.equal(g, w)
    # without autograd the forward writes no log-sum-exp and makes no node
    with torch.no_grad():
        assert ops.gqa_flash_attention(q, k, v).grad_fn is None


def test_function_under_vmap_matches_loop():
    """``torch.func.vmap`` of the wrapper over a leading peer axis (the
    port's stacked peers) folds that axis into the batch: outputs and
    gradients equal a loop over the peers; with one operand unmapped too."""
    kp = 3
    q, k, v = (torch.as_tensor(_draw(shape, 30 + i)).requires_grad_(True)
               for i, shape in enumerate(((kp, 2, 24, 4, 32), (kp, 2, 24, 2, 32),
                                          (kp, 2, 24, 2, 32))))
    dout = torch.as_tensor(_draw((kp, 2, 24, 4, 32), 33))
    fn = torch.func.vmap(lambda a, b_, c: ops.gqa_flash_attention(a, b_, c, window=8))
    out = fn(q, k, v)
    loop = torch.stack([ref.gqa_attention_ref(q[i], k[i], v[i], window=8) for i in range(kp)])
    np.testing.assert_allclose(out.detach().numpy(), loop.detach().numpy(), **TOL["float32"])
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(loop, (q, k, v), dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL["float32"])
    shared_v = v[0].detach().clone().requires_grad_(True)
    out = torch.func.vmap(lambda a, b_, c: ops.gqa_flash_attention(a, b_, c),
                          in_dims=(0, 0, None))(q, k, shared_v)
    loop = torch.stack([ref.gqa_attention_ref(q[i], k[i], shared_v) for i in range(kp)])
    g_out = torch.autograd.grad(out, shared_v, dout)[0]
    g_loop = torch.autograd.grad(loop, shared_v, dout)[0]
    np.testing.assert_allclose(g_out.numpy(), g_loop.numpy(), **TOL["float32"])
    # vmap of grad runs the plain backward under the transform too
    per_peer = torch.func.vmap(torch.func.grad(
        lambda a, b_, c: ops.gqa_flash_attention(a, b_, c).square().sum(), argnums=(0, 1, 2)))
    gg = per_peer(q.detach(), k.detach(), v.detach())
    total = sum(ref.gqa_attention_ref(q[i], k[i], v[i]).square().sum() for i in range(kp))
    for g, w in zip(gg, torch.autograd.grad(total, (q, k, v))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=1e-4)


def test_backward_dispatch_and_counts():
    """The backward takes the plain version on CPU tensors and launches the
    backward kernel on CUDA tensors, with nothing between them; CPU calls
    count no launch either way."""
    src = inspect.getsource(ops.attention_bwd)
    assert src.index('device.type == "cpu"') < src.index("launch_bwd(")
    assert "try" not in src
    ops.launches.reset()
    ops.bwd_launches.reset()
    q = torch.as_tensor(_draw((1, 16, 2, 32), 40)).requires_grad_(True)
    ops.gqa_flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert ops.launches.count == 0 and ops.bwd_launches.count == 0
    assert "flash_attention_bwd" in Path(ops.BWD_SOURCES[0]).read_text()

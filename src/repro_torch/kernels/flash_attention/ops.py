"""Public API of the flash-attention kernel (the port's
``repro.kernels.flash_attention.ops``).

``gqa_flash_attention`` computes softmax attention over q (B, S, H, D) and
grouped k, v (B, S, Kh, D) (query head h reads KV head h // (H // Kh)),
causal, sliding-window or non-causal, with float32 scores and softmax, and
returns (B, S, H, D) in q's type.  It replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py:flash_attention`` and its
GQA wrapper ``ops.gqa_flash_attention``, which repeats the KV heads and
transposes; here the kernel reads the model's layouts in place through their
strides.  ``flash_attention`` takes the reference kernel's (B, H, S, D)
layout (KV heads already expanded), through the same kernel.  Unlike the
Pallas kernel, S need not be a multiple of the tile.

Dispatch is by the device of the operands, and only by it:

- CPU tensors take the plain PyTorch version (``ref.gqa_attention_ref``);
- CUDA tensors launch the hand-written kernel (``csrc/flash_attention.cu``,
  built for sm_90a and loaded with ctypes on first use) or raise — there is
  no fallback;
- any other device raises;
- fake tensors (the dry run's stand-ins, no data) follow the CUDA branch up
  to the launch, which records the call's shapes instead
  (``repro_torch.kernels.fake``): nothing is built or launched.

Every call goes through ``FlashAttention``, a ``torch.autograd.Function``:
where an operand requires grad the forward also writes the float32 row
log-sum-exp (B, H, S), and the backward launches
the backward kernel (``csrc/flash_attention_bwd.cu``: rowsum(dO O), then dK
and dV over each KV tile and its query group, then dQ over each query tile;
deterministic, no atomics; its route by (dtype, D) is
``bwd_kernel_route``: bf16 at D = 64 and 128 on ``wgmma`` with TMA loads,
bf16 at D = 32 and 80 on ``mma.sync``, float32 on the float32 pipes) on
CUDA tensors and the plain backward
(``ref.gqa_attention_bwd_ref``) on CPU tensors, with no fallback between the
two.  Its ``vmap`` rule folds the vmapped axis (the port's stacked peers)
into the batch axis, so one forward and one backward launch a layer serve
every peer.  Without autograd the forward is the one the served prefill
runs: no log-sum-exp is written.

The kernel takes float32 (computed in float32 on the float32 pipes) and
bfloat16 (tensor cores, float32 accumulation) at head widths 32, 64, 80 and
128.  Which code runs is a rule on (dtype, D) alone (``kernel_route``):
bf16 at D = 64, 80 and 128 on ``wgmma`` with TMA loads (128 query rows a
block, a producer warp and two consumer warpgroups); bf16 at D = 32 on
``mma.sync``; float32 on the float32 pipes.  The
TMA maps read the operands through their strides, so the rule for an
operand the kernel takes in place is the same for every route: unit stride
on the last axis and, for bf16, the other strides multiples of 8 elements
(16 bytes) and the data 16-byte aligned; anything else is copied first
(``_kernel_operand``).

Bound on an H100 SXM (see the note in the CUDA source): at the serving
prefill's B 4, S 1024, H 32, Kh 8, D 128, causal, one call does
34.4 GFLOP (0.0348 ms at 989 TFLOP/s bf16) against 83.9 MB (0.025 ms at
3.35 TB/s): it is bound by operations.

``launches.count`` counts forward launches and ``bwd_launches.count``
backward launches (one a backward call, its three kernels together), never
plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, fake
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.flash_attention import ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"]
HEAD_DIMS = (32, 64, 80, 128)  # the head widths the kernel is instantiated for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype argument
# the route codes of flash_attention_route and flash_attention_bwd_route
ROUTES = ("float32", "mma_sync", "wgmma")
WGMMA_HEAD_DIMS = (64, 80, 128)  # the forward's bf16 widths on wgmma
BWD_WGMMA_HEAD_DIMS = (64, 128)  # the backward's

launches = LaunchCounter()
bwd_launches = LaunchCounter()


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("flash_attention", SOURCES)
    fn = kl.lib.flash_attention_fwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 4 + [i64] * 6 + [ctypes.POINTER(i64), i64, i64, ctypes.c_double, ptr]
    fn.restype = ctypes.c_int
    fn = kl.lib.flash_attention_fwd_lse
    fn.argtypes = [ptr] * 5 + [i64] * 6 + [ctypes.POINTER(i64), i64, i64, ctypes.c_double, ptr]
    fn.restype = ctypes.c_int
    for name in ("flash_attention_smem_bytes", "flash_attention_route"):
        getattr(kl.lib, name).argtypes = [i64, i64]
        getattr(kl.lib, name).restype = i64
    return kl


@functools.cache
def load_bwd_kernel() -> build.KernelLibrary:
    """Build (first call) and load the backward kernel library; declares its
    C signature."""
    kl = build.load_library("flash_attention_bwd", BWD_SOURCES)
    fn = kl.lib.flash_attention_bwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 10 + [i64] * 6 + [ctypes.POINTER(i64), i64, i64, ctypes.c_double,
                                            ptr]
    fn.restype = ctypes.c_int
    kl.lib.flash_attention_bwd_route.argtypes = [i64, i64]
    kl.lib.flash_attention_bwd_route.restype = i64
    kl.lib.flash_attention_bwd_scratch.argtypes = [i64, i64, i64]
    kl.lib.flash_attention_bwd_scratch.restype = i64
    return kl


BWD_ROW_PAD = 128  # csrc/flash_attention_bwd.cu's kRowPad: the scratch rows' multiple


def bwd_scratch(b: int, h: int, s: int, device, *, fake_operands: bool = False) -> torch.Tensor:
    """The backward's float32 scratch for (B, H, S): rowsum(dO O) and the
    lse times log2(e), each in rows of S padded to the source's multiple
    (the library's ``flash_attention_bwd_scratch``; for ``fake_operands``,
    the fake route's, the same rule here: nothing is built)."""
    n = (2 * b * h * (-(-s // BWD_ROW_PAD) * BWD_ROW_PAD) if fake_operands
         else load_bwd_kernel().lib.flash_attention_bwd_scratch(b, h, s))
    return torch.empty(n, dtype=torch.float32, device=device)


def kernel_route(dtype: torch.dtype, d: int) -> str:
    """The code a CUDA forward call of ``dtype`` at head width ``d`` runs:
    ``"wgmma"`` (bf16 at D = 64, 80 and 128), ``"mma_sync"`` (bf16 at
    D = 32) or ``"float32"``; the CUDA source's ``route`` is the same rule."""
    if dtype == torch.float32:
        return "float32"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma_sync"


def bwd_kernel_route(dtype: torch.dtype, d: int) -> str:
    """The code a CUDA backward call of ``dtype`` at head width ``d`` runs:
    ``"wgmma"`` (bf16 at D = 64 and 128), ``"mma_sync"`` (bf16 at D = 32
    and 80) or ``"float32"``; the backward source's ``route`` is the same
    rule."""
    if dtype == torch.float32:
        return "float32"
    return "wgmma" if d in BWD_WGMMA_HEAD_DIMS else "mma_sync"


def check_inputs(q, k, v, window) -> None:
    """Validate shapes, types and devices (every device)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, S, Kh, D) = ({b}, {s}, Kh, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"query heads {h} must be a multiple of KV heads {k.shape[2]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPE_CODES:
            raise TypeError(f"flash attention takes float32 or bfloat16 {name}, got {x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if s < 1:
        raise ValueError("flash attention needs S >= 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: unit stride on the last axis and, for
    bf16 (16-byte loads and TMA, whose strides and base must be multiples of
    16 bytes), every other stride a multiple of 8 elements and the data
    16-byte aligned; anything else is copied to a contiguous tensor."""
    aligned = x.stride(-1) == 1
    if x.dtype == torch.bfloat16:
        aligned = aligned and all(st % 8 == 0 for st in x.stride()[:-1]) \
            and fake.address(x) % 16 == 0
    # clone, not contiguous(): a contiguous view off alignment must be copied too
    return x if aligned else x.clone(memory_format=torch.contiguous_format)


def launch(q, k, v, out, *, causal: bool, window: int | None, scale: float,
           lse: torch.Tensor | None = None) -> None:
    """Launch the kernel on the current stream into ``out`` (B, S, H, D) and,
    given one, the contiguous float32 ``lse`` (B, H, S).

    No checks: callers pass CUDA operands that ``check_inputs`` validated,
    with strides the kernel reads (``_kernel_operand``), and a contiguous
    ``out``.  Counts the launch and raises if CUDA refused it.  Fake
    operands take the fake route: the call is recorded, nothing built or
    launched.
    """
    b, s, h, d = q.shape
    if fake.is_fake(out):
        fake.record("flash_attention", b=b, s=s, h=h, kh=k.shape[2], d=d, causal=causal,
                    window=window, elem_bytes=q.element_size())
        return
    lib = load_kernel().lib
    strides = (ctypes.c_int64 * 12)(*(st for x in (q, k, v, out) for st in x.stride()[:3]))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is None:
        fn, args = lib.flash_attention_fwd, ptrs
    else:
        fn, args = lib.flash_attention_fwd_lse, (*ptrs, lse.data_ptr())
    err = fn(
        *args, DTYPE_CODES[q.dtype],
        b, s, h, k.shape[2], d, strides, int(causal), window or 0, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with cudaError_t {err}")
    launches.count += 1


def launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, delta, *, causal: bool,
               window: int | None, scale: float) -> None:
    """Launch the backward kernels on the current stream: the float32
    scratch ``delta`` (``bwd_scratch``) receives rowsum(dO O) and the lse
    times log2(e), then ``dk``, ``dv`` (B, S, Kh, D) and ``dq`` (B, S, H,
    D), contiguous, in the operands' type.

    No checks: callers pass CUDA operands that ``check_inputs`` validated,
    ``out`` and ``dout`` of q's shape and type, all read through strides the
    kernel takes (``_kernel_operand``), and the forward's contiguous
    ``lse``.  Counts one backward launch and raises if CUDA refused one.
    Fake operands take the fake route, as ``launch``'s.
    """
    b, s, h, d = q.shape
    if fake.is_fake(dq):
        fake.record("flash_attention_bwd", b=b, s=s, h=h, kh=k.shape[2], d=d, causal=causal,
                    window=window, elem_bytes=q.element_size())
        return
    fn = load_bwd_kernel().lib.flash_attention_bwd
    strides = (ctypes.c_int64 * 15)(*(st for x in (q, k, v, out, dout) for st in x.stride()[:3]))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        DTYPE_CODES[q.dtype], b, s, h, k.shape[2], d, strides, int(causal), window or 0,
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed with cudaError_t {err}")
    bwd_launches.count += 1


def _forward(q, k, v, causal: bool, window: int | None, scale: float,
             with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(out, lse or None) by the device of the operands: the plain version
    on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        if with_lse:
            return ref.gqa_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                         return_lse=True)
        return ref.gqa_attention_ref(q, k, v, causal=causal, window=window, scale=scale), None
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    launch(*(_kernel_operand(x) for x in (q, k, v)), out, causal=causal, window=window,
           scale=scale, lse=lse)
    return out, lse


def attention_bwd(q, k, v, out, dout, lse, *, causal: bool, window: int | None,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the device of the operands: the plain backward
    (``ref.gqa_attention_bwd_ref``) on the CPU, the backward kernel on
    CUDA."""
    if q.device.type == "cpu":
        return ref.gqa_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                         window=window, scale=scale)
    q, k, v, out, dout = (_kernel_operand(x) for x in (q, k, v, out, dout))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    delta = bwd_scratch(q.shape[0], q.shape[2], q.shape[1], q.device,
                        fake_operands=fake.is_fake(q))
    launch_bwd(q, k, v, out, dout, lse.contiguous(), dq, dk, dv, delta, causal=causal,
               window=window, scale=scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``gqa_flash_attention`` under autograd: (out, lse) from (q, k, v);
    lse is not differentiable.  ``vmap`` folds the vmapped axis into the
    batch axis, so a vmapped call is one launch each way."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, with_lse):
        out, lse = _forward(q, k, v, causal, window, scale, with_lse)
        if lse is None:  # no backward will read it
            lse = q.new_empty((0,), dtype=torch.float32)
        return out, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale, _ = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, scale)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.attrs
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window,
                                   scale=scale)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale, with_lse):
        n = info.batch_size

        def fold(x, dim):
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        qf, kf, vf = (fold(x, dim) for x, dim in zip((q, k, v), in_dims[:3]))
        # below the vmap level autograd sees whether the operands need grad
        with_lse = with_lse or (torch.is_grad_enabled()
                                and any(x.requires_grad for x in (qf, kf, vf)))
        out, lse = FlashAttention.apply(qf, kf, vf, causal, window, scale, with_lse)
        out = out.view(n, -1, *out.shape[1:])
        lse = lse.view(n, -1, *lse.shape[1:]) if lse.numel() else lse.expand(n, 0)
        return (out, lse), (0, 0)


def gqa_flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Kh, D)
    v: torch.Tensor,  # (B, S, Kh, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention of q over grouped k, v: (B, S, H, D) in q's type; ``scale``
    defaults to D**-0.5."""
    fake.check_device(q, "flash attention")
    check_inputs(q, k, v, window)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type != "cpu" and q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel is built for head widths {HEAD_DIMS}, "
                         f"got D={q.shape[-1]}")
    # the row log-sum-exp only where a backward will read it
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, scale, grad)[0]


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, H, S, D)
    v: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The reference kernel's layout: (B, H, S, D) in, a (B, H, S, D) view
    out.  The kernel reads the operands in place through transposed views."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return gqa_flash_attention(qt, kt, vt, causal=causal, window=window,
                               scale=scale).transpose(1, 2)

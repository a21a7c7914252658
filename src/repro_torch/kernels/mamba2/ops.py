"""Public API of the chunked Mamba2 SSD kernel (the port's
``repro.kernels.mamba2.ops``).

``ssd`` computes the Mamba2 SSD recurrence over x (B, T, H, P) and grouped
B/C (B, T, G, N) chunk by chunk, from a carried (B, H, P, N) float32 state,
and returns the float32 output and the final state.  It replaces the Pallas
TPU kernel ``repro/kernels/mamba2/mamba2.py:ssd_chunked`` and, on the
model's prefill path, the chunk scan of
``repro/models/ssm.py:mamba2_apply_chunked``: with ``state=None``, G = H and
``T % chunk == 0`` its output is the Pallas kernel's (in float32); it also
takes the state in and gives the state out that the chunk scan carries,
takes any T (a ragged last chunk gives what the chunk scan's zero padding
gives), and reads head h's B/C group h // (H // G) in place, where the
reference repeats the groups.  The D x skip stays with the caller.

Dispatch is by the device of the operands, and only by it:

- CPU tensors take the plain PyTorch version (``ref.ssd_chunked_ref``);
- CUDA tensors launch the hand-written kernel (``csrc/ssd.cu``, built for
  sm_90a and loaded with ctypes on first use) or raise — there is no
  fallback;
- any other device raises.

The kernel is forward only: on a CUDA tensor, with autograd on, an operand
that requires grad raises ``NotImplementedError`` (``build.check_no_grad``)
rather than cut the graph; the CPU path differentiates as usual.

x, B and C are float32 or bfloat16 (one type; bf16 is widened in the
kernel, so it computes what the reference's float32 cast computes); dt and
a are float32.  The kernel runs its chunk products on the tensor cores in
TF32, each float32 operand split into two TF32 parts so that the products
keep float32 accuracy: two passes a product with bf16 inputs (one for
C B^T), three with float32 inputs (``kernel_route``).  A (b, h) is split
over 1, 2 or 4 blocks of its P columns (``kernel_split``).  Bound on an
H100 SXM (see the note in the CUDA source): at B 4, T 1024, H 80,
P = N = 64, G 1, chunk 64, bf16 x, B and C as served, one call from a zero
state moves 133 MB (0.040 ms at 3.35 TB/s) and does 14.8 GFLOP of TF32
passes (0.030 ms at 495 TFLOP/s dense TF32): it is bound by bytes.

``launches.count`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.mamba2 import ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "ssd.cu"]
# the (P, N) the kernel is instantiated for: zamba2's, the reduced config's
# and tests/test_kernels.py:test_ssd_sweep's
SHAPES = ((64, 64), (64, 32), (32, 16), (16, 8))
MAX_CHUNK = 64  # kMaxChunk in the CUDA source
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype argument
BLOCKS_PER_SM = 2  # kBlocksPerSm: the blocks an SM the split aims for
SPLITS = (1, 2, 4)
# kWidest / kNarrowest: the columns of P a block owns at most / at least, by
# input type (a float32 block of 64 columns leaves one block an SM, and
# float32's three passes make the C B^T every block recomputes dear)
SLICES = {torch.bfloat16: (16, 64), torch.float32: (32, 32)}
# the TF32 passes of each product (ssd_route's code) by input type: bf16 x,
# B and C are exact in TF32, so only the float32 operand of a product splits
ROUTES = {2: "tf32x2", 3: "tf32x3"}

launches = LaunchCounter()


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("ssd", SOURCES)
    fn = kl.lib.ssd_fwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 8 + [i64] * 8 + [ctypes.POINTER(i64), ptr]
    fn.restype = ctypes.c_int
    kl.lib.ssd_split.argtypes = [i64] * 4
    kl.lib.ssd_split.restype = ctypes.c_int
    kl.lib.ssd_route.argtypes = [i64]
    kl.lib.ssd_route.restype = ctypes.c_int
    return kl


def check_inputs(x, b, c, dt, a, state, chunk: int) -> int:
    """Validate the operands; returns the chunk length used, ``min(chunk, T)``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, T, H, P), got shape {tuple(x.shape)}")
    bs, t, h, p = x.shape
    if b.dim() != 4 or b.shape != c.shape or tuple(b.shape[:2]) != (bs, t):
        raise ValueError(f"b and c must be (B, T, G, N) with (B, T) = {(bs, t)}, got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    g, n = b.shape[2], b.shape[3]
    if g < 1 or h % g != 0:
        raise ValueError(f"heads {h} must be a multiple of the B/C groups {g}")
    for name, m in (("x", x), ("b", b), ("c", c)):
        if m.dtype not in DTYPE_CODES:
            raise TypeError(f"ssd takes float32 or bfloat16 {name}, got {m.dtype}")
        if m.dtype != x.dtype:
            raise TypeError(f"{name} is {m.dtype}, x is {x.dtype}")
    if tuple(dt.shape) != (bs, t, h) or dt.dtype != torch.float32:
        raise ValueError(f"dt must be (B, T, H) = {(bs, t, h)} float32, got "
                         f"{tuple(dt.shape)} {dt.dtype}")
    if tuple(a.shape) != (h,) or a.dtype != torch.float32:
        raise ValueError(f"a must be (H,) = {(h,)} float32, got {tuple(a.shape)} {a.dtype}")
    if state is not None and (tuple(state.shape) != (bs, h, p, n)
                              or state.dtype != torch.float32):
        raise ValueError(f"state must be (B, H, P, N) = {(bs, h, p, n)} float32, got "
                         f"{tuple(state.shape)} {state.dtype}")
    for name, m in (("b", b), ("c", c), ("dt", dt), ("a", a), ("state", state)):
        if m is not None and m.device != x.device:
            raise ValueError(f"{name} is on {m.device}, x on {x.device}")
    if (p, n) not in SHAPES:
        raise ValueError(f"the ssd kernel is built for (P, N) in {SHAPES}, got {(p, n)}")
    if t < 1:
        raise ValueError("ssd needs T >= 1")
    q = min(int(chunk), t)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    return q


def kernel_split(bh: int, p: int, dtype: torch.dtype, sm_count: int) -> int:
    """Blocks a (b, h) is split over, each owning P / split columns, for x,
    B and C of ``dtype``: the smallest of ``SPLITS`` whose slices are at
    most the type's widest (``SLICES``) and that gives ``BLOCKS_PER_SM``
    blocks an SM over ``bh`` (b, h) pairs, else the largest whose slices are
    at least the type's narrowest.  The CUDA source's ``ssd_split`` is the
    same rule."""
    narrowest, widest = SLICES[dtype]
    split = p // widest if p > widest else 1
    while split < SPLITS[-1] and p // (2 * split) >= narrowest \
            and bh * split < BLOCKS_PER_SM * sm_count:
        split *= 2
    return split


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel's route for inputs of ``dtype``: ``"tf32x2"`` (bf16: the
    float32 operand of each product split in two TF32 parts) or
    ``"tf32x3"`` (float32: both operands split, three passes)."""
    return ROUTES[3 if dtype == torch.float32 else 2]


def _kernel_operand(m: torch.Tensor) -> torch.Tensor:
    """``m`` (B, T, heads, width) as the kernel reads it: each token's
    (heads, width) block contiguous, any (batch, token) strides, its start
    and strides 16-byte aligned (the kernel copies 16 bytes at a time);
    anything else is copied to a contiguous tensor."""
    inner = m.stride(3) == 1 and (m.shape[2] == 1 or m.stride(2) == m.shape[3])
    es = m.element_size()
    aligned = m.data_ptr() % 16 == 0 and all(st * es % 16 == 0 for st in m.stride()[:2])
    return m if inner and aligned else m.contiguous()


def launch(x, b, c, dt, a, state, q: int, y, state_out) -> None:
    """Launch the kernel on the current stream into ``y`` / ``state_out``.

    No checks: callers pass CUDA operands that ``check_inputs`` validated,
    x, b and c as ``_kernel_operand`` leaves them, contiguous dt, a, state
    and outputs.  Counts the launch and raises if CUDA refused it.
    """
    fn = load_kernel().lib.ssd_fwd
    bs, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    strides = (ctypes.c_int64 * 6)(*(st for m in (x, b, c) for st in m.stride()[:2]))
    err = fn(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        DTYPE_CODES[x.dtype], bs, t, h, g, p, n, q, strides,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd launch failed with cudaError_t {err}")
    launches.count += 1


def ssd(
    x: torch.Tensor,  # (B, T, H, P)
    b: torch.Tensor,  # (B, T, G, N)
    c: torch.Tensor,  # (B, T, G, N)
    dt: torch.Tensor,  # (B, T, H) float32, softplus'd
    a: torch.Tensor,  # (H,) float32, negative
    *,
    state: torch.Tensor | None = None,  # (B, H, P, N) float32; None = zeros
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD: returns (y (B, T, H, P), final state (B, H, P, N)),
    both float32."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd runs on cpu or cuda tensors, got {x.device}")
    q = check_inputs(x, b, c, dt, a, state, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, b, c, dt, a, state=state, chunk=q)
    build.check_no_grad("ssd", x, b, c, dt, a, state)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    final = torch.empty((x.shape[0], x.shape[2], x.shape[3], b.shape[3]), dtype=torch.float32,
                        device=x.device)
    launch(*(_kernel_operand(m) for m in (x, b, c)), dt.contiguous(), a.contiguous(),
           None if state is None else state.contiguous(), q, y, final)
    return y, final

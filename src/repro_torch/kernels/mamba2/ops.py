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
- any other device raises;
- fake tensors (the dry run's stand-ins, no data) follow the CUDA branch up
  to the launch, which records the call's shapes instead
  (``repro_torch.kernels.fake``): nothing is built or launched.

Every call goes through ``SSD``, a ``torch.autograd.Function``: its backward
launches the backward kernels (``csrc/ssd_bwd.cu``, chunks of ``ref.BWD_Q``
= 64 tokens: each chunk's log-decay prefix sums; for each (b, h) a pass over
the chunks for the chunk-start states and a reverse one for the chunk-end
gradients, each chunk's product on the tensor cores; then every chunk's dx,
dB, dC, ddt and da from its products with them, in parallel over (b, h,
chunk); dB and dC summed over each group's heads and da over the chunks and
the batch by two small kernels; no atomics; no state saved by the forward)
on CUDA tensors and the plain backward (``ref.ssd_bwd_ref``, the token
recurrence) on CPU tensors, with no fallback between the two
(``ref.ssd_bwd_chunked_ref`` is the kernel's decomposition in plain
PyTorch, for the tests).  Its ``vmap`` rule folds the vmapped axis (the
port's stacked peers) into the batch axis, a free reshape of the model's
(K, B, T, ...) operands that leaves each head's group as it is, and hands
the kernels each peer's a as a row of a (K, H) a that batch element b reads
at b // B: one launch each way serves every peer.  (Folding the peers into
the head axis instead would take a transposed copy of every operand, and
head k H + h would read group k G + h // (H / G).)

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

``launches.count`` counts forward launches and ``bwd_launches.count``
backward launches (one a backward call, its four kernels together), never
plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, fake
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.mamba2 import ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "ssd.cu"]
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" / "ssd_bwd.cu"]
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
bwd_launches = LaunchCounter()


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("ssd", SOURCES)
    fn = kl.lib.ssd_fwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 8 + [i64] * 9 + [ctypes.POINTER(i64), ptr]
    fn.restype = ctypes.c_int
    kl.lib.ssd_split.argtypes = [i64] * 4
    kl.lib.ssd_split.restype = ctypes.c_int
    kl.lib.ssd_route.argtypes = [i64]
    kl.lib.ssd_route.restype = ctypes.c_int
    return kl


@functools.cache
def load_bwd_kernel() -> build.KernelLibrary:
    """Build (first call) and load the backward kernel library; declares its
    C signature."""
    kl = build.load_library("ssd_bwd", BWD_SOURCES)
    fn = kl.lib.ssd_bwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 18 + [i64] * 8 + [ctypes.POINTER(i64), ptr]
    fn.restype = ctypes.c_int
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
    aligned = fake.address(m) % 16 == 0 and all(st * es % 16 == 0 for st in m.stride()[:2])
    return m if inner and aligned else m.contiguous()


def a_batch(a: torch.Tensor, bs: int) -> int:
    """The batch elements that share a row of ``a``: (H,) is one row for all
    ``bs``; (G_a, H) one row for each b // (B // G_a)."""
    return bs if a.dim() == 1 else bs // a.shape[0]


def launch(x, b, c, dt, a, state, q: int, y, state_out) -> None:
    """Launch the kernel on the current stream into ``y`` / ``state_out``.

    No checks: callers pass CUDA operands that ``check_inputs`` validated,
    x, b and c as ``_kernel_operand`` leaves them, contiguous dt, a ((H,) or
    (G_a, H), ``a_batch``), state and outputs.  Counts the launch and raises
    if CUDA refused it.  Fake operands take the fake route: the call is
    recorded, nothing built or launched.
    """
    bs, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if fake.is_fake(y):
        fake.record("ssd", b=bs, t=t, h=h, g=g, p=p, n=n, q=q, state=state is not None,
                    in_bytes=x.element_size())
        return
    fn = load_kernel().lib.ssd_fwd
    strides = (ctypes.c_int64 * 6)(*(st for m in (x, b, c) for st in m.stride()[:2]))
    err = fn(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        DTYPE_CODES[x.dtype], bs, t, h, g, p, n, q, a_batch(a, bs), strides,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd launch failed with cudaError_t {err}")
    launches.count += 1


def bwd_scratch(bs: int, t: int, h: int, p: int, n: int, device) -> tuple[torch.Tensor, ...]:
    """The backward's float32 scratch: the per-head dB and dC (B, T, H, N),
    each chunk's partial da (B, H, T / Q), and for each chunk of ``Q =
    ref.BWD_Q`` tokens its log-decays' prefix sums (Q), its starting state
    and the gradient of its final state (P N each)."""
    chunks = bs * h * (-(-t // ref.BWD_Q))
    return (torch.empty((bs, t, h, n), dtype=torch.float32, device=device),
            torch.empty((bs, t, h, n), dtype=torch.float32, device=device),
            torch.empty(chunks, dtype=torch.float32, device=device),
            torch.empty(chunks * (ref.BWD_Q + 2 * p * n), dtype=torch.float32, device=device))


def launch_bwd(x, b, c, dt, a, state, dy, dstate, dx, db, dc, ddt, da, scratch,
               dstate_in) -> None:
    """Launch the backward kernels on the current stream: ``dx`` in x's
    type, ``db`` and ``dc`` (B, T, G, N) in b's type, ``ddt`` (B, T, H) and
    ``da`` (a's shape) float32 and, given one, ``dstate_in`` (B, H, P, N)
    float32; ``scratch`` is ``bwd_scratch``'s.

    No checks: callers pass CUDA operands that ``check_inputs`` validated,
    x, b and c as ``_kernel_operand`` leaves them, the rest float32 and
    contiguous; ``state`` and ``dstate`` (the final state's gradient) may be
    None (zeros).  Counts one backward launch and raises if CUDA refused one.
    Fake operands take the fake route, as ``launch``'s.
    """
    bs, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if fake.is_fake(dx):
        fake.record("ssd_bwd", b=bs, t=t, h=h, g=g, p=p, n=n, in_bytes=x.element_size(),
                    a_rows=1 if a.dim() == 1 else a.shape[0], state=state is not None,
                    dstate=dstate is not None, dstate_out=dstate_in is not None)
        return
    fn = load_bwd_kernel().lib.ssd_bwd
    strides = (ctypes.c_int64 * 6)(*(st for m in (x, b, c) for st in m.stride()[:2]))
    opt = lambda m: None if m is None else m.data_ptr()  # noqa: E731
    err = fn(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(), opt(state),
        dy.data_ptr(), opt(dstate), dx.data_ptr(), db.data_ptr(), dc.data_ptr(), ddt.data_ptr(),
        da.data_ptr(), *(m.data_ptr() for m in scratch), opt(dstate_in),
        DTYPE_CODES[x.dtype], bs, t, h, g, p, n, a_batch(a, bs), strides,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd backward launch failed with cudaError_t {err}")
    bwd_launches.count += 1


def _forward(x, b, c, dt, a, state, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state), both float32, by the device of the operands: the
    plain version on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, b, c, dt, a, state=state, chunk=q)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    final = torch.empty((x.shape[0], x.shape[2], x.shape[3], b.shape[3]), dtype=torch.float32,
                        device=x.device)
    launch(*(_kernel_operand(m) for m in (x, b, c)), dt.contiguous(), a.contiguous(),
           None if state is None else state.contiguous(), q, y, final)
    return y, final


def ssd_bwd(x, b, c, dt, a, state, dy, dstate, *, need_dstate: bool = True):
    """(dx, db, dc, ddt, da, dstate) by the device of the operands, each in
    its operand's type (dstate float32, None without ``need_dstate``): the
    plain backward (``ref.ssd_bwd_ref``) on the CPU, the backward kernel on
    CUDA.  ``state`` and ``dstate`` may be None (zeros)."""
    if x.device.type == "cpu":
        grads = ref.ssd_bwd_ref(x, b, c, dt, a, state, dy, dstate)
    else:
        xk, bk, ck = (_kernel_operand(m) for m in (x, b, c))
        dtk, ak, dyk = (m.to(torch.float32).contiguous() for m in (dt, a, dy))
        state, dstate = (None if m is None else m.contiguous() for m in (state, dstate))
        bs, t, h, p = x.shape
        g, n = b.shape[2], b.shape[3]
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        db, dc = (torch.empty(b.shape, dtype=b.dtype, device=x.device) for _ in range(2))
        ddt = torch.empty(dt.shape, dtype=torch.float32, device=x.device)
        da = torch.empty(a.shape, dtype=torch.float32, device=x.device)
        scratch = bwd_scratch(bs, t, h, p, n, x.device)
        dstate_in = (torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
                     if need_dstate else None)
        launch_bwd(xk, bk, ck, dtk, ak, state, dyk, dstate, dx, db, dc, ddt, da, scratch,
                   dstate_in)
        grads = (dx, db, dc, ddt, da, dstate_in)
    dstate_in = grads[5] if need_dstate else None
    return (*(gr.to(m.dtype) for gr, m in zip(grads[:5], (x, b, c, dt, a))), dstate_in)


class SSD(torch.autograd.Function):
    """``ssd`` under autograd: (y, final state) from (x, b, c, dt, a,
    state); a (H,) or (G_a, H) (``a_batch``).  ``vmap`` folds the vmapped
    axis into the batch axis, so a vmapped call is one launch each way."""

    @staticmethod
    def forward(x, b, c, dt, a, state, q):
        return _forward(x, b, c, dt, a, state, q)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, b, c, dt, a, state, _ = inputs
        ctx.save_for_backward(x, b, c, dt, a, state)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, b, c, dt, a, state = ctx.saved_tensors
        if dy is None:  # only the final state reached the loss
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        *grads, dstate = ssd_bwd(x, b, c, dt, a, state, dy, dfinal,
                                 need_dstate=ctx.needs_input_grad[5])
        return (*grads, dstate, None)

    @staticmethod
    def vmap(info, in_dims, x, b, c, dt, a, state, q):
        n = info.batch_size

        def fold(m, dim):
            m = m.expand(n, *m.shape) if dim is None else m.movedim(dim, 0)
            return m.reshape(n * m.shape[1], *m.shape[2:])

        xf, bf, cf, dtf = (fold(m, d) for m, d in zip((x, b, c, dt), in_dims[:4]))
        # one row of a for each peer (and each of its rows, where a has them)
        af = a.expand(n, *a.shape) if in_dims[4] is None else a.movedim(in_dims[4], 0)
        af = af.reshape(-1, af.shape[-1])
        sf = None if state is None else fold(state, in_dims[5])
        y, final = SSD.apply(xf, bf, cf, dtf, af, sf, q)
        return (y.view(n, -1, *y.shape[1:]), final.view(n, -1, *final.shape[1:])), (0, 0)


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
    both float32.  Differentiable in every operand (``SSD``)."""
    fake.check_device(x, "ssd")
    q = check_inputs(x, b, c, dt, a, state, chunk)
    return SSD.apply(x, b, c, dt, a, state, q)

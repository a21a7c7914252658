"""Public API of the chunked WKV6 kernel (the port's ``repro.kernels.rwkv6.ops``).

``wkv6`` computes the RWKV6 (Finch) WKV recurrence over (B, T, H, dk)
operands chunk by chunk, from a carried (B, H, dk, dk) float32 state, and
returns the output and the final state.  It replaces the Pallas TPU kernel
``repro/kernels/rwkv6/rwkv6.py:wkv6_chunked`` and, on the model's prefill
path, the chunk scan of ``repro/models/ssm.py:rwkv6_time_mix_chunked``: with
``state=None`` and ``T % chunk == 0`` its output is the Pallas kernel's, and
it also takes the state in and gives the state out that the chunk scan
carries, and masks a ragged last chunk as the chunk scan's padding does.

Dispatch is by the device of the operands, and only by it:

- CPU tensors take the plain PyTorch version (``ref.wkv6_chunked_ref``);
- CUDA tensors launch the hand-written kernel (``csrc/wkv6.cu``, built for
  sm_90a and loaded with ctypes on first use) or raise — there is no
  fallback;
- any other device raises;
- fake tensors (the dry run's stand-ins, no data) follow the CUDA branch up
  to the launch, which records the call's shapes instead
  (``repro_torch.kernels.fake``): nothing is built or launched.

Every call goes through ``WKV6``, a ``torch.autograd.Function``: its
backward launches the backward kernels (``csrc/wkv6_bwd.cu``: the state at
every 64-token chunk's start and its gradient at every chunk's end by a pass
over 16-token sub-chunks each way, then every chunk in parallel, its
products on the tensor cores, then du summed over the chunks and the batch;
no atomics; ``ref.wkv6_bwd_chunked_ref`` is that decomposition in PyTorch)
on CUDA tensors and the plain backward (``ref.wkv6_bwd_ref``, the token
recurrence) on CPU tensors, with no fallback between the two.  Its ``vmap`` rule folds the vmapped axis (the
port's stacked peers) into the batch axis, a free reshape of the model's
(K, B, T, H, dk) operands, and hands the kernels each peer's u as a row of a
(K, H, dk) u that batch element b reads at b // B: one launch each way
serves every peer.  (Folding the peers into the head axis instead would
take a transposed copy of every operand and gradient.)

The kernel reads r, k and v in the type they come in (bf16 as the served
model computes them, or float32) and writes the output in r's type, rounded
once to nearest even; ``logdecay``, ``u`` and the state are float32 (a bf16
``logdecay``, or r, k and v of mixed types, are cast to float32 first).  One
CTA walks the chunks of a head with the state in registers, the next chunk
arriving by cp.async while one is computed (the note in the CUDA source).

Bound on an H100 SXM (see the note in the CUDA source): at B = 4, T = 1024,
H = 64, dk = 64 one call from a zero state moves 340 MB (0.10 ms at
3.35 TB/s) and does about 5.5 GFLOP (0.08 ms at 67 TFLOP/s float32): it is
bound by bytes; with bf16 r, k, v and output it moves about 205 MB and is
bound by operations.

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
from repro_torch.kernels.rwkv6 import ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "wkv6.cu"]
# wkv6_bwd.cu includes ../../mamba2/csrc/tf32_tiles.cuh (and through it
# tf32_mma.cuh): the build hashes both with it
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"]
HEAD_DIMS = (16, 32, 64)  # the head widths the kernel is instantiated for
MAX_CHUNK = 64  # kMaxChunk in the CUDA source
INPUT_TYPES = (torch.float32, torch.bfloat16)

launches = LaunchCounter()
bwd_launches = LaunchCounter()


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("wkv6", SOURCES)
    fn = kl.lib.wkv6_fwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 8 + [i64] * 6 + [ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return kl


@functools.cache
def load_bwd_kernel() -> build.KernelLibrary:
    """Build (first call) and load the backward kernel library; declares its
    C signature."""
    kl = build.load_library("wkv6_bwd", BWD_SOURCES)
    fn = kl.lib.wkv6_bwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr] * 15 + [i64] * 5 + [ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return kl


def check_inputs(r, k, v, logdecay, u, state, chunk: int) -> int:
    """Validate the operands; returns the chunk length used, ``min(chunk, T)``."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, dk), got shape {tuple(r.shape)}")
    b, t, h, dk = r.shape
    if v.shape[-1] != k.shape[-1]:
        raise ValueError(f"wkv6 assumes dv == dk, got dv={v.shape[-1]}, dk={k.shape[-1]}")
    for name, x in (("k", k), ("v", v), ("logdecay", logdecay)):
        if x.shape != r.shape:
            raise ValueError(f"{name} must have r's shape {tuple(r.shape)}, got {tuple(x.shape)}")
    for name, x in (("r", r), ("k", k), ("v", v), ("logdecay", logdecay), ("u", u)):
        if x.dtype not in INPUT_TYPES:
            raise TypeError(f"wkv6 takes float32 or bfloat16 {name}, got {x.dtype}")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u must be (H, dk) = {(h, dk)}, got {tuple(u.shape)}")
    if state is not None:
        if tuple(state.shape) != (b, h, dk, dk) or state.dtype != torch.float32:
            raise ValueError(f"state must be (B, H, dk, dk) = {(b, h, dk, dk)} float32, "
                             f"got {tuple(state.shape)} {state.dtype}")
    for name, x in (("k", k), ("v", v), ("logdecay", logdecay), ("u", u), ("state", state)):
        if x is not None and x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
    if dk not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel is built for head widths {HEAD_DIMS}, got dk={dk}")
    if t < 1:
        raise ValueError("wkv6 needs T >= 1")
    q = min(int(chunk), t)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    return q


def kernel_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the kernel reads it: ``dtype``, contiguous and 16-byte
    aligned (a misaligned view is copied; anything else is passed as it is)."""
    x = x.to(dtype).contiguous()
    return x.clone() if fake.address(x) % 16 else x


def u_batch(u: torch.Tensor, b: int) -> int:
    """The batch elements that share a row of ``u``: (H, dk) is one row for
    all ``b``; (G, H, dk) one row for each b // (B // G)."""
    return b if u.dim() == 2 else b // u.shape[0]


def launch(r, k, v, logdecay, u, state, q: int, out, state_out) -> None:
    """Launch the kernel on the current stream into ``out`` / ``state_out``.

    No checks: callers pass what ``kernel_operand`` gives for tensors that
    ``check_inputs`` validated: r, k, v and out of one type (float32 or
    bf16), the rest float32; u (H, dk) or (G, H, dk) (``u_batch``).  Counts
    the launch and raises if CUDA refused it.  Fake operands take the fake
    route: the call is recorded, nothing built or launched.
    """
    b, t, h, dk = r.shape
    if fake.is_fake(out):
        fake.record("wkv6", b=b, t=t, h=h, dk=dk, q=q, state=state is not None,
                    in_bytes=r.element_size(), out_bytes=out.element_size())
        return
    fn = load_kernel().lib.wkv6_fwd
    err = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logdecay.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), out.data_ptr(), state_out.data_ptr(),
        b, t, h, dk, q, u_batch(u, b), int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed with cudaError_t {err}")
    launches.count += 1


def bwd_scratch(b: int, t: int, h: int, dk: int, device) -> torch.Tensor:
    """The backward kernels' float32 scratch: for every (b, h) and 64-token
    chunk its starting state S_c and ending gradient G_{c+1} (dk x dk each)
    and its partial of du (dk): B H ceil(T / 64) (2 dk^2 + dk) floats, 128 MB
    at rwkv6-7b's trained shape (B 4, T 1024, H 64, dk 64)."""
    chunks = b * h * -(-t // ref.BWD_Q)
    return torch.empty(chunks * (2 * dk * dk + dk), dtype=torch.float32, device=device)


def launch_bwd(r, k, v, logdecay, u, state, dout, dstate, dr, dk, dv, dld, du, scratch,
               dstate_in) -> None:
    """Launch the backward kernels on the current stream: ``dr``, ``dk``,
    ``dv`` in r's type, ``dld`` float32 (B, T, H, dk), ``du`` float32 of u's
    shape and, given one, ``dstate_in`` (B, H, dk, dk) float32, through the
    float32 ``scratch`` (``bwd_scratch``).

    No checks: callers pass what ``kernel_operand`` gives for operands that
    ``check_inputs`` validated: r, k, v, dout and the three outputs of one
    type, the rest float32 and contiguous; ``state`` and ``dstate`` (the
    final state's gradient) may be None (zeros).  Counts one backward launch
    and raises if CUDA refused one.  Fake operands take the fake route, as
    ``launch``'s.
    """
    b, t, h, dk_ = r.shape
    if fake.is_fake(dr):
        fake.record("wkv6_bwd", b=b, t=t, h=h, dk=dk_, in_bytes=r.element_size(),
                    u_rows=1 if u.dim() == 2 else u.shape[0], state=state is not None,
                    dstate=dstate is not None, dstate_out=dstate_in is not None)
        return
    fn = load_bwd_kernel().lib.wkv6_bwd
    opt = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logdecay.data_ptr(), u.data_ptr(), opt(state),
        dout.data_ptr(), opt(dstate), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dld.data_ptr(), du.data_ptr(), scratch.data_ptr(), opt(dstate_in),
        b, t, h, dk_, u_batch(u, b), int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"wkv6 backward launch failed with cudaError_t {err}")
    bwd_launches.count += 1


def _rkv_dtype(r, k, v) -> torch.dtype:
    """The type the kernels read r, k and v in: theirs when they share one."""
    return r.dtype if r.dtype == k.dtype == v.dtype else torch.float32


def _forward(r, k, v, logdecay, u, state, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out in r's type, final state) by the device of the operands: the
    plain version on the CPU, the kernel on CUDA."""
    if r.device.type == "cpu":
        out, final = ref.wkv6_chunked_ref(r, k, v, logdecay, u, state, chunk=q)
        return out.to(r.dtype), final
    # r, k and v as they come when they share a type; the output in r's
    # type (the kernel rounds it to bf16 itself)
    rkv_dtype = _rkv_dtype(r, k, v)
    rk, kk, vk = (kernel_operand(x, rkv_dtype) for x in (r, k, v))
    lk, uk = (kernel_operand(x, torch.float32) for x in (logdecay, u))
    state = None if state is None else state.contiguous()
    out = torch.empty(r.shape, dtype=rkv_dtype, device=r.device)
    final = torch.empty((r.shape[0], r.shape[2], r.shape[3], r.shape[3]), dtype=torch.float32,
                        device=r.device)
    launch(rk, kk, vk, lk, uk, state, q, out, final)
    return out.to(r.dtype), final


def wkv6_bwd(r, k, v, logdecay, u, state, dout, dstate, *, need_dstate: bool = True):
    """(dr, dk, dv, dlogdecay, du, dstate) by the device of the operands,
    each in its operand's type (dstate float32, None without
    ``need_dstate``): the plain backward (``ref.wkv6_bwd_ref``) on the CPU,
    the backward kernel on CUDA.  ``state`` and ``dstate`` may be None
    (zeros)."""
    if r.device.type == "cpu":
        grads = ref.wkv6_bwd_ref(r, k, v, logdecay, u, state, dout, dstate)
    else:
        rkv_dtype = _rkv_dtype(r, k, v)
        rk, kk, vk, dk_out = (kernel_operand(x, rkv_dtype) for x in (r, k, v, dout))
        lk, uk = (kernel_operand(x, torch.float32) for x in (logdecay, u))
        state, dstate = (None if x is None else x.contiguous() for x in (state, dstate))
        b, t, h, dk = r.shape
        dr, dk_, dv = (torch.empty(r.shape, dtype=rkv_dtype, device=r.device) for _ in range(3))
        dld = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        du = torch.empty(uk.shape, dtype=torch.float32, device=r.device)
        scratch = bwd_scratch(b, t, h, dk, r.device)
        dstate_in = (torch.empty((b, h, dk, dk), dtype=torch.float32, device=r.device)
                     if need_dstate else None)
        launch_bwd(rk, kk, vk, lk, uk, state, dk_out, dstate, dr, dk_, dv, dld, du, scratch,
                   dstate_in)
        grads = (dr, dk_, dv, dld, du, dstate_in)
    dstate_in = grads[5] if need_dstate else None
    return (*(g.to(x.dtype) for g, x in zip(grads[:5], (r, k, v, logdecay, u))), dstate_in)


class WKV6(torch.autograd.Function):
    """``wkv6`` under autograd: (out, final state) from (r, k, v, logdecay,
    u, state); u (H, dk) or (G, H, dk) (``u_batch``).  ``vmap`` folds the
    vmapped axis into the batch axis, so a vmapped call is one launch each
    way."""

    @staticmethod
    def forward(r, k, v, logdecay, u, state, q):
        return _forward(r, k, v, logdecay, u, state, q)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, logdecay, u, state, _ = inputs
        ctx.save_for_backward(r, k, v, logdecay, u, state)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, logdecay, u, state = ctx.saved_tensors
        if dout is None:  # only the final state reached the loss
            dout = torch.zeros_like(r)
        *grads, dstate = wkv6_bwd(r, k, v, logdecay, u, state, dout, dfinal,
                                  need_dstate=ctx.needs_input_grad[5])
        return (*grads, dstate, None)

    @staticmethod
    def vmap(info, in_dims, r, k, v, logdecay, u, state, q):
        n = info.batch_size

        def fold(x, dim):
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        rf, kf, vf, lf = (fold(x, d) for x, d in zip((r, k, v, logdecay), in_dims[:4]))
        # one row of u for each peer (and each of its rows, where u has them)
        u_dim = in_dims[4]
        uf = u.expand(n, *u.shape) if u_dim is None else u.movedim(u_dim, 0)
        uf = uf.reshape(-1, *uf.shape[-2:])
        sf = None if state is None else fold(state, in_dims[5])
        out, final = WKV6.apply(rf, kf, vf, lf, uf, sf, q)
        return (out.view(n, -1, *out.shape[1:]), final.view(n, -1, *final.shape[1:])), (0, 0)


def wkv6(
    r: torch.Tensor,  # (B, T, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,
    logdecay: torch.Tensor,  # (B, T, H, dk), <= 0
    u: torch.Tensor,  # (H, dk)
    *,
    state: torch.Tensor | None = None,  # (B, H, dk, dk) float32; None = zeros
    chunk: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV: returns (out (B, T, H, dk) in r's type, final state
    (B, H, dk, dk) float32).  bf16 operands are computed in float32.
    Differentiable in every operand (``WKV6``)."""
    fake.check_device(r, "wkv6")
    q = check_inputs(r, k, v, logdecay, u, state, chunk)
    return WKV6.apply(r, k, v, logdecay, u, state, q)

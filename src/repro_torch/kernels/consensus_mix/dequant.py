"""Public API of the fused dequantize-and-mix kernel (the port's
``repro.kernels.consensus_mix.dequant``).

``dequant_mix_stacked`` runs one compressed-gossip step plus the affinity-d
update for all K peers of a (K, N) float32 or bf16 flat parameter buffer and
its estimate stack of the same type: it advances
every peer's public estimate by its int8 payload (one float32 scale per peer
and leaf of the row) and mixes the advanced estimates of the neighbors, in one
pass.  It replaces the Pallas TPU kernel
``repro/kernels/consensus_mix/dequant.py:dequant_mix_2d``.  Called with no
payload (``q=None``: top-k, whose estimate the caller advanced with a
scatter), it mixes the estimates as they stand.  ``dequant_mix_push_sum_stacked``
is the kernel's mass mode, one compressed push-sum step (the reference's
``PushSumProtocol.mix_compressed``, which its runtime computes with
einsums: its Pallas kernel has no mass mode): the self term on the true
parameters times the own mass, the neighbors' advanced estimates times
their senders' mass, divided by the new mass, with the (K,) mass
uncompressed.

The reference's tree-level entry points call the same kernel:
``quantize_int8`` (one scale a peer over the whole row, the reference
function's; the runtime keeps one a peer and leaf), ``dequant_mix_flat``
(one peer's row), ``dequant_consensus_mix_stacked`` and
``dequant_consensus_mix_schedule`` (a tree of stacked leaves, a round index
that may be a 0-d tensor on the device).  Their d follows the port's
runtime: the own estimate in it is advanced by the own payload (the
reference's wrapper takes it before the advance; ROADMAP.md section 3).

A bf16 buffer and estimate take the kernel's bf16 storage mode, which
rounds the advance where the reference rounds it, ``bf16(est + bf16(scale *
q))``, and sums in float32 (``ref.advance_estimates``).

Dispatch is by the device of the buffer, and only by it:

- a CPU tensor takes the plain PyTorch version (``ref.dequant_mix_stacked_ref``);
- a CUDA tensor launches the hand-written kernel (``csrc/dequant_mix.cu``,
  built for sm_90a and loaded with ctypes on first use) or raises — there is
  no fallback;
- any other device raises;
- fake tensors (the dry run's stand-ins, no data) follow the CUDA branch up
  to the launch, which records the call's shapes instead
  (``repro_torch.kernels.fake``): nothing is built or launched.

The kernel has two designs, and the rule between them is on the number of
peers K alone (``takes_tile_path``): up to ``TILE_MAX_PEERS`` (128, both
main paths: K = 8 and K = 100) the column-tile design, in which a block
stages a column tile of every sender once and computes the dense
``[W_off; Beta]`` product from shared memory; above it the gather design,
one block per peer reading its neighbors' rows.  Both take the payload and
the no-payload call alike.

Bound on an H100 SXM (see the note in the CUDA source): at K = 100 peers on
the complete graph one qint8 call moves 418 MB (0.125 ms at 3.35 TB/s) and
does 8.0 GFLOP (0.119 ms at 67 TFLOP/s): balanced, barely bound by bytes.

``launches.count`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, fake
from repro_torch.kernels.consensus_mix import ref
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.consensus_mix.ops import (SparseOperands, as_operands, check_mass,
                                                   check_operands, flatten_pytree, select_round,
                                                   unflatten_pytree)

SOURCES = [Path(__file__).resolve().parent / "csrc" / "dequant_mix.cu"]
MAX_LEAVES = 64  # kMaxLeaves in the CUDA source
TILE_MAX_PEERS = 128  # kTileMaxPeers in the CUDA source: its dense table fits shared memory
# dynamic shared memory per block: the default 48 KB less the kernel's static
# arrays (the leaf starts and a flag)
_SMEM_BYTES = 48 * 1024 - 1024

launches = LaunchCounter()


def max_slots(num_leaves: int, with_payload: bool = True) -> int:
    """Most neighbor slots a peer's staged slot row can hold: 3 floats per
    slot, plus one scale per slot and leaf (and the peer's own L scales) when
    there is a payload."""
    per_slot = 3 + (num_leaves if with_payload else 0)
    return (_SMEM_BYTES // 4 - (num_leaves if with_payload else 0)) // per_slot


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("dequant_mix", SOURCES)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for dtype in ("f32", "bf16"):
        for tile in ("", "_tile"):
            fn = getattr(kl.lib, f"dequant_mix{tile}_{dtype}")
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i64,
                           ctypes.c_float, ctypes.c_int, ptr, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
            fn = getattr(kl.lib, f"dequant_mix_push_sum{tile}_{dtype}")
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i64,
                           ctypes.c_float, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
    kl.lib.dequant_mix_tile_columns.argtypes = [i64]
    kl.lib.dequant_mix_tile_columns.restype = i64
    return kl


def takes_tile_path(num_peers: int) -> bool:
    """Whether a launch for ``num_peers`` peers runs the column-tile design
    (K <= ``TILE_MAX_PEERS``); otherwise it runs the gather design."""
    return num_peers <= TILE_MAX_PEERS


def _check(flat, est, q, scale, ops, leaf_offsets, local_steps) -> None:
    offs = tuple(int(o) for o in leaf_offsets)
    num_leaves = len(offs) - 1
    if not 1 <= num_leaves <= MAX_LEAVES:
        raise ValueError(f"need 1 to {MAX_LEAVES} leaves, got {num_leaves}")
    if offs[0] != 0 or any(b <= a for a, b in zip(offs, offs[1:])) or offs[-1] > flat.shape[-1]:
        raise ValueError(f"leaf_offsets {offs} must rise from 0 to at most N={flat.shape[-1]}")
    check_operands(flat, ops, local_steps, max_slots(num_leaves, q is not None), "dequant_mix")
    tensors = {"est": (est, flat.dtype, tuple(flat.shape))}
    if (q is None) != (scale is None):
        raise ValueError("q and scale come together, or both are None")
    if q is not None:
        tensors["q"] = (q, torch.int8, tuple(flat.shape))
        tensors["scale"] = (scale, torch.float32, (flat.shape[0], num_leaves))
    for name, (t, dtype, shape) in tensors.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, the buffer on {flat.device}")
        if not t.is_contiguous():
            raise ValueError(f"dequant_mix needs a contiguous {name}")


def takes_vector_path(leaf_offsets, *tensors: torch.Tensor) -> bool:
    """Whether a launch on these tensors runs the vector path (4 elements a
    load: a float4, or 8 bytes of bf16): N and every leaf start a multiple
    of 4, float32 and bf16 buffers 16-byte aligned, int8 ones 4-byte
    aligned.  Otherwise the kernel runs its scalar path."""
    n = tensors[0].shape[-1]
    aligned = all(
        t.data_ptr() % (4 if t.dtype == torch.int8 else 16) == 0 for t in tensors if t is not None
    )
    return n % 4 == 0 and all(int(o) % 4 == 0 for o in leaf_offsets[:-1]) and aligned


def launch(
    flat: torch.Tensor,
    est: torch.Tensor,
    q: torch.Tensor | None,
    scale: torch.Tensor | None,
    ops: SparseOperands,
    leaf_offsets,
    local_steps: int,
    mixed: torch.Tensor,
    d_bias: torch.Tensor,
    est_out: torch.Tensor | None,
    mass: torch.Tensor | None = None,
    new_mass: torch.Tensor | None = None,
) -> None:
    """Launch the kernel on the current stream into ``mixed`` / ``d_bias`` /
    ``est_out`` (unused without a payload); with ``mass`` (and ``new_mass``
    for y') its mass mode.

    No checks: callers pass what ``dequant_mix_stacked`` (or
    ``dequant_mix_push_sum_stacked``) validated.  Counts the launch and
    raises if CUDA refused it.  Fake operands take the fake route: the call
    is recorded (every slot counted as real), nothing built or launched.
    """
    if fake.is_fake(mixed):
        fake.record("dequant_mix", k=flat.shape[0], n=flat.shape[1], d=ops.nbr_idx.shape[1],
                    elem_bytes=flat.element_size(), mass=mass is not None,
                    leaves=len(leaf_offsets) - 1 if q is not None else 0)
        return
    lib = load_kernel().lib
    tile = "_tile" if takes_tile_path(flat.shape[0]) else ""
    dtype = "bf16" if flat.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"dequant_mix{'' if mass is None else '_push_sum'}{tile}_{dtype}")
    starts = [int(o) for o in leaf_offsets[:-1]] if q is not None else [0]
    vec4 = takes_vector_path(leaf_offsets if q is not None else (0, 0),
                             flat, est, q, mixed, d_bias, est_out)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [
        flat.data_ptr(), est.data_ptr(), ptr(q), ptr(scale),
        (ctypes.c_int64 * len(starts))(*starts), len(starts),
        flat.shape[0], flat.shape[1],
        ops.self_w.data_ptr(), ops.nbr_idx.data_ptr(), ops.nbr_w.data_ptr(),
        ops.beta.data_ptr(), ops.nbr_idx.shape[1], float(local_steps), int(vec4),
    ]
    if mass is not None:
        args.append(mass.data_ptr())
    args += [mixed.data_ptr(), d_bias.data_ptr(), ptr(est_out)]
    if mass is not None:
        args.append(new_mass.data_ptr())
    err = fn(*args, torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant_mix launch failed with cudaError_t {err}")
    launches.count += 1


def dequant_mix_stacked(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — every peer's TRUE parameters
    est: torch.Tensor,  # (K, N) of flat's type — public estimates
    q: torch.Tensor | None,  # (K, N) int8 payloads, or None
    scale: torch.Tensor | None,  # (K, L) float32 per-leaf scales, or None
    ops: SparseOperands,
    leaf_offsets,  # L + 1 leaf boundaries of the row (``ParamLayout.leaf_offsets``)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One compressed gossip step + affinity d for all peers.

    Returns (mixed, d_bias, est_new), each (K, N).  With a payload, est_new is
    a fresh buffer holding ``est + scale * q`` (never ``est`` itself, which
    other peers' blocks still read); without one it is ``est``.
    """
    fake.check_device(flat, "dequant_mix")
    _check(flat, est, q, scale, ops, leaf_offsets, local_steps)
    if flat.device.type == "cpu":
        return ref.dequant_mix_stacked_ref(flat, est, q, scale, tuple(leaf_offsets), *ops,
                                           local_steps)
    mixed = torch.empty_like(flat)
    d_bias = torch.empty_like(flat)
    est_out = torch.empty_like(est) if q is not None else None
    launch(flat, est, q, scale, ops, leaf_offsets, local_steps, mixed, d_bias, est_out)
    return mixed, d_bias, est if est_out is None else est_out


def dequant_mix_push_sum_stacked(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — every peer's TRUE (de-biased) parameters
    est: torch.Tensor,  # (K, N) of flat's type — public estimates
    q: torch.Tensor | None,  # (K, N) int8 payloads, or None
    scale: torch.Tensor | None,  # (K, L) float32 per-leaf scales, or None
    mass: torch.Tensor,  # (K,) float32 push-sum mass y
    ops: SparseOperands,  # column-stochastic push weights
    leaf_offsets,
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One compressed push-sum step + affinity d for all peers, through the
    kernel's mass mode.  Returns (mixed, d_bias, est_new, new_mass); est_new
    as in ``dequant_mix_stacked``."""
    fake.check_device(flat, "dequant_mix")
    _check(flat, est, q, scale, ops, leaf_offsets, local_steps)
    check_mass(flat, mass, "dequant_mix")
    if flat.device.type == "cpu":
        return ref.dequant_mix_push_sum_stacked_ref(flat, est, q, scale, tuple(leaf_offsets),
                                                    mass, *ops, local_steps)
    mixed = torch.empty_like(flat)
    d_bias = torch.empty_like(flat)
    est_out = torch.empty_like(est) if q is not None else None
    new_mass = torch.empty_like(mass)
    launch(flat, est, q, scale, ops, leaf_offsets, local_steps, mixed, d_bias, est_out,
           mass, new_mass)
    return mixed, d_bias, est if est_out is None else est_out, new_mass


def quantize_int8(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 payload of a (K, N) stack: (q int8, scale (K,)
    float32), one scale a peer over the whole row (the reference's
    ``dequant.quantize_int8``)."""
    f = flat.to(torch.float32)
    scale = f.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(f / safe[:, None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequant_mix_flat(
    x: torch.Tensor,  # (N,) float32 — own TRUE parameters
    self_est: torch.Tensor,  # (N,) float32 — own public estimate
    nbrs_est: torch.Tensor,  # (D, N) float32 — neighbor public estimates
    nbrs_q: torch.Tensor,  # (D, N) int8 — difference payloads
    nbr_scale,  # (D,) float32 payload scales
    w_self,
    w_nbr,  # (D,)
    beta,  # (D,)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One peer's fused dequantize-and-mix step (the reference's
    ``dequant.dequant_mix_flat``): the kernel on the (D + 1, N) stack of the
    row and its neighbors (``ref.dequant_one_peer_stack``: the own row with
    no payload, so d is ``(Beta v - self_est) / T``), row 0 returned."""
    stack, est, q, scale, ops = ref.dequant_one_peer_stack(x, self_est, nbrs_est, nbrs_q,
                                                           nbr_scale, w_self, w_nbr, beta)
    mixed, d, _ = dequant_mix_stacked(stack, est, q, scale, SparseOperands(*ops),
                                      (0, x.shape[0]), local_steps)
    return mixed[0], d[0]


def dequant_consensus_mix_stacked(
    stacked,  # tree of (K, ...) leaves — each peer's own TRUE parameters
    est: torch.Tensor,  # (K, N) float32 — public estimates before this step's advance
    q: torch.Tensor,  # (K, N) int8 — the senders' payloads (quantize_int8)
    scale: torch.Tensor,  # (K,) float32 payload scales
    self_w, nbr_idx, nbr_w, beta,  # one round's sparse operands
    local_steps: int,
):
    """One compressed gossip step + affinity d on a tree of stacked leaves,
    every neighbor view its estimate advanced by its payload (the
    reference's ``dequant.dequant_consensus_mix_stacked``), through
    ``dequant_mix_stacked`` with the row as one leaf.  Returns (mixed,
    d_bias) trees; the caller advances its estimates, ``est + q * scale``."""
    flat, _ = flatten_pytree(stacked)
    flat = flat.to(torch.float32)
    dev = flat.device
    ops = as_operands(self_w, nbr_idx, nbr_w, beta, dev)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev).reshape(-1, 1).contiguous()
    mixed, d, _ = dequant_mix_stacked(flat, est, q, scale, ops, (0, flat.shape[1]), local_steps)
    return unflatten_pytree(stacked, mixed), unflatten_pytree(stacked, d)


def dequant_consensus_mix_schedule(
    stacked,
    est: torch.Tensor,  # (K, N) float32
    q: torch.Tensor,  # (K, N) int8
    scale: torch.Tensor,  # (K,)
    self_w_s: torch.Tensor,  # (R, K)
    nbr_idx_s: torch.Tensor,  # (R, K, D)
    nbr_w_s: torch.Tensor,  # (R, K, D)
    beta_s: torch.Tensor,  # (R, K, D)
    round_idx: int | torch.Tensor,
    local_steps: int,
):
    """Round ``round_idx % R`` of a stacked sparse schedule
    (``ops.sparse_from_schedule``), selected on the device for a tensor
    index: ``dequant_consensus_mix_stacked`` on that round's operands."""
    ops = select_round(as_operands(self_w_s, nbr_idx_s, nbr_w_s, beta_s, est.device), round_idx)
    return dequant_consensus_mix_stacked(stacked, est, q, scale, *ops, local_steps)

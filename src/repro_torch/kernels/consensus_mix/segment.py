"""Public API of the segment-sum consensus kernel (the port's
``repro.kernels.consensus_mix.segment``).

``segment_mix_schedule`` runs one gossip step plus the affinity-d update for
all K peers of a (K, N) float32 or bf16 flat parameter buffer (bf16: the
kernel's bf16 storage mode, float32 sums, on both routes) over round
``round_idx % R`` of a stacked sparse schedule (``ops.upload_schedule``:
(R, K) and (R, K, D) operands, uploaded once per run); the kernel selects
the round by offsetting its operand pointers.  ``segment_mix_stacked`` is the
same step over one round's (K,) / (K, D) operands.  They replace the Pallas
TPU kernel ``repro/kernels/consensus_mix/segment.py:segment_mix_2d``, reached
there through the wrappers of the same names.  ``segment_mix_push_sum_schedule``
and ``_stacked`` are the kernel's mass mode, one push-sum step (the
reference's ``segment_mix_push_sum_stacked``, which appends a lane of ones):
the sender's mass scales each slot's weight inside the kernel, the (K,) mass
is the same for every round.  It is the hierarchical
runtime's "segment" mix (``core.p2p.consensus_phase_hier``), the large-K form:
the wrapper takes any degree bound D that a ``SparseSchedule`` produces (the
kernel stages the slots in chunks), where ``ops.consensus_mix_stacked`` stops
at 4,096 slots.

Dispatch is by the device of the buffer, and only by it:

- a CPU tensor takes the plain PyTorch version (``ref.segment_mix_stacked_ref``);
- a CUDA tensor launches the hand-written kernel (``csrc/segment_mix.cu``,
  built for sm_90a and loaded with ctypes on first use) or raises — there is
  no fallback;
- any other device raises;
- fake tensors (the dry run's stand-ins, no data) follow the CUDA branch up
  to the launch, which records the call's shapes instead
  (``repro_torch.kernels.fake``): nothing is built or launched.

The kernel library chooses between two routes by (K, D) alone
(``kernel_route`` is the same rule, and the library exports its own as
``segment_mix_route``): from ``TILE_MIN_PEERS`` to ``TILE_MAX_PEERS`` peers
with ``K / TILE_MIN_DENSITY`` to ``TILE_MAX_SLOTS`` slots the column tile of
``csrc/tile_mix.cuh`` (shared with ``consensus_mix`` and ``dequant_mix``),
which reads each sender's column tile once and computes the dense
``[W_off; Beta]`` product from shared memory; everywhere else a persistent
gather, whose blocks walk runs of consecutive peers over wide column spans.

Bound on an H100 SXM (see the note in the CUDA source): at K = 4096 peers on
a ring (D = 2) at the 2NN's width one call must move 9.8 GB (2.9 ms at
3.35 TB/s) and is bound by bytes; at K = 100 on the complete graph it is
bound by float32 FMA throughput, as ``consensus_mix`` is.

``segment_mix_slots`` and ``segment_mix_push_sum_slots`` are the slot
form, the "segment" mix of a process of the hierarchical runtime over
several processes (``core.p2p.make_sharded_round_fn`` with
``peers_per_device`` > 1): the process holds its (p, N) block and the
(p, D, N) neighbor rows ``core.consensus.ring_gather_slots`` streamed to it,
not the (K, N) buffer, so the kernel reads slot s of peer k from
``slots[k, s]`` (and in the mass mode the sender's mass from a (p, D)
table), on the round's (p,) / (p, D) rows of the block.  It takes the
gather route with that route's arithmetic, so a row equals the one-process
call's gather row bit for bit; float32 only (the hierarchical runtime
refuses the registry's bf16 models).  Its plain version is
``ref.segment_mix_slots_ref``.

``launches.count`` counts kernel launches (never plain-version calls), the
slot form's too.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, fake
from repro_torch.kernels.consensus_mix import ref
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.consensus_mix.ops import (
    TILE_MAX_PEERS,
    TILE_MIN_PEERS,
    SparseOperands,
    check_mass,
    check_operands,
    select_round,
)

SOURCES = [Path(__file__).resolve().parent / "csrc" / "segment_mix.cu"]
MAX_SLOTS = 2**31 - 1  # the kernel counts slots in an int
ROUTES = ("gather", "tile")  # segment_mix_route's codes
# kTileMinDensity and kTileMaxSlots in the CUDA source (its kTileMinPeers
# and kTileMaxPeers are ops' TILE_MIN_PEERS and TILE_MAX_PEERS, the same
# tile's edges): below K / TILE_MIN_DENSITY slots (sparse rows, where the
# tile's dense product is mostly zeros) the gather is the faster route
# (PERF.md section 6); TILE_MAX_SLOTS bounds the table scatter's work
TILE_MIN_DENSITY = 3
TILE_MAX_SLOTS = 4096

launches = LaunchCounter()


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("segment_mix", SOURCES)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for dtype in ("f32", "bf16"):
        fn = getattr(kl.lib, f"segment_mix_{dtype}")
        fn.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_float,
                       ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(kl.lib, f"segment_mix_push_sum_{dtype}")
        fn.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_float,
                       ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    kl.lib.segment_mix_slots_f32.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr, i64,
                                             ctypes.c_float, ptr, ptr, ptr]
    kl.lib.segment_mix_slots_f32.restype = ctypes.c_int
    kl.lib.segment_mix_slots_push_sum_f32.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr, i64,
                                                      ctypes.c_float, ptr, ptr, ptr, ptr, ptr,
                                                      ptr]
    kl.lib.segment_mix_slots_push_sum_f32.restype = ctypes.c_int
    kl.lib.segment_mix_route.argtypes = [i64, i64]
    kl.lib.segment_mix_route.restype = i64
    return kl


def kernel_route(k: int, d: int) -> str:
    """The route a CUDA call of ``k`` peers and ``d`` slots takes:
    ``"tile"`` from ``TILE_MIN_PEERS`` to ``TILE_MAX_PEERS`` peers with
    ``k / TILE_MIN_DENSITY`` to ``TILE_MAX_SLOTS`` slots, ``"gather"``
    otherwise; the CUDA source's ``route`` is the same rule."""
    tile = (TILE_MIN_PEERS <= k <= TILE_MAX_PEERS and TILE_MIN_DENSITY * d >= k
            and d <= TILE_MAX_SLOTS)
    return "tile" if tile else "gather"


def check_schedule(flat: torch.Tensor, ops_s: SparseOperands, local_steps: int) -> None:
    """Validate a (K, N) float32 or bf16 buffer and stacked (R, K) / (R, K, D)
    operands: shapes, types, device and contiguity of every round, and for
    CPU tensors the index range (see ``ops.check_operands``)."""
    if ops_s.self_w.dim() != 2 or any(t.dim() != 3 for t in ops_s[1:]):
        raise ValueError("stacked operands must be (R, K) and (R, K, D)")
    if len({t.shape[0] for t in ops_s}) != 1:
        raise ValueError(f"operands disagree on the period R: {[tuple(t.shape) for t in ops_s]}")
    if not all(t.is_contiguous() for t in ops_s):
        raise ValueError("segment_mix needs contiguous tensors")
    check_operands(flat, select_round(ops_s, 0), local_steps, MAX_SLOTS, what="segment_mix")
    k = flat.shape[0]
    if flat.device.type == "cpu" and bool(((ops_s.nbr_idx < 0) | (ops_s.nbr_idx >= k)).any()):
        raise ValueError(f"nbr_idx entries must index peers in [0, {k})")


def launch(
    flat: torch.Tensor,
    round_idx: int,
    ops_s: SparseOperands,
    local_steps: int,
    mixed: torch.Tensor,
    d_bias: torch.Tensor,
    mass: torch.Tensor | None = None,
    new_mass: torch.Tensor | None = None,
) -> None:
    """Launch the kernel on the current stream into ``mixed`` / ``d_bias``;
    with ``mass`` (and ``new_mass`` for y') its mass mode.

    No checks: callers pass what ``check_schedule`` (and ``check_mass``)
    validated.  Counts the launch and raises if CUDA refused it.  Fake
    operands take the fake route: the call is recorded (every slot counted
    as real), nothing built or launched.
    """
    if fake.is_fake(mixed):
        fake.record("segment_mix", k=flat.shape[0], n=flat.shape[1], d=ops_s.nbr_idx.shape[2],
                    elem_bytes=flat.element_size(), mass=mass is not None)
        return
    lib = load_kernel().lib
    args = [flat.data_ptr(), flat.shape[0], flat.shape[1],
            ops_s.self_w.data_ptr(), ops_s.nbr_idx.data_ptr(), ops_s.nbr_w.data_ptr(),
            ops_s.beta.data_ptr(), ops_s.self_w.shape[0], int(round_idx),
            ops_s.nbr_idx.shape[2], float(local_steps)]
    dtype = "bf16" if flat.dtype == torch.bfloat16 else "f32"
    if mass is None:
        fn = getattr(lib, f"segment_mix_{dtype}")
        args += [mixed.data_ptr(), d_bias.data_ptr()]
    else:
        fn = getattr(lib, f"segment_mix_push_sum_{dtype}")
        args += [mass.data_ptr(), mixed.data_ptr(), d_bias.data_ptr(), new_mass.data_ptr()]
    err = fn(*args, torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_mix launch failed with cudaError_t {err}")
    launches.count += 1


def segment_mix_schedule(
    flat: torch.Tensor,  # (K, N) float32 or bf16
    round_idx: int,
    ops_s: SparseOperands,  # stacked (R, K) / (R, K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gossip step + affinity d for all peers over round ``round_idx % R``:
    returns (mixed, d_bias), both (K, N) in fresh buffers."""
    fake.check_device(flat, "segment_mix")
    check_schedule(flat, ops_s, local_steps)
    if flat.device.type == "cpu":
        return ref.segment_mix_stacked_ref(flat, *select_round(ops_s, round_idx), local_steps)
    mixed = torch.empty_like(flat)
    d_bias = torch.empty_like(flat)
    launch(flat, round_idx, ops_s, local_steps, mixed, d_bias)
    return mixed, d_bias


def segment_mix_stacked(
    flat: torch.Tensor,  # (K, N) float32
    ops: SparseOperands,  # one round's (K,) / (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``segment_mix_schedule`` over one round's operands."""
    return segment_mix_schedule(flat, 0, SparseOperands(*(t[None] for t in ops)), local_steps)


def segment_mix_push_sum_schedule(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — the de-biased parameters
    mass: torch.Tensor,  # (K,) float32 push-sum mass y
    round_idx: int,
    ops_s: SparseOperands,  # stacked (R, K) / (R, K, D) push weights
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One push-sum step + affinity d for all peers over round
    ``round_idx % R``, through the kernel's mass mode: returns (mixed,
    d_bias, new_mass) in fresh buffers."""
    fake.check_device(flat, "segment_mix")
    check_schedule(flat, ops_s, local_steps)
    check_mass(flat, mass, "segment_mix")
    if flat.device.type == "cpu":
        return ref.segment_mix_push_sum_stacked_ref(
            flat, mass, *select_round(ops_s, round_idx), local_steps)
    mixed = torch.empty_like(flat)
    d_bias = torch.empty_like(flat)
    new_mass = torch.empty_like(mass)
    launch(flat, round_idx, ops_s, local_steps, mixed, d_bias, mass, new_mass)
    return mixed, d_bias, new_mass


def segment_mix_push_sum_stacked(
    flat: torch.Tensor,  # (K, N) float32
    mass: torch.Tensor,  # (K,) float32
    ops: SparseOperands,  # one round's (K,) / (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``segment_mix_push_sum_schedule`` over one round's operands."""
    return segment_mix_push_sum_schedule(flat, mass, 0, SparseOperands(*(t[None] for t in ops)),
                                         local_steps)


def check_slots(block: torch.Tensor, slots: torch.Tensor, ops: SparseOperands,
                local_steps: int) -> None:
    """Validate the slot form's operands: a (p, N) float32 block, its
    (p, D, N) float32 slots and the block's (p,) / (p, D) float32 weights,
    contiguous, on one device."""
    if block.dim() != 2 or block.dtype != torch.float32:
        raise TypeError(f"the slot form takes a (p, N) float32 block, got "
                        f"{tuple(block.shape)} {block.dtype}")
    p, n = block.shape
    d = ops.nbr_w.shape[-1] if ops.nbr_w.dim() == 2 else -1
    if tuple(slots.shape) != (p, d, n) or slots.dtype != torch.float32:
        raise ValueError(f"slots must be ({p}, {d}, {n}) float32, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
    want = {"self_w": (p,), "nbr_w": (p, d), "beta": (p, d)}
    for name, shape in want.items():
        t = getattr(ops, name)
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    if any(t.device != block.device for t in (slots, ops.self_w, ops.nbr_w, ops.beta)):
        raise ValueError(f"the slot form's operands must be on {block.device}")
    if not all(t.is_contiguous() for t in (block, slots, ops.self_w, ops.nbr_w, ops.beta)):
        raise ValueError("segment_mix needs contiguous tensors")
    if not 1 <= d or p * d > MAX_SLOTS:
        raise ValueError(f"the slot form takes 1 <= D and p x D <= {MAX_SLOTS}, got p={p} D={d}")
    if int(local_steps) < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")


def launch_slots(block: torch.Tensor, slots: torch.Tensor, ops: SparseOperands,
                 local_steps: int, mixed: torch.Tensor, d_bias: torch.Tensor,
                 mass: torch.Tensor | None = None, slot_mass: torch.Tensor | None = None,
                 new_mass: torch.Tensor | None = None) -> None:
    """Launch the slot form on the current stream into ``mixed`` / ``d_bias``;
    with ``mass`` (and ``slot_mass``, ``new_mass``) its mass mode.  No
    checks (``check_slots`` validated); counts the launch and raises if CUDA
    refused it; fake operands take the fake route, as ``launch``'s."""
    if fake.is_fake(mixed):
        fake.record("segment_mix", form="slots", p=block.shape[0], n=block.shape[1],
                    d=slots.shape[1], mass=mass is not None)
        return
    lib = load_kernel().lib
    args = [block.data_ptr(), slots.data_ptr(), block.shape[0], block.shape[1],
            ops.self_w.data_ptr(), ops.nbr_w.data_ptr(), ops.beta.data_ptr(),
            slots.shape[1], float(local_steps)]
    if mass is None:
        fn = lib.segment_mix_slots_f32
        args += [mixed.data_ptr(), d_bias.data_ptr()]
    else:
        fn = lib.segment_mix_slots_push_sum_f32
        args += [mass.data_ptr(), slot_mass.data_ptr(), mixed.data_ptr(), d_bias.data_ptr(),
                 new_mass.data_ptr()]
    err = fn(*args, torch.cuda.current_stream(block.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_mix slot form launch failed with cudaError_t {err}")
    launches.count += 1


def segment_mix_slots(
    block: torch.Tensor,  # (p, N) float32: the process's peers
    slots: torch.Tensor,  # (p, D, N) float32: their neighbor rows, slot by slot
    ops: SparseOperands,  # the block's rows of one round: (p,) / (p, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gossip step + affinity d for the block's peers from their
    gathered slots: returns (mixed, d_bias), both (p, N) in fresh buffers
    (``nbr_idx`` of ``ops`` is not read: the slots hold its rows)."""
    fake.check_device(block, "segment_mix")
    check_slots(block, slots, ops, local_steps)
    if block.device.type == "cpu":
        return ref.segment_mix_slots_ref(block, slots, ops.self_w, ops.nbr_w, ops.beta,
                                         local_steps)
    mixed = torch.empty_like(block)
    d_bias = torch.empty_like(block)
    launch_slots(block, slots, ops, local_steps, mixed, d_bias)
    return mixed, d_bias


def segment_mix_push_sum_slots(
    block: torch.Tensor,  # (p, N) float32 — the de-biased parameters
    slots: torch.Tensor,  # (p, D, N) float32
    mass: torch.Tensor,  # (p,) float32: the block's masses
    slot_mass: torch.Tensor,  # (p, D) float32: each slot's sender mass
    ops: SparseOperands,  # the block's rows of one round's push weights
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot form's mass mode, one push-sum step + affinity d for the
    block's peers: returns (mixed, d_bias, new_mass) in fresh buffers."""
    fake.check_device(block, "segment_mix")
    check_slots(block, slots, ops, local_steps)
    p, d = ops.nbr_w.shape
    for name, t, shape in (("mass", mass, (p,)), ("slot_mass", slot_mass, (p, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"segment_mix: {name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != block.device or not t.is_contiguous():
            raise ValueError(f"segment_mix: {name} must be contiguous on {block.device}")
    if block.device.type == "cpu":
        return ref.segment_mix_push_sum_slots_ref(block, slots, mass, slot_mass, ops.self_w,
                                                  ops.nbr_w, ops.beta, local_steps)
    mixed = torch.empty_like(block)
    d_bias = torch.empty_like(block)
    new_mass = torch.empty_like(mass)
    launch_slots(block, slots, ops, local_steps, mixed, d_bias, mass, slot_mass, new_mass)
    return mixed, d_bias, new_mass

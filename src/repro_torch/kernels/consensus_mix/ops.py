"""Public API of the fused consensus kernel (the port's
``repro.kernels.consensus_mix.ops``).

``consensus_mix_stacked`` runs one gossip step plus the affinity-d update for
all K peers of a (K, N) float32 flat parameter buffer, from padded sparse
operands uploaded once per run by ``upload_schedule``.  It replaces the
Pallas TPU kernel ``repro/kernels/consensus_mix/consensus_mix.py:
consensus_mix_2d`` (reached there through ``ops.consensus_mix_stacked``).
``consensus_mix_push_sum_stacked`` is the same kernel's mass mode, one
push-sum step (reached there through ``ops.consensus_mix_push_sum_stacked``
and ``_schedule``, which append a lane of ones to the parameters): the
kernel reads the (K,) mass and scales each weight by its sender's mass
where it reads the weight, so nothing is appended or copied.
``consensus_mix_snapshot_stacked`` and
``consensus_mix_push_sum_snapshot_stacked`` are the kernel's snapshot mode,
one step of bounded-staleness consensus (the reference's
``_consensus_phase_async``, which mixes through ``mix_compressed`` with the
published snapshots in place of the estimates): every neighbor term reads
the sender's last published snapshot, the self term and d's own term the
live parameters, with the round's age-decayed weights.
``consensus_mix_dense`` and ``consensus_mix_push_sum_dense`` take one
round's dense (K, K) W and Beta computed on the device (adaptive partner
selection) and run the same kernel on ``dense_operands``: the static
candidate set of every j != k, the weights gathered from the matrices.

The reference's tree-level entry points call the same kernel:
``consensus_mix_schedule`` and ``consensus_mix_push_sum_schedule`` take a
tree of stacked (K, ...) leaves (``flatten_pytree``: the reference's leaf
order), the stacked operands of ``sparse_from_schedule`` and a round index,
which may be a 0-d tensor on the device (the round is then selected there,
with no read back, so a call can be captured in a CUDA graph);
``consensus_mix_flat`` takes one peer's row and its neighbors' rows.

Every mode also takes a bfloat16 buffer (a bf16 model's parameters): the
kernel's bf16 storage mode reads x (and the published snapshots P) as bf16,
sums in float32 and writes mixed and d as bf16, as the reference mixes a
bf16 leaf in float32 and casts back; the weights, push-sum's mass and y'
stay float32.

Dispatch is by the device of the buffer, and only by it:

- a CPU tensor takes the plain PyTorch version (``ref.py``);
- a CUDA tensor launches the hand-written kernel (``csrc/consensus_mix.cu``
  with ``csrc/tile_mix.cuh``, built for sm_90a and loaded with ctypes on
  first use) or raises — there is no fallback;
- any other device raises;
- fake tensors (the dry run's stand-ins, no data) follow the CUDA branch up
  to the launch, which records the call's shapes instead
  (``repro_torch.kernels.fake``): nothing is built or launched.

The kernel has two designs, and the rule between them is on the number of
peers K alone (``takes_tile_path``): from ``TILE_MIN_PEERS`` up to
``TILE_MAX_PEERS`` (128) the column-tile design, in which a block stages a
column tile of every peer once and computes the dense ``[W_off; Beta]``
product from shared memory (``csrc/tile_mix.cuh``, shared with
``dequant_mix``); elsewhere the gather design, one block per peer reading its
neighbors' rows.

Bound on an H100 (see the note in the CUDA source): at K = 100 peers on the
complete graph one call reads 80 MB and writes 160 MB but does 7.9 GFLOP of
float32 multiply-adds, so float32 FMA throughput (67 TFLOP/s, 119 us) bounds
it, not memory (72 us).

Every mode takes a row range (``rows`` = (row0, count)): the launch
computes only those peers' rows, reading every row of the buffer, and they
equal the full launch's rows bit for bit.  The sharded runtime
(``core.p2p.make_sharded_round_fn``), where a process holds its own row and
its in-neighbors' rows in a (K, N) buffer, computes its own row this way.

``launches.count`` counts kernel launches (never plain-version calls), so a
run can show that its consensus went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core import graph as graph_lib
from repro_torch.kernels import build, fake
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.consensus_mix import ref

SOURCES = [Path(__file__).resolve().parent / "csrc" / "consensus_mix.cu"]
# the gather design stages one peer's slot row in the default 48 KB of shared
# memory
MAX_SLOTS = 48 * 1024 // 12
TILE_MAX_PEERS = 128  # kTileMaxPeers in the CUDA source: its dense table fits shared memory
# below this the gather design is the faster one: at K = 2 (the noniid_k2
# main path), 8 and 12 on the 2NN's row (tools/kernel_ab.py; PERF.md
# section 6, NVIDIA H100 80GB HBM3, 700 W)
TILE_MIN_PEERS = 16


launches = LaunchCounter()


class SparseOperands(NamedTuple):
    """Padded sparse mixing operands on the compute device: one round's, or
    a whole schedule's stacked along a leading period axis R (``(R, K)`` and
    ``(R, K, D)``, from ``upload_schedule``).  The reference names this type
    ``protocols.SparseRoundOps``; the port's ``protocols`` exports it under
    that name too."""

    self_w: torch.Tensor  # (K,) float32 — diagonal of W
    nbr_idx: torch.Tensor  # (K, D) int32 — neighbor indices, padded with own index
    nbr_w: torch.Tensor  # (K, D) float32 — off-diagonal W weights (0 at padding)
    beta: torch.Tensor  # (K, D) float32 — affinity weights (0 at padding)


def upload_schedule(
    sparse: graph_lib.SparseSchedule, device: torch.device | str = "cpu"
) -> SparseOperands:
    """A sparse schedule's stacked (R, K[, D]) operands on ``device``: the
    float64 weights cast to float32 once, here.  ``SparseSchedule`` has
    checked the index range, once, on the host: the kernels' wrappers do not
    read a CUDA tensor back on every launch."""
    arrays = (sparse.self_w.astype(np.float32), sparse.nbr_idx,
              sparse.nbr_w.astype(np.float32), sparse.beta.astype(np.float32))
    return SparseOperands(*(torch.as_tensor(a, device=device) for a in arrays))


def select_round(stacked: SparseOperands, round_idx: int | torch.Tensor) -> SparseOperands:
    """Round ``round_idx % R`` of stacked operands.  An int gives views,
    nothing copied; a 0-d tensor selects on the operands' device (one small
    gather each, no read back to the host)."""
    period = stacked.self_w.shape[0]
    if isinstance(round_idx, torch.Tensor):
        r = torch.remainder(round_idx.to(stacked.self_w.device, torch.int64), period).reshape(1)
        return SparseOperands(*(t.index_select(0, r)[0] for t in stacked))
    return SparseOperands(*(t[int(round_idx) % period] for t in stacked))


def as_operands(self_w, nbr_idx, nbr_w, beta, device: torch.device) -> SparseOperands:
    """Operands in the kernels' types on ``device``: float32 weights, int32
    indices, contiguous (tensors already so are taken as they are; arrays
    are copied, since a view of a jax array is read-only)."""
    def cast(t, dtype):
        t = t if isinstance(t, torch.Tensor) else np.array(t)
        return torch.as_tensor(t, dtype=dtype, device=device).contiguous()

    return SparseOperands(cast(self_w, torch.float32), cast(nbr_idx, torch.int32),
                          cast(nbr_w, torch.float32), cast(beta, torch.float32))


def sparse_from_schedule(
    w_stack: np.ndarray, beta_stack: np.ndarray, *, device: torch.device | str = "cpu"
) -> SparseOperands:
    """Stacked sparse form of a (R, K, K) W/Beta schedule on ``device``:
    (self_w (R, K), nbr_idx (R, K, D), nbr_w (R, K, D), beta (R, K, D)), D
    the widest row of any round, so one kernel shape serves the schedule.
    A row's slots are its nonzero off-diagonal W and Beta entries
    (``SparseSchedule.from_dense``; the reference takes W's alone, and so
    drops an affinity weight on an edge of mixing weight 0)."""
    sparse = graph_lib.SparseSchedule.from_dense(np.asarray(w_stack), np.asarray(beta_stack))
    return upload_schedule(sparse, device)


def flatten_pytree(tree) -> tuple[torch.Tensor, list]:
    """A tree of stacked (K, ...) leaves -> ((K, N) buffer, [(shape, dtype)]
    of each leaf), the leaves in the reference's order
    (``repro_torch.pytree``) and their common type by promotion."""
    leaves = pytree.leaves(tree)
    flat = torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=1)
    return flat, [(tuple(leaf.shape), leaf.dtype) for leaf in leaves]


def unflatten_pytree(tree_like, flat: torch.Tensor):
    """A (K, N) buffer -> ``tree_like``'s structure, each leaf in its shape
    and type (the inverse of ``flatten_pytree``)."""
    starts, off = {}, 0
    for path, leaf in pytree.leaves_with_path(tree_like):
        starts[path] = off
        off += int(np.prod(leaf.shape[1:]))

    def leaf_of(path, leaf):
        size = int(np.prod(leaf.shape[1:]))
        return flat[:, starts[path]:starts[path] + size].reshape(leaf.shape).to(leaf.dtype)

    return pytree.map_with_path(leaf_of, tree_like)


def sparse_from_matrices(
    w_mat: np.ndarray,
    beta_mat: np.ndarray,
    *,
    dmax: int | None = None,
    device: torch.device | str = "cpu",
) -> SparseOperands:
    """(self_w, nbr_idx, nbr_w, beta) from one round's dense float64 W and
    Beta, uploaded to ``device`` once.  A row's slots are the union of its
    nonzero off-diagonal W and Beta entries (``SparseSchedule.from_dense``),
    so an affinity weight on an edge of mixing weight 0 is kept; padded
    slots carry zero weights and add nothing to either output."""
    sparse = graph_lib.SparseSchedule.from_dense(w_mat[None], beta_mat[None], degree_bound=dmax)
    return select_round(upload_schedule(sparse, device), 0)


@functools.cache
def load_kernel() -> build.KernelLibrary:
    """Build (first call) and load the kernel library; declares its C signature."""
    kl = build.load_library("consensus_mix", SOURCES)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn in (kl.lib.consensus_mix_f32, kl.lib.consensus_mix_tile_f32,
               kl.lib.consensus_mix_bf16, kl.lib.consensus_mix_tile_bf16):
        fn.argtypes = [ptr, i64, i64, i64, i64, ptr, ptr, ptr, ptr, i64, ctypes.c_float, ptr,
                       ptr, ptr]
        fn.restype = ctypes.c_int
    for dtype in ("f32", "bf16"):
        for tile in ("", "_tile"):
            fn = getattr(kl.lib, f"consensus_mix_push_sum{tile}_{dtype}")
            fn.argtypes = [ptr, i64, i64, i64, i64, ptr, ptr, ptr, ptr, i64, ctypes.c_float,
                           ptr, ptr, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
            # the snapshot mode: the published buffer after x
            fn = getattr(kl.lib, f"consensus_mix_snapshot{tile}_{dtype}")
            fn.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr, ptr, ptr, ptr, i64,
                           ctypes.c_float, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
            fn = getattr(kl.lib, f"consensus_mix_push_sum_snapshot{tile}_{dtype}")
            fn.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr, ptr, ptr, ptr, i64,
                           ctypes.c_float, ptr, ptr, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
    return kl


def takes_tile_path(num_peers: int) -> bool:
    """Whether a launch for ``num_peers`` peers runs the column-tile design
    (``TILE_MIN_PEERS`` <= K <= ``TILE_MAX_PEERS``); otherwise it runs the
    gather design."""
    return TILE_MIN_PEERS <= num_peers <= TILE_MAX_PEERS


STORAGE_DTYPES = (torch.float32, torch.bfloat16)  # the buffer types every mode takes


def vector_width(flat: torch.Tensor) -> int:
    """Elements a thread loads at once on the gather design's vector path,
    16 bytes (4 float32, 8 bf16), where the row length is a multiple of it
    and the buffer 16-byte aligned, else 1 (the scalar path): the CUDA
    source's rule, which a bf16 row of 4 mod 8 elements fails although a
    float32 row of as many bytes passes."""
    width = 16 // flat.element_size()
    return width if flat.shape[-1] % width == 0 and flat.data_ptr() % 16 == 0 else 1


def check_operands(flat: torch.Tensor, ops: SparseOperands, local_steps: int,
                   max_slots: int, what: str = "consensus_mix") -> None:
    """Validate a (K, N) float32 or bf16 buffer (``STORAGE_DTYPES``) and its
    float32 sparse operands for a kernel that stages up to ``max_slots``
    slots per peer.

    The range of ``nbr_idx`` is checked here for CPU tensors only: for CUDA
    tensors ``SparseSchedule`` checked it once, from numpy, and reading it
    back here would synchronize the host with the device on every launch.
    """
    if flat.dim() != 2:
        raise ValueError(f"flat must be (K, N), got shape {tuple(flat.shape)}")
    if flat.dtype not in STORAGE_DTYPES:
        raise TypeError(f"{what} takes {', '.join(map(str, STORAGE_DTYPES))}, got {flat.dtype}")
    k = flat.shape[0]
    d = ops.nbr_idx.shape[-1]
    want = {"self_w": ((k,), torch.float32), "nbr_idx": ((k, d), torch.int32),
            "nbr_w": ((k, d), torch.float32), "beta": ((k, d), torch.float32)}
    for name, (shape, dtype) in want.items():
        t = getattr(ops, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, the buffer on {flat.device}")
    if not all(t.is_contiguous() for t in (flat, *ops)):
        raise ValueError(f"{what} needs contiguous tensors")
    if not 1 <= d <= max_slots:
        raise ValueError(f"neighbor slots D={d} outside [1, {max_slots}]")
    if int(local_steps) < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")
    if flat.device.type == "cpu" and bool(((ops.nbr_idx < 0) | (ops.nbr_idx >= k)).any()):
        raise ValueError(f"nbr_idx entries must index peers in [0, {k})")


def check_mass(flat: torch.Tensor, mass: torch.Tensor, what: str) -> None:
    """Validate a push-sum mass: (K,) float32, contiguous, on the buffer's
    device.  Its values are not read: that would synchronize the host with
    the device on every launch."""
    k = flat.shape[0]
    if tuple(mass.shape) != (k,) or mass.dtype != torch.float32:
        raise ValueError(f"{what}: mass must be ({k},) float32, got "
                         f"{tuple(mass.shape)} {mass.dtype}")
    if mass.device != flat.device or not mass.is_contiguous():
        raise ValueError(f"{what}: mass must be contiguous on {flat.device}")


def check_published(flat: torch.Tensor, published: torch.Tensor) -> None:
    """Validate a published snapshot buffer: the live buffer's shape and
    dtype, contiguous, on its device."""
    if (published.shape != flat.shape or published.dtype != flat.dtype
            or published.device != flat.device or not published.is_contiguous()):
        raise ValueError(
            f"published must be a contiguous {tuple(flat.shape)} {flat.dtype} buffer on "
            f"{flat.device}, got {tuple(published.shape)} {published.dtype} on "
            f"{published.device}")


def check_rows(flat: torch.Tensor, rows: tuple[int, int] | None) -> int:
    """Validate a row range (row0, count) of a (K, N) buffer, 0 <= row0 and
    row0 + count <= K with count >= 1; returns the output rows (K for None)."""
    if rows is None:
        return flat.shape[0]
    row0, count = (int(v) for v in rows)
    if count < 1 or row0 < 0 or row0 + count > flat.shape[0]:
        raise ValueError(f"rows {tuple(rows)} is not a range of the {flat.shape[0]} peers")
    return count


def launch(
    flat: torch.Tensor,
    ops: SparseOperands,
    local_steps: int,
    mixed: torch.Tensor,
    d_bias: torch.Tensor,
    mass: torch.Tensor | None = None,
    new_mass: torch.Tensor | None = None,
    published: torch.Tensor | None = None,
    rows: tuple[int, int] | None = None,
) -> None:
    """Launch the kernel on the current stream into ``mixed`` / ``d_bias``;
    with ``mass`` (and ``new_mass`` for y') its mass mode; with
    ``published`` its snapshot mode (in either weight mode); with ``rows``
    = (row0, count) the rows of peers row0 .. row0 + count - 1 only, into
    (count, N) outputs (the full launch's rows, bit for bit).

    No checks: callers pass what ``check_operands`` (and ``check_mass``,
    ``check_published``, ``check_rows``) validated.  Counts the launch and
    raises if CUDA refused it.  Fake operands take the fake route: the call
    is recorded (every slot counted as real: its weights cannot be read),
    nothing built or launched.
    """
    if fake.is_fake(mixed):
        fake.record("consensus_mix", k=flat.shape[0], n=flat.shape[1],
                    d=ops.nbr_idx.shape[1], elem_bytes=flat.element_size(),
                    mass=mass is not None, snapshot=published is not None,
                    rows=None if rows is None else rows[1])
        return
    lib = load_kernel().lib
    tile = takes_tile_path(flat.shape[0])
    snap = published is not None
    row0, count = (0, flat.shape[0]) if rows is None else rows
    args = [flat.data_ptr(), *((published.data_ptr(),) if snap else ()),
            flat.shape[0], flat.shape[1], row0, count,
            ops.self_w.data_ptr(), ops.nbr_idx.data_ptr(), ops.nbr_w.data_ptr(),
            ops.beta.data_ptr(), ops.nbr_idx.shape[1], float(local_steps)]
    mode = "_push_sum" if mass is not None else ""
    dtype = "bf16" if flat.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"consensus_mix{mode}{'_snapshot' if snap else ''}"
                      f"{'_tile' if tile else ''}_{dtype}")
    if mass is None:
        args += [mixed.data_ptr(), d_bias.data_ptr()]
    else:
        args += [mass.data_ptr(), mixed.data_ptr(), d_bias.data_ptr(), new_mass.data_ptr()]
    err = fn(*args, torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"consensus_mix launch failed with cudaError_t {err}")
    launches.count += 1


def _outputs(flat: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh (count, N) buffers of the buffer's type for mixed and d."""
    shape = (count, flat.shape[1])
    return (flat.new_empty(shape), flat.new_empty(shape))


def consensus_mix_stacked(
    flat: torch.Tensor,  # (K, N) float32 or bf16
    ops: SparseOperands,
    local_steps: int,
    *,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gossip step + affinity d for all peers: returns (mixed, d_bias),
    both (K, N) in fresh buffers of the buffer's type (float32 or bf16).
    ``rows`` = (row0, count): the rows of peers row0 .. row0 + count - 1
    only, (count, N) each, equal to the full call's rows bit for bit; every
    row of ``flat`` is read (a process holding its own row and its
    in-neighbors' rows computes its own)."""
    fake.check_device(flat, "consensus_mix")
    check_operands(flat, ops, local_steps, MAX_SLOTS)
    count = check_rows(flat, rows)
    if flat.device.type == "cpu":
        return ref.consensus_mix_stacked_ref(flat, *ops, local_steps, rows=rows)
    mixed, d_bias = _outputs(flat, count)
    launch(flat, ops, local_steps, mixed, d_bias, rows=rows)
    return mixed, d_bias


def consensus_mix_push_sum_stacked(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — the de-biased parameters
    mass: torch.Tensor,  # (K,) float32 push-sum mass y
    ops: SparseOperands,  # column-stochastic push weights
    local_steps: int,
    *,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One push-sum step + affinity d for all peers, through the kernel's
    mass mode: returns (mixed, d_bias, new_mass), the de-biased
    ``A (y x) / y'``, d from the raw x, and y' = A y, in fresh buffers.
    ``rows`` as in ``consensus_mix_stacked`` (y' of those rows, (count,))."""
    fake.check_device(flat, "consensus_mix")
    check_operands(flat, ops, local_steps, MAX_SLOTS)
    check_mass(flat, mass, "consensus_mix")
    count = check_rows(flat, rows)
    if flat.device.type == "cpu":
        return ref.consensus_mix_push_sum_stacked_ref(flat, mass, *ops, local_steps, rows=rows)
    mixed, d_bias = _outputs(flat, count)
    new_mass = mass.new_empty(count)
    launch(flat, ops, local_steps, mixed, d_bias, mass, new_mass, rows=rows)
    return mixed, d_bias, new_mass


@functools.cache
def complete_candidates(k: int, device: torch.device) -> torch.Tensor:
    """The static (K, K-1) int32 candidate set of the dense-dynamic path,
    every peer j != k in row-major order, built once per (K, device): every
    edge is a slot, and the round's weights decide which contribute."""
    if k < 2:
        raise ValueError("dense-dynamic consensus needs at least two peers")
    idx = np.arange(k)
    cand = np.stack([np.concatenate([idx[:i], idx[i + 1:]]) for i in range(k)])
    return torch.as_tensor(cand.astype(np.int32), device=device)


def dense_operands(w_mat: torch.Tensor, beta_mat: torch.Tensor,
                   nbr_idx: torch.Tensor) -> SparseOperands:
    """The kernel's operands of one round's dense (K, K) W and Beta computed
    on the device (an adaptive round's matching): the diagonal as ``self_w``,
    and ``nbr_w`` / ``beta`` gathered at the candidates ``nbr_idx``
    (``complete_candidates``).  Weights of unselected edges are zero;
    nothing is read back to the host."""
    cols = nbr_idx.long()
    return SparseOperands(w_mat.diagonal().to(torch.float32).contiguous(), nbr_idx,
                          w_mat.gather(1, cols).to(torch.float32),
                          beta_mat.gather(1, cols).to(torch.float32))


def consensus_mix_dense(
    flat: torch.Tensor,  # (K, N) float32 or bf16
    w_mat: torch.Tensor,  # (K, K) row-stochastic mixing matrix, computed on the device
    beta_mat: torch.Tensor,  # (K, K) affinity matrix
    local_steps: int,
    *,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gossip step + affinity d from dense (K, K) matrices computed on
    the device (the reference's ``ops.consensus_mix_dense``): the kernel on
    ``dense_operands``, every j != k a slot.  Returns (mixed, d_bias), of
    ``rows`` only where given (``consensus_mix_stacked``)."""
    ops = dense_operands(w_mat, beta_mat, complete_candidates(w_mat.shape[0], w_mat.device))
    return consensus_mix_stacked(flat, ops, local_steps, rows=rows)


def consensus_mix_push_sum_dense(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — the de-biased parameters
    mass: torch.Tensor,  # (K,) float32 push-sum mass y
    w_mat: torch.Tensor,  # (K, K) column-stochastic push matrix, computed on the device
    beta_mat: torch.Tensor,  # (K, K) affinity matrix
    local_steps: int,
    *,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One push-sum step + affinity d from dense (K, K) matrices computed on
    the device (the reference's ``ops.consensus_mix_push_sum_dense``): the
    kernel's mass mode on ``dense_operands``.  Returns (mixed, d_bias,
    new_mass), of ``rows`` only where given."""
    ops = dense_operands(w_mat, beta_mat, complete_candidates(w_mat.shape[0], w_mat.device))
    return consensus_mix_push_sum_stacked(flat, mass, ops, local_steps, rows=rows)


def consensus_mix_snapshot_stacked(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — the live parameters
    published: torch.Tensor,  # (K, N) of flat's type — each sender's last published snapshot
    ops: SparseOperands,  # the round's age-decayed weights
    local_steps: int,
    *,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One bounded-staleness gossip step + affinity d, through the kernel's
    snapshot mode: ``mixed = self_w x + sum_s nbr_w P[j]`` and
    ``d = (sum_s beta P[j] - x) / T`` (0 for a zero beta row), in fresh
    buffers; ``rows`` as in ``consensus_mix_stacked`` (only those rows of x
    are read, every row of P)."""
    fake.check_device(flat, "consensus_mix")
    check_operands(flat, ops, local_steps, MAX_SLOTS)
    check_published(flat, published)
    count = check_rows(flat, rows)
    if flat.device.type == "cpu":
        return ref.consensus_mix_stacked_ref(flat, *ops, local_steps, published=published,
                                             rows=rows)
    mixed, d_bias = _outputs(flat, count)
    launch(flat, ops, local_steps, mixed, d_bias, published=published, rows=rows)
    return mixed, d_bias


def consensus_mix_push_sum_snapshot_stacked(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — the live de-biased parameters
    published: torch.Tensor,  # (K, N) of flat's type — each sender's last published snapshot
    mass: torch.Tensor,  # (K,) float32 push-sum mass y
    ops: SparseOperands,  # the round's age-decayed column-stochastic weights
    local_steps: int,
    *,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bounded-staleness push-sum step + affinity d, through the kernel's
    snapshot mode in its mass mode: y' = A y, ``mixed = (self_w y x +
    sum_s nbr_w y_j P[j]) / y'``, d as in ``consensus_mix_snapshot_stacked``
    (beta not scaled by mass).  Returns (mixed, d_bias, new_mass) in fresh
    buffers, of ``rows`` only where given (``consensus_mix_stacked``)."""
    fake.check_device(flat, "consensus_mix")
    check_operands(flat, ops, local_steps, MAX_SLOTS)
    check_mass(flat, mass, "consensus_mix")
    check_published(flat, published)
    count = check_rows(flat, rows)
    if flat.device.type == "cpu":
        return ref.consensus_mix_push_sum_stacked_ref(flat, mass, *ops, local_steps,
                                                      published=published, rows=rows)
    mixed, d_bias = _outputs(flat, count)
    new_mass = mass.new_empty(count)
    launch(flat, ops, local_steps, mixed, d_bias, mass, new_mass, published=published,
           rows=rows)
    return mixed, d_bias, new_mass


def consensus_mix_flat(
    x: torch.Tensor,  # (N,)
    nbrs: torch.Tensor,  # (D, N)
    w_self,
    w_nbr,  # (D,)
    beta,  # (D,)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One peer's gossip step + affinity d (the reference's
    ``ops.consensus_mix_flat``): the kernel on the (D + 1, N) stack of the
    row and its neighbors (``ref.one_peer_stack``), row 0 returned."""
    stack, ops = ref.one_peer_stack(x, nbrs, w_self, w_nbr, beta)
    mixed, d = consensus_mix_stacked(stack, SparseOperands(*ops), local_steps)
    return mixed[0], d[0]


def consensus_mix_schedule(
    stacked,  # tree of (K, ...) leaves
    round_idx: int | torch.Tensor,
    self_w_s: torch.Tensor,  # (R, K)
    nbr_idx_s: torch.Tensor,  # (R, K, D)
    nbr_w_s: torch.Tensor,  # (R, K, D)
    beta_s: torch.Tensor,  # (R, K, D)
    local_steps: int,
):
    """Round ``round_idx % R`` of a stacked sparse schedule
    (``sparse_from_schedule``) on a tree of stacked leaves: one gossip step
    + affinity d through ``consensus_mix_stacked``.  Returns (mixed, d_bias)
    trees, each leaf in its own type."""
    flat, _ = flatten_pytree(stacked)
    ops = select_round(as_operands(self_w_s, nbr_idx_s, nbr_w_s, beta_s, flat.device), round_idx)
    mixed, d = consensus_mix_stacked(flat, ops, local_steps)
    return unflatten_pytree(stacked, mixed), unflatten_pytree(stacked, d)


def consensus_mix_push_sum_schedule(
    stacked,  # tree of (K, ...) leaves: the de-biased parameters
    mass: torch.Tensor,  # (K,) push-sum mass y
    round_idx: int | torch.Tensor,
    self_w_s: torch.Tensor,  # (R, K)
    nbr_idx_s: torch.Tensor,  # (R, K, D)
    nbr_w_s: torch.Tensor,  # (R, K, D)
    beta_s: torch.Tensor,  # (R, K, D)
    local_steps: int,
):
    """Round ``round_idx % R`` of a (possibly directed) stacked schedule on
    a tree of stacked leaves: one push-sum step + affinity d through
    ``consensus_mix_push_sum_stacked`` (float32).  Returns (mixed tree,
    d_bias tree, new mass)."""
    flat, _ = flatten_pytree(stacked)
    flat = flat.to(torch.float32)
    ops = select_round(as_operands(self_w_s, nbr_idx_s, nbr_w_s, beta_s, flat.device), round_idx)
    mass = torch.as_tensor(mass, dtype=torch.float32, device=flat.device).contiguous()
    mixed, d, new_mass = consensus_mix_push_sum_stacked(flat, mass, ops, local_steps)
    return unflatten_pytree(stacked, mixed), unflatten_pytree(stacked, d), new_mass

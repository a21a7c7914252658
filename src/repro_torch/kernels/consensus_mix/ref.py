"""Plain PyTorch versions of the fused gossip + affinity updates, stacked form:
``consensus_mix_stacked_ref`` (below), for a compressed wire
``dequant_mix_stacked_ref``, and for the hierarchical runtime's segment mode
``segment_mix_stacked_ref`` with its dense oracle ``segment_mix_ref`` (at the
end).  Each has a push-sum form (``*_push_sum_*``, after its gossip form).

For every peer k of a (K, N) flat parameter buffer, with D padded neighbor
slots ``nbr_idx[k]``:

    mixed_k = self_w[k] * x_k + sum_d nbr_w[k, d] * x[nbr_idx[k, d]]   (Eq. 4)
    d_k     = (sum_d beta[k, d] * x[nbr_idx[k, d]] - x_k) / T          (Sec. IV-A)

with d_k = 0 when sum_d beta[k, d] == 0 (an isolated peer).  Accumulation in
float32, outputs cast back.  This is the CPU path of
``ops.consensus_mix_stacked`` and the oracle the CUDA kernel is held to.
It loops over the D slots, so it never holds more than one gathered (K, N)
neighbor block at a time.  With ``published`` (the snapshot mode of
bounded-staleness consensus) every neighbor term reads
``published[nbr_idx[k, d]]`` in place of ``x[nbr_idx[k, d]]``; x_k, in the
self term and in d, stays the live row.

With ``rows`` = (row0, count) the consensus_mix forms compute the rows of
peers row0 .. row0 + count - 1 only, reading every row of x (and P): each
row elementwise as the full call computes it, so bit for bit its rows.

``consensus_mix_ref`` and ``dequant_mix_ref`` are the reference's one-peer
oracles by name and call: one row x and its (D, N) neighbor rows, computed
as row 0 of the stacked plain versions on ``one_peer_stack``.
"""
from __future__ import annotations

import torch

from repro_torch.core import consensus as consensus_lib


def consensus_mix_stacked_ref(
    flat: torch.Tensor,  # (K, N)
    self_w: torch.Tensor,  # (K,)
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
    *,
    published: torch.Tensor | None = None,  # (K, N): the senders' snapshots
    rows: tuple[int, int] | None = None,  # (row0, count): those peers' rows only
) -> tuple[torch.Tensor, torch.Tensor]:
    own = row_slice(rows, flat.shape[0])
    mixed, d = _mix_f32(flat, self_w[own], nbr_idx[own], nbr_w[own], beta[own], local_steps,
                        published=published, own=own)
    return mixed.to(flat.dtype), d.to(flat.dtype)


def row_slice(rows: tuple[int, int] | None, k: int) -> slice:
    """The peers of a row range (row0, count), or all ``k`` for None."""
    return slice(0, k) if rows is None else slice(rows[0], rows[0] + rows[1])


def _mix_f32(flat, self_w, nbr_idx, nbr_w, beta, local_steps: int, *, published=None,
             own: slice):
    """``consensus_mix_stacked_ref``'s (mixed, d) before the cast back,
    float32, for the peers ``own`` (the weights given are theirs)."""
    src = flat.to(torch.float32)
    xf = src[own]
    if published is not None:
        src = published.to(torch.float32)
    nbr_idx = nbr_idx.long()
    nbr_w = nbr_w.to(torch.float32)
    beta = beta.to(torch.float32)
    mixed = self_w.to(torch.float32)[:, None] * xf
    nbr_sum = torch.zeros_like(xf)
    for slot in range(nbr_idx.shape[1]):
        nbr = src[nbr_idx[:, slot]]  # (K, N): every peer's slot-th neighbor
        mixed = mixed + nbr_w[:, slot, None] * nbr
        nbr_sum = nbr_sum + beta[:, slot, None] * nbr
    has_nbrs = beta.sum(dim=1) > 0.0
    d = torch.where(has_nbrs[:, None], (nbr_sum - xf) / local_steps, torch.zeros_like(xf))
    return mixed, d


def one_peer_stack(x, nbrs, w_self, w_nbr, beta):
    """One peer's row ``x`` (N,) and its neighbors' rows ``nbrs`` (D, N) as a
    (D + 1, N) stack with its operands: row 0 is the peer, mixing slot s
    from row s + 1 with ``w_nbr[s]`` and ``beta[s]``; rows 1..D keep no
    weight (own-index padding, zero beta: d = 0).  Returns (stack,
    (self_w, nbr_idx, nbr_w, beta)), the weights float32 and the index
    int32, on x's device."""
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    d = nbrs.shape[0]
    stack = torch.cat([x[None], nbrs.to(x.dtype)]).contiguous()
    rows = torch.arange(d + 1, dtype=torch.int32, device=dev)
    nbr_idx = rows[:, None].repeat(1, d)
    nbr_idx[0] = rows[1:]
    pad = torch.zeros((d, d), **f32)
    self_w = torch.cat([torch.as_tensor(w_self, **f32).reshape(1), torch.zeros(d, **f32)])
    weights = [torch.cat([torch.as_tensor(w, **f32).reshape(1, d), pad]) for w in (w_nbr, beta)]
    return stack, (self_w, nbr_idx, *weights)


def consensus_mix_ref(x, nbrs, w_self, w_nbr, beta, local_steps: int):
    """x: (N,); nbrs: (D, N); w_self: scalar; w_nbr, beta: (D,).  Returns
    (mixed, d) of one peer, each (N,) in x's type (the reference's
    ``ref.consensus_mix_ref``)."""
    stack, ops = one_peer_stack(x, nbrs, w_self, w_nbr, beta)
    mixed, d = consensus_mix_stacked_ref(stack, *ops, local_steps)
    return mixed[0], d[0]


def dequant_one_peer_stack(x, self_est, nbrs_est, nbrs_q, nbr_scale, w_self, w_nbr, beta):
    """``one_peer_stack`` of a compressed step: (true rows, estimates, int8
    payloads, (D + 1, 1) scales, operands).  The peer's own row carries no
    payload (q = 0, scale 0), so its estimate stays ``self_est``, as the
    reference's one-peer form has it."""
    stack, ops = one_peer_stack(x, nbrs_est, w_self, w_nbr, beta)
    est = torch.cat([self_est[None], nbrs_est]).to(torch.float32).contiguous()
    q = torch.cat([torch.zeros_like(nbrs_q[:1]), nbrs_q]).contiguous()
    scale = torch.cat([torch.zeros(1, dtype=torch.float32, device=x.device),
                       torch.as_tensor(nbr_scale, dtype=torch.float32, device=x.device)])
    return stack, est, q, scale[:, None].contiguous(), ops


def dequant_mix_ref(x, self_est, nbrs_est, nbrs_q, nbr_scale, w_self, w_nbr, beta,
                    local_steps: int):
    """One peer's compressed step (the reference's ``ref.dequant_mix_ref``):
    x, self_est (N,) float32; nbrs_est (D, N) float32; nbrs_q (D, N) int8;
    nbr_scale, w_nbr, beta (D,); every neighbor advanced to ``est + q *
    scale``, d on estimate differences ``(Beta v - self_est) / T``.
    Returns (mixed, d), each (N,)."""
    stack, est, q, scale, ops = dequant_one_peer_stack(x, self_est, nbrs_est, nbrs_q,
                                                       nbr_scale, w_self, w_nbr, beta)
    mixed, d, _ = dequant_mix_stacked_ref(stack, est, q, scale, (0, x.shape[0]), *ops,
                                          local_steps)
    return mixed[0], d[0]


def push_sum_weights(
    mass: torch.Tensor,  # (K,)
    self_w: torch.Tensor,  # (K,)
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    own: slice = slice(None),  # the peers whose weights are wanted
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Push-sum's weights, each scaled by its sender's mass, and the new mass:

        self_w_y[k]   = self_w[k] y[k]
        nbr_w_y[k, s] = nbr_w[k, s] y[nbr_idx[k, s]]
        y'[k]         = self_w_y[k] + sum_s nbr_w_y[k, s]   (slot order)

    all float32.  With them the gossip forms compute push-sum's numerator."""
    y = mass.to(torch.float32)
    nbr_idx = nbr_idx[own]
    self_w_y = self_w[own].to(torch.float32) * y[own]
    nbr_w_y = nbr_w[own].to(torch.float32) * y[nbr_idx.long()]
    y_new = self_w_y
    for slot in range(nbr_idx.shape[1]):
        y_new = y_new + nbr_w_y[:, slot]
    return self_w_y, nbr_w_y, y_new


def consensus_mix_push_sum_stacked_ref(
    flat: torch.Tensor,  # (K, N) de-biased parameters
    mass: torch.Tensor,  # (K,) push-sum mass y
    self_w: torch.Tensor,  # (K,) diagonal of the column-stochastic A
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D) off-diagonal A weights
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
    *,
    published: torch.Tensor | None = None,  # (K, N): the senders' snapshots
    rows: tuple[int, int] | None = None,  # (row0, count): those peers' rows only
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One push-sum step + affinity d (the reference's
    ``PushSumProtocol.mix`` plus the d update):

        y'    = A y
        mixed = A (y * x) / y'
        d     = where(has_nbrs, (Beta x - x) / T, 0)   (raw x, Beta not scaled)

    Returns (mixed, d, y').  With ``published`` the neighbor terms read the
    snapshots P (the reference's ``mix_compressed`` with P for the
    estimates): ``mixed = (diag(A) y x + A_off y P) / y'``, ``d = (Beta P -
    x) / T``.  A bf16 buffer is rounded once, after the division, as the
    kernel rounds it.  This is the CPU path of
    ``ops.consensus_mix_push_sum_stacked`` (and of its snapshot mode) and the
    oracle its kernel modes are held to."""
    own = row_slice(rows, flat.shape[0])
    self_w_y, nbr_w_y, y_new = push_sum_weights(mass, self_w, nbr_idx, nbr_w, own)
    num, d = _mix_f32(flat, self_w_y, nbr_idx[own], nbr_w_y, beta[own], local_steps,
                      published=published, own=own)
    return (num / y_new[:, None]).to(flat.dtype), d.to(flat.dtype), y_new


def leaf_scale_columns(
    scale: torch.Tensor, leaf_offsets: tuple[int, ...], n: int
) -> torch.Tensor:
    """(K, L) per-leaf scales -> (K, n), each column carrying its leaf's scale;
    columns past the last leaf (the row's zero padding) take the last leaf's."""
    starts = torch.as_tensor(leaf_offsets[:-1], dtype=torch.int64, device=scale.device)
    cols = torch.arange(n, dtype=torch.int64, device=scale.device)
    leaf = torch.searchsorted(starts, cols, right=True) - 1
    return scale.to(torch.float32)[:, leaf]


def advance_estimates(est: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      leaf_offsets: tuple[int, ...]) -> torch.Tensor:
    """The estimates advanced by their payloads, ``est + q * scale`` in
    est's type, rounded where the reference's compressed path rounds them
    (``ef_compress_leaf``, ``QInt8.decompress``): float32, a multiply then
    an add; bf16, the payload's value formed in float32 and cast to bf16,
    then added to the bf16 estimate, ``bf16(est + bf16(q * scale))``."""
    value = q.to(torch.float32) * leaf_scale_columns(scale, leaf_offsets, est.shape[1])
    return est + value.to(est.dtype)


def dequant_mix_stacked_ref(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — every peer's TRUE parameters
    est: torch.Tensor,  # (K, N) of flat's type — public estimates before this step's advance
    q: torch.Tensor | None,  # (K, N) int8 payloads, or None (estimates already advanced)
    scale: torch.Tensor | None,  # (K, L) float32 per-leaf payload scales
    leaf_offsets: tuple[int, ...],  # L + 1 leaf boundaries of the row
    self_w: torch.Tensor,  # (K,)
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused dequantize-and-mix step, stacked form (the
    counterpart of the reference's ``ref.dequant_mix_ref``).

    Builds what the kernel exists to avoid, the advanced estimate of every
    peer ``v = est + q * scale`` (a multiply, then an add), then mixes:

        mixed_k = self_w[k] * x_k + sum_d nbr_w[k, d] * v[nbr_idx[k, d]]
        d_k     = (sum_d beta[k, d] * v[nbr_idx[k, d]] - v_k) / T

    with d_k = 0 when sum_d beta[k, d] == 0.  Returns (mixed, d, v); with no
    payload v is ``est`` itself.  In bf16 v is rounded as
    ``advance_estimates`` rounds it, the sums are float32 and mixed and d are
    rounded once.  This is the CPU path of ``dequant.dequant_mix_stacked``
    and the oracle the CUDA kernel is held to.
    """
    mixed, d, adv = _dequant_mix_f32(flat, est, q, scale, leaf_offsets, self_w, nbr_idx, nbr_w,
                                     beta, local_steps)
    return mixed.to(flat.dtype), d.to(flat.dtype), adv


def _dequant_mix_f32(flat, est, q, scale, leaf_offsets, self_w, nbr_idx, nbr_w, beta,
                     local_steps: int):
    """``dequant_mix_stacked_ref``'s (mixed, d) before the cast back
    (float32), and v in est's type."""
    xf = flat.to(torch.float32)
    adv = est if q is None else advance_estimates(est, q, scale, leaf_offsets)
    advf = adv.to(torch.float32)
    nbr_idx = nbr_idx.long()
    nbr_w = nbr_w.to(torch.float32)
    beta = beta.to(torch.float32)
    mixed = self_w.to(torch.float32)[:, None] * xf
    nbr_sum = torch.zeros_like(xf)
    for slot in range(nbr_idx.shape[1]):
        nbr = advf[nbr_idx[:, slot]]  # (K, N): every peer's slot-th advanced neighbor
        mixed = mixed + nbr_w[:, slot, None] * nbr
        nbr_sum = nbr_sum + beta[:, slot, None] * nbr
    has_nbrs = beta.sum(dim=1) > 0.0
    d = torch.where(has_nbrs[:, None], (nbr_sum - advf) / local_steps, torch.zeros_like(xf))
    return mixed, d, adv


def dequant_mix_push_sum_stacked_ref(
    flat: torch.Tensor,  # (K, N) float32 or bf16 — every peer's TRUE (de-biased) parameters
    est: torch.Tensor,  # (K, N) of flat's type — public estimates before this step's advance
    q: torch.Tensor | None,  # (K, N) int8 payloads, or None
    scale: torch.Tensor | None,  # (K, L) float32 per-leaf payload scales
    leaf_offsets: tuple[int, ...],
    mass: torch.Tensor,  # (K,) push-sum mass y, uncompressed
    self_w: torch.Tensor,  # (K,) diagonal of the column-stochastic A
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One compressed push-sum step (the reference's
    ``PushSumProtocol.mix_compressed`` plus d from the advanced estimates):

        y'    = A y
        mixed = (diag(A) (y * x) + A_off (y * v)) / y'
        d     = where(has_nbrs, (Beta v - v) / T, 0)

    with v the advanced estimates.  Returns (mixed, d, v, y').  This is the
    CPU path of ``dequant.dequant_mix_push_sum_stacked`` and the oracle its
    kernel mode is held to."""
    self_w_y, nbr_w_y, y_new = push_sum_weights(mass, self_w, nbr_idx, nbr_w)
    num, d, adv = _dequant_mix_f32(flat, est, q, scale, leaf_offsets, self_w_y, nbr_idx,
                                   nbr_w_y, beta, local_steps)
    return (num / y_new[:, None]).to(flat.dtype), d.to(flat.dtype), adv, y_new


def dense_mix_operator(
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
) -> torch.Tensor:
    """The (2K, K) float32 ``[W_off; Beta]`` of a padded slot table: row k of
    the top half holds ``nbr_w[k, s]`` at column ``nbr_idx[k, s]`` (W without
    its diagonal), the bottom half ``beta[k, s]``; padding slots (own index,
    weight 0) add 0.  The table the ``dequant_mix`` column-tile kernel builds
    in shared memory, and with the advanced estimates v the product
    ``[W_off; Beta] v`` of its sums."""
    k, d = nbr_idx.shape
    rows = torch.arange(k, device=nbr_idx.device).repeat_interleave(d)
    cols = nbr_idx.long().reshape(-1)
    out = torch.zeros(2 * k, k, dtype=torch.float32, device=nbr_idx.device)
    out.index_put_((rows, cols), nbr_w.to(torch.float32).reshape(-1), accumulate=True)
    out.index_put_((rows + k, cols), beta.to(torch.float32).reshape(-1), accumulate=True)
    return out


def segment_mix_ref(
    flat: torch.Tensor,  # (K, N)
    w_mat: torch.Tensor,  # (K, K)
    beta_mat: torch.Tensor,  # (K, K)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense oracle of the segment kernel (the reference's
    ``ref.segment_mix_ref``): the (K, K) products the kernel exists to avoid,

        mixed = W x,   d = (Beta x - x) / T,   d_k = 0 where sum_j Beta[k, j] == 0.
    """
    xf = flat.to(torch.float32)
    w = w_mat.to(torch.float32)
    b = beta_mat.to(torch.float32)
    has_nbrs = b.sum(dim=1) > 0.0
    d = torch.where(has_nbrs[:, None], (b @ xf - xf) / local_steps, torch.zeros_like(xf))
    return (w @ xf).to(flat.dtype), d.to(flat.dtype)


def segment_mix_push_sum_ref(
    flat: torch.Tensor,  # (K, N) de-biased parameters
    mass: torch.Tensor,  # (K,)
    a_mat: torch.Tensor,  # (K, K) column-stochastic
    beta_mat: torch.Tensor,  # (K, K)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense oracle of the segment kernel's push-sum mode (the reference's
    ``ref.segment_mix_push_sum_ref``): y' = A y, mixed = A (y * x) / y',
    d = (Beta x - x) / T, 0 where a Beta row sums to 0.  Returns
    (mixed, d, y')."""
    xf = flat.to(torch.float32)
    a = a_mat.to(torch.float32)
    y = mass.to(torch.float32)
    y_new = a @ y
    mixed = (a @ (xf * y[:, None])) / y_new[:, None]
    _, d = segment_mix_ref(flat, a_mat, beta_mat, local_steps)
    return mixed.to(flat.dtype), d, y_new


def segment_mix_stacked_ref(
    flat: torch.Tensor,  # (K, N)
    self_w: torch.Tensor,  # (K,)
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``segment_mix`` kernel: the one-device slot
    forms of ``core.consensus`` in float32 (a (K, D, N) gather, then slot
    sums in slot order, the mix from ``self_w * x``, as the Pallas grid's
    innermost slot axis accumulates), and ``d = (slot_sum(beta) - x) / T``,
    0 where the raw beta row sums to 0, cast back to the buffer's type.
    This is the CPU path of ``segment.segment_mix_stacked`` and the oracle
    the CUDA kernel is held to."""
    mixed, d = _segment_mix_f32(flat, self_w, nbr_idx, nbr_w, beta, local_steps)
    return mixed.to(flat.dtype), d.to(flat.dtype)


def _segment_mix_f32(flat, self_w, nbr_idx, nbr_w, beta, local_steps: int):
    """``segment_mix_stacked_ref``'s (mixed, d) before the cast back: float32."""
    xf = flat.to(torch.float32)
    return _slots_mix_f32(xf, consensus_lib.ring_gather_slots(xf, nbr_idx), self_w, nbr_w, beta,
                          local_steps)


def _slots_mix_f32(xf, gathered, self_w, nbr_w, beta, local_steps: int):
    """The slot sums of a float32 block and its (p, D, N) slots: (mixed, d)."""
    mixed = consensus_lib.mix_slots(self_w, nbr_w, xf, gathered)
    nbr_sum = consensus_lib.slot_sum(beta, gathered)
    has_nbrs = beta.sum(dim=1) > 0.0
    d = torch.where(has_nbrs[:, None], (nbr_sum - xf) / local_steps, torch.zeros_like(xf))
    return mixed, d


def segment_mix_push_sum_stacked_ref(
    flat: torch.Tensor,  # (K, N) de-biased parameters
    mass: torch.Tensor,  # (K,)
    self_w: torch.Tensor,  # (K,)
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the ``segment_mix`` kernel's push-sum mode: the slot
    form of ``segment_mix_stacked_ref`` on the mass-scaled weights, divided
    by y'.  Returns (mixed, d, y').  This is the CPU path of
    ``segment.segment_mix_push_sum_schedule`` and the oracle its kernel mode
    is held to."""
    self_w_y, nbr_w_y, y_new = push_sum_weights(mass, self_w, nbr_idx, nbr_w)
    num, d = _segment_mix_f32(flat, self_w_y, nbr_idx, nbr_w_y, beta, local_steps)
    return (num / y_new[:, None]).to(flat.dtype), d.to(flat.dtype), y_new


def segment_mix_slots_ref(
    block: torch.Tensor,  # (p, N) float32
    slots: torch.Tensor,  # (p, D, N) float32: slot s of peer k at [k, s]
    self_w: torch.Tensor,  # (p,)
    nbr_w: torch.Tensor,  # (p, D)
    beta: torch.Tensor,  # (p, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``segment_mix`` kernel's slot form: the sums of
    ``segment_mix_stacked_ref`` on a block and its gathered slots, the self
    term, then slots 0 .. D-1, in float32.  On slots that hold the rows
    ``nbr_idx`` names its rows equal that function's bit for bit.  This is
    the CPU path of ``segment.segment_mix_slots`` and the oracle its kernel
    is held to."""
    return _slots_mix_f32(block.to(torch.float32), slots, self_w, nbr_w, beta, local_steps)


def segment_mix_push_sum_slots_ref(
    block: torch.Tensor,  # (p, N) float32 de-biased parameters
    slots: torch.Tensor,  # (p, D, N) float32
    mass: torch.Tensor,  # (p,) the block's masses
    slot_mass: torch.Tensor,  # (p, D) each slot's sender mass
    self_w: torch.Tensor,  # (p,)
    nbr_w: torch.Tensor,  # (p, D)
    beta: torch.Tensor,  # (p, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the slot form's mass mode: the weights scaled by the
    senders' masses (``slot_mass``, the gathered form of ``push_sum_weights``'
    ``y[nbr_idx]``), y' summed from the self term through the slots, the
    numerator of ``segment_mix_slots_ref``, divided by y'.  Returns (mixed,
    d, y')."""
    self_w_y = self_w.to(torch.float32) * mass.to(torch.float32)
    nbr_w_y = nbr_w.to(torch.float32) * slot_mass.to(torch.float32)
    y_new = self_w_y
    for slot in range(nbr_w_y.shape[1]):
        y_new = y_new + nbr_w_y[:, slot]
    num, d = _slots_mix_f32(block.to(torch.float32), slots, self_w_y, nbr_w_y, beta,
                            local_steps)
    return num / y_new[:, None], d, y_new

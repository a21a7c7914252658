"""Plain PyTorch version of the fused gossip + affinity update, stacked form.

For every peer k of a (K, N) flat parameter buffer, with D padded neighbor
slots ``nbr_idx[k]``:

    mixed_k = self_w[k] * x_k + sum_d nbr_w[k, d] * x[nbr_idx[k, d]]   (Eq. 4)
    d_k     = (sum_d beta[k, d] * x[nbr_idx[k, d]] - x_k) / T          (Sec. IV-A)

with d_k = 0 when sum_d beta[k, d] == 0 (an isolated peer).  Accumulation in
float32, outputs cast back.  This is the CPU path of
``ops.consensus_mix_stacked`` and the oracle the CUDA kernel is held to.
It loops over the D slots, so it never holds more than one gathered (K, N)
neighbor block at a time.
"""
from __future__ import annotations

import torch


def consensus_mix_stacked_ref(
    flat: torch.Tensor,  # (K, N)
    self_w: torch.Tensor,  # (K,)
    nbr_idx: torch.Tensor,  # (K, D) int
    nbr_w: torch.Tensor,  # (K, D)
    beta: torch.Tensor,  # (K, D)
    local_steps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    xf = flat.to(torch.float32)
    nbr_idx = nbr_idx.long()
    nbr_w = nbr_w.to(torch.float32)
    beta = beta.to(torch.float32)
    mixed = self_w.to(torch.float32)[:, None] * xf
    nbr_sum = torch.zeros_like(xf)
    for slot in range(nbr_idx.shape[1]):
        nbr = xf[nbr_idx[:, slot]]  # (K, N): every peer's slot-th neighbor
        mixed = mixed + nbr_w[:, slot, None] * nbr
        nbr_sum = nbr_sum + beta[:, slot, None] * nbr
    has_nbrs = beta.sum(dim=1) > 0.0
    d = torch.where(has_nbrs[:, None], (nbr_sum - xf) / local_steps, torch.zeros_like(xf))
    return mixed.to(flat.dtype), d.to(flat.dtype)

"""Plain PyTorch versions of the flash-attention kernel (the port's
``repro.kernels.flash_attention.ref``).

Materialized-scores attention with causal and sliding-window masking:
float32 scores and softmax, the reference's finite ``NEG_INF`` for masked
scores, the output cast to q's type.

- ``attention_ref`` takes q, k and v in the reference oracle's (B, H, S, D)
  layout (KV heads already expanded);
- ``gqa_attention_ref`` takes the model's layout, q (B, S, H, D) and k, v
  (B, S, Kh, D), query head h reading KV head h // (H // Kh).  It loops over
  the KV heads, so at most one group's (B, H // Kh, S, S) scores are live:
  at S = 8192 and a group of 4 that is 1.07 GB per batch row, not 8.6 GB.

These are what the CPU takes and what the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _mask(s: int, *, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, S) bool: query row i may read key column j."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    return mask


def attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, S, D) in q's type: ``gqa_attention_ref`` on transposed views,
    one KV head per query head."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return gqa_attention_ref(qt, kt, vt, causal=causal, window=window,
                             scale=scale).transpose(1, 2)


def gqa_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Kh, D)
    v: torch.Tensor,  # (B, S, Kh, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, S, H, D) in q's type; one KV head's query group at a time."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    group = h // kh
    scale = scale if scale is not None else d**-0.5
    mask = _mask(s, causal=causal, window=window, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for j in range(kh):
        qg = q[:, :, j * group:(j + 1) * group].float()  # (B, S, G, D)
        scores = torch.einsum("bqgd,bkd->bgqk", qg, k[:, :, j].float()) * scale
        probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        del scores
        ctx = torch.einsum("bgqk,bkd->bqgd", probs, v[:, :, j].float())
        out[:, :, j * group:(j + 1) * group] = ctx.to(q.dtype)
    return out

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

``gqa_attention_ref(..., return_lse=True)`` also returns the row
log-sum-exp of the scaled, masked scores, (B, H, S) float32, which the
backward reads; ``gqa_attention_bwd_ref`` is the plain backward, written out
from the formulas (P = exp(S scale - lse), dV = P^T dO, dP = dO V^T,
dS = P (dP - rowsum(dO O)), dQ = dS K scale, dK = dS^T Q scale, each KV
head's dK and dV summed over its query group), not through autograd.

These are what the CPU takes and what the CUDA kernels are held to on the
card.
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
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) in q's type; one KV head's query group at a time.
    ``return_lse``: also the (B, H, S) float32 row log-sum-exp."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    group = h // kh
    scale = scale if scale is not None else d**-0.5
    mask = _mask(s, causal=causal, window=window, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    for j in range(kh):
        qg = q[:, :, j * group:(j + 1) * group].float()  # (B, S, G, D)
        scores = torch.where(mask, torch.einsum("bqgd,bkd->bgqk", qg, k[:, :, j].float()) * scale,
                             NEG_INF)
        if return_lse:
            lse[:, j * group:(j + 1) * group] = torch.logsumexp(scores, dim=-1)
        probs = torch.softmax(scores, dim=-1)
        del scores
        ctx = torch.einsum("bgqk,bkd->bqgd", probs, v[:, :, j].float())
        out[:, :, j * group:(j + 1) * group] = ctx.to(q.dtype)
    return (out, lse) if return_lse else out


def gqa_attention_bwd_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Kh, D)
    v: torch.Tensor,  # (B, S, Kh, D)
    out: torch.Tensor,  # (B, S, H, D): the forward's output
    dout: torch.Tensor,  # (B, S, H, D): the gradient of the output
    lse: torch.Tensor,  # (B, H, S) float32: the forward's row log-sum-exp
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the operands' types, from the formulas in float32,
    one KV head's query group at a time; a key that is not visible has
    probability exactly 0."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    group = h // kh
    scale = scale if scale is not None else d**-0.5
    mask = _mask(s, causal=causal, window=window, device=q.device)
    dq, dk, dv = [], [], []  # built out of place: the backward may run under vmap
    for j in range(kh):
        heads = slice(j * group, (j + 1) * group)
        qg, og, dog = (x[:, :, heads].float() for x in (q, out, dout))  # (B, S, G, D)
        kj, vj = k[:, :, j].float(), v[:, :, j].float()  # (B, S, D)
        scores = torch.einsum("bqgd,bkd->bgqk", qg, kj) * scale
        p = torch.where(mask, torch.exp(scores - lse[:, heads, :, None]), 0.0)
        del scores
        dv.append(torch.einsum("bgqk,bqgd->bkd", p, dog))
        delta = (dog * og).sum(dim=-1).transpose(1, 2)  # (B, G, S): rowsum(dO o O)
        ds = p * (torch.einsum("bqgd,bkd->bgqk", dog, vj) - delta[..., None])
        del p
        dq.append(torch.einsum("bgqk,bkd->bqgd", ds, kj) * scale)
        dk.append(torch.einsum("bgqk,bqgd->bkd", ds, qg) * scale)
    return (torch.cat(dq, dim=2).to(q.dtype), torch.stack(dk, dim=2).to(k.dtype),
            torch.stack(dv, dim=2).to(v.dtype))

"""Plain PyTorch version of the chunked Mamba2 SSD.

Per head, state S in R^{P x N}, scalar decay per head and step (ld = dt * a
<= 0), decay-then-add:
    S_t = exp(ld_t) S_{t-1} + (dt_t x_t) B_t^T
    y_t = S_t C_t

``ssd_chunked_ref`` is the plain version of the hand-written kernel
(``csrc/ssd.cu``): the chunk scan of the reference's
``repro.models.ssm.mamba2_apply_chunked``, with a state in and the final
state out.  Per chunk of Q steps, with cum the inclusive prefix sum of ld:

    att[t,s] = exp(cum_t - cum_s) (C_t . B_s) dt_s     for s <= t
    y        = att x + (C * exp(cum)) S^T
    S        = exp(cum_last) S + x^T (B * dt * exp(cum_last - cum))

A ragged last chunk is computed on its real rows only, which gives what the
reference's zero padding (dt = 0: decay 1, no input) gives.  Head h reads
B/C group h // (H // G), as the reference's ``_expand_groups`` repeats them.
Computes in float32 and returns float32.
"""
from __future__ import annotations

import torch


def expand_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, G, N) -> (B, T, H, N): head h reads group h // (H // G)."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_chunked_ref(x, b, c, dt, a, *, state=None, chunk: int = 64):
    """x (B, T, H, P); b, c (B, T, G, N); dt (B, T, H) float32 (softplus'd);
    a (H,) negative; state (B, H, P, N) float32 or None (zeros).  Returns
    (y (B, T, H, P), final state (B, H, P, N)), both float32."""
    bs, t, h, p = x.shape
    n = b.shape[3]
    q = min(chunk, t)
    xf = x.float()
    bf, cf = (expand_groups(m, h).float() for m in (b, c))
    dtf, af = dt.float(), a.float()
    s = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for start in range(0, t, q):
        xq, bq, cq, dtq = (m[:, start:start + q] for m in (xf, bf, cf, dtf))
        rows = xq.shape[1]  # q, or fewer in a ragged last chunk
        cum = torch.cumsum(dtq * af, dim=1)  # (B, rows, H), inclusive, <= 0
        # above the diagonal the exponent is positive: -inf before the exp
        tri = torch.tril(torch.ones((rows, rows), dtype=torch.bool, device=x.device))
        pair = cum[:, :, None] - cum[:, None, :]  # (B, t, s, H)
        pair = torch.where(tri[None, :, :, None], pair, float("-inf"))
        att = torch.exp(pair) * torch.einsum("bthn,bshn->btsh", cq, bq) * dtq[:, None]
        y = torch.einsum("btsh,bshp->bthp", att, xq)
        y = y + torch.einsum("bthn,bhpn->bthp", cq * torch.exp(cum)[..., None], s)
        rem = torch.exp(cum[:, -1:] - cum)  # (B, rows, H)
        s = s * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bshn,bshp->bhpn", bq * (rem * dtq)[..., None], xq)
        ys.append(y)
    return torch.cat(ys, dim=1), s

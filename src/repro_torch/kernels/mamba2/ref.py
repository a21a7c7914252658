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


# the backward's chunk (kQ in csrc/ssd_bwd.cu): its log-decay running sum
# restarts from a direct inner product at every chunk's end
BWD_CHUNK = 16


def per_batch(a: torch.Tensor, b: int) -> torch.Tensor:
    """a (H,) or (G_a, H) as a (B, H) float32 tensor: batch element b's row."""
    af = a.float()
    return af.expand(b, *af.shape) if af.dim() == 1 else af.repeat_interleave(b // af.shape[0], 0)


def ssd_chunked_ref(x, b, c, dt, a, *, state=None, chunk: int = 64):
    """x (B, T, H, P); b, c (B, T, G, N); dt (B, T, H) float32 (softplus'd);
    a (H,) negative; state (B, H, P, N) float32 or None (zeros).  Returns
    (y (B, T, H, P), final state (B, H, P, N)), both float32."""
    bs, t, h, p = x.shape
    n = b.shape[3]
    q = min(chunk, t)
    xf = x.float()
    bf, cf = (expand_groups(m, h).float() for m in (b, c))
    dtf, af = dt.float(), per_batch(a, bs)[:, None]  # (B, 1, H)
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


def ssd_bwd_ref(x, b, c, dt, a, state, dy, dstate):
    """The gradients of ``ssd_chunked_ref``'s (y, final state) against (x, b,
    c, dt, a, state), given ``dy`` (B, T, H, P) and ``dstate`` (B, H, P, N)
    or None (zeros): (dx, db, dc (B, T, G, N), ddt, da of a's shape, dstate
    (B, H, P, N)), float32.

    Two passes over the tokens, as the kernel makes them.  Forward, from the
    state in: S_t = alpha_t S_{t-1} + dt_t x_t B_t^T (alpha = exp(dt a)),
    dC_t = S_t^T dy_t.  Reverse, carrying G = dL/dS_t from ``dstate``: G +=
    dy_t C_t^T, then dx_t = dt_t G B_t, dB_t = dt_t G^T x_t, G = alpha_t G;
    the G left is the state's gradient.  The log-decays l = dt a: dl_t =
    alpha_t <G_t, S_{t-1}>, and, with c their prefix sum (S_t carries
    exp(c_t) and every x_s B_s^T in it exp(-c_s)), dL/dc_t = C_t . dC_t -
    x_t . dx_t, so dl_t = dl_{t+1} + C_t . dC_t - x_t . dx_t: a running sum
    in the reverse pass, which needs no S_{t-1}.  Over a long memory its
    terms grow far beyond dl and cancel (da lost 2.8e-4 of its float32
    value at zamba2's head shape, ``tools/bwd_precision.py``), so the sum
    restarts at every chunk's end (each ``BWD_CHUNK`` tokens) from the
    direct alpha <G, S> against the state the forward pass left there
    (<dstate, S_T> at the end).  ddt_t = x_t . (G_t B_t) + a dl_t and da =
    sum dt_t dl_t.  A head's dB and dC are summed over the heads of its
    group."""
    bs, t, h, p = x.shape
    g_, n = b.shape[2], b.shape[3]
    xf, dyf, dtf = x.float(), dy.float(), dt.float()
    bf, cf = (expand_groups(m, h).float() for m in (b, c))
    ab = per_batch(a, bs)  # (B, H)
    alpha = torch.exp(dtf * ab[:, None])  # (B, T, H)
    s = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    dc_head, ends = [], {}  # ends: the state at each chunk's end but the last
    for i, (xt, bt, dyt, dtt, at) in enumerate(zip(xf.unbind(1), bf.unbind(1), dyf.unbind(1),
                                                   dtf.unbind(1), alpha.unbind(1))):
        s = at[..., None, None] * s + (dtt[..., None] * xt)[..., None] * bt[:, :, None]
        dc_head.append(torch.einsum("bhpn,bhp->bhn", s, dyt))
        if (i + 1) % BWD_CHUNK == 0 and i + 1 < t:
            ends[i] = s
    dc_head = torch.stack(dc_head, dim=1)  # (B, T, H, N)
    cdc = (cf * dc_head).sum(-1)  # (B, T, H)
    g = torch.zeros_like(s) if dstate is None else dstate.float()
    run = (g * s).sum((-2, -1))  # <dstate, S_T>: (B, H)
    da = torch.zeros_like(run)
    dxs, dbs, ddts = [], [], []
    for i in reversed(range(t)):
        if i in ends:  # g is alpha_{i+1} G_{i+1}: dl_{i+1} directly
            run = (g * ends[i]).sum((-2, -1))
        g = g + dyf[:, i, :, :, None] * cf[:, i, :, None]
        gb = torch.einsum("bhpn,bhn->bhp", g, bf[:, i])
        dxs.append(dtf[:, i, :, None] * gb)
        dbs.append(dtf[:, i, :, None] * torch.einsum("bhpn,bhp->bhn", g, xf[:, i]))
        xgb = (xf[:, i] * gb).sum(-1)
        run = run + cdc[:, i] - dtf[:, i] * xgb
        ddts.append(xgb + ab * run)
        da = da + dtf[:, i] * run
        g = alpha[:, i, :, None, None] * g
    dx, db_head, ddt = (torch.stack(v[::-1], dim=1) for v in (dxs, dbs, ddts))
    db, dc = (m.view(bs, t, g_, h // g_, n).sum(3) for m in (db_head, dc_head))
    da = da.sum(0) if a.dim() == 1 else da.view(a.shape[0], -1, h).sum(1)
    return dx, db, dc, ddt, da, g

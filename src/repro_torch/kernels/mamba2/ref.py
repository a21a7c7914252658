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

``ssd_ref`` is the reference's oracle by name and call (B and C per head,
an ``initial_state``), the same scan.  ``ssd_bwd_ref`` is the plain version of the backward kernel
(``csrc/ssd_bwd.cu``), the token recurrence; ``ssd_bwd_chunked_ref`` is the
kernel's chunked decomposition, for the tests (with ``tf32_product``, the
kernel's TF32 passes emulated).
"""
from __future__ import annotations

import torch


def expand_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, G, N) -> (B, T, H, N): head h reads group h // (H // G)."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


# ssd_bwd_ref's log-decay running sum restarts from a direct inner product
# every BWD_CHUNK tokens
BWD_CHUNK = 16
# the backward kernel's chunk (kQ in csrc/ssd_bwd.cu)
BWD_Q = 64


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


def ssd_ref(x, b, c, dt, a, initial_state=None):
    """x (B, T, H, P); b, c (B, T, H, N); dt (B, T, H); a (H,) negative.
    Returns (y (B, T, H, P), final state (B, H, P, N)), float32 (the
    reference's ``ref.ssd_ref``, through ``ssd_chunked_ref``)."""
    return ssd_chunked_ref(x, b, c, dt, a, state=initial_state)


def ssd_bwd_ref(x, b, c, dt, a, state, dy, dstate):
    """The gradients of ``ssd_chunked_ref``'s (y, final state) against (x, b,
    c, dt, a, state), given ``dy`` (B, T, H, P) and ``dstate`` (B, H, P, N)
    or None (zeros): (dx, db, dc (B, T, G, N), ddt, da of a's shape, dstate
    (B, H, P, N)), float32.

    Two passes over the tokens.  Forward, from the
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


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32, to nearest with ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(m1, m2, split1: bool, split2: bool, *, one_pass: bool = False):
    """m1 @ m2 as the backward kernel's TF32 passes compute it: an operand
    marked split is a float32 value taken as hi + lo, hi = tf32(v) and lo =
    v - hi truncated to TF32 by the tensor cores, and the product summed as
    lo hi + hi lo + hi hi; else it is exact in TF32 (a widened bf16).  Each pass is a float32
    matmul (a product of two TF32 values is exact in float32).
    ``one_pass`` rounds both operands to TF32 once instead."""
    if one_pass:
        return tf32(m1) @ tf32(m2)
    hi1, hi2 = (tf32(m) if split else m for m, split in ((m1, split1), (m2, split2)))
    out = hi1 @ hi2
    if split1:
        out = out + _tf32_truncated(m1 - hi1) @ hi2
    if split2:
        out = out + hi1 @ _tf32_truncated(m2 - hi2)
    return out


def _tf32_truncated(v: torch.Tensor) -> torch.Tensor:
    """float32 v as a tensor core reads a .tf32 operand: the 13 low bits of
    the significand dropped."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def ssd_bwd_chunked_ref(x, b, c, dt, a, state, dy, dstate, *, chunk: int = BWD_Q,
                        product=None):
    """``ssd_bwd_ref``'s gradients by the backward kernel's decomposition
    (``csrc/ssd_bwd.cu``): T zero-padded to chunks of ``chunk`` tokens; each
    chunk's state contribution U = X^T (B o w) and its gradient's L = (dY o
    exp(cum))^T C; a pass over the chunks for the chunk-start states S_c and
    a reverse one for the chunk-end gradients G_{c+1} (G_0 is dS_0); within
    each chunk dC = exp(cum) o (dY S_c) + (dAtt o E o dt_s) B, dxr = e o (B
    G^T) + (E o C B^T)^T dY, dB = w o (X G) + (E o dt_s o X dY^T)^T C with
    dAtt = dY X^T (the transposed products recomputed, as the kernel does),
    and the log-decays' gradient dl_t = <G, S_{c+1}> + sum_{t' >= t} (C_t' .
    dC_t' - dt_t' x_t' . dxr_t') within the chunk, summed in reverse token
    order; ddt = x . dxr + a dl, da = sum dt dl.

    ``product(m1, m2, split1, split2)`` computes each chunk product m1 @ m2,
    told which operands the kernel splits (float32 values) and which are exact
    (bf16 x, B and C): ``torch.matmul`` by default, ``tf32_product`` for the
    kernel's passes.  Returns (dx, db, dc, ddt, da, dstate) as
    ``ssd_bwd_ref``, float32."""
    prod = product or (lambda m1, m2, _s1, _s2: m1 @ m2)
    bs, t, h, p = x.shape
    g_, n = b.shape[2], b.shape[3]
    q = chunk
    nc = -(-t // q)
    split = x.dtype == torch.float32  # bf16 x, B and C are exact in TF32

    def chunked(m):  # (B, T, H, ...) -> (B, H, nc, Q, ...), zero-padded
        m = torch.nn.functional.pad(m.float(), (0, 0) * (m.dim() - 2) + (0, nc * q - t))
        return m.unflatten(1, (nc, q)).movedim(3, 1)

    xf, dyf = chunked(x), chunked(dy)
    bf, cf = (chunked(expand_groups(m, h)) for m in (b, c))
    dtf = chunked(dt[..., None])[..., 0]  # (B, H, nc, Q)
    ab = per_batch(a, bs)  # (B, H)
    cum = torch.cumsum(dtf * ab[..., None, None], dim=-1)
    cl = cum[..., -1]  # (B, H, nc)
    e = torch.exp(cl[..., None] - cum)
    w, ec = dtf * e, torch.exp(cum)
    u = prod(xf.transpose(-1, -2), bf * w[..., None], split, True)  # (B, H, nc, P, N)
    lc = prod((dyf * ec[..., None]).transpose(-1, -2), cf, True, split)
    s = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    starts = []
    for i in range(nc):
        starts.append(s)
        s = torch.exp(cl[..., i])[..., None, None] * s + u[:, :, i]
    g = torch.zeros_like(s) if dstate is None else dstate.float()
    ends = [None] * nc
    for i in reversed(range(nc)):
        ends[i] = g
        g = torch.exp(cl[..., i])[..., None, None] * g + lc[:, :, i]
    sc, ge = torch.stack(starts, 2), torch.stack(ends, 2)  # (B, H, nc, P, N)

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    pair = torch.where(tri, cum[..., :, None] - cum[..., None, :], float("-inf"))
    big_e = torch.exp(pair)  # E[t, s], 0 above the diagonal
    dcb = prod(dyf, xf.transpose(-1, -2), True, split) * big_e * dtf[..., None, :]
    dc = ec[..., None] * prod(dyf, sc, True, True) + prod(dcb, bf, True, split)
    att_t = big_e.transpose(-1, -2) * prod(bf, cf.transpose(-1, -2), split, split)
    state_x = e[..., None] * prod(bf, ge.transpose(-1, -2), split, True)  # e o (B G^T)
    dxr = state_x + prod(att_t, dyf, True, True)
    dcb_t = big_e.transpose(-1, -2) * dtf[..., :, None] * prod(
        xf, dyf.transpose(-1, -2), split, True)
    db = w[..., None] * prod(xf, ge, split, True) + prod(dcb_t, cf, True, split)
    dot = torch.exp(cl) * (ge * sc).sum((-2, -1)) + (dtf * (xf * state_x).sum(-1)).sum(-1)
    cdc, xdxr = (cf * dc).sum(-1), (xf * dxr).sum(-1)
    run, dls = dot, []
    for i in reversed(range(q)):
        run = run + cdc[..., i] - dtf[..., i] * xdxr[..., i]
        dls.append(run)
    dl = torch.stack(dls[::-1], dim=-1)  # (B, H, nc, Q)
    ddt = xdxr + ab[..., None, None] * dl
    da = (dtf * dl).sum((-2, -1))  # (B, H)

    def unchunked(m):  # (B, H, nc, Q, ...) -> (B, T, H, ...)
        return m.movedim(1, 3).flatten(1, 2)[:, :t]

    dx = unchunked(dtf[..., None] * dxr)
    db, dc = (unchunked(m).view(bs, t, g_, h // g_, n).sum(3) for m in (db, dc))
    ddt = unchunked(ddt[..., None])[..., 0]
    da = da.sum(0) if a.dim() == 1 else da.view(a.shape[0], -1, h).sum(1)
    return dx, db, dc, ddt, da, g

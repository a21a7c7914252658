"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence.

Per head, state S in R^{dk x dv}:
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(logdecay_t)) S_{t-1} + k_t v_t^T
with data-dependent per-channel log-decays (<= 0).

``wkv6_ref`` is the token-sequential oracle (the port's
``repro.kernels.rwkv6.ref.wkv6_ref``).  ``wkv6_chunked_ref`` is the plain
version of the hand-written kernel (``csrc/wkv6.cu``): the chunk scan of the
reference's ``repro.models.ssm.rwkv6_time_mix_chunked``, with a state in and
the final state out, and a ragged tail zero-padded (log-decay 0, k = v = 0,
so the state passes through the padded steps unchanged).  ``wkv6_bwd_ref``
is the plain version of the backward kernel (``csrc/wkv6_bwd.cu``): the
token-sequential reverse recurrence, the function the kernel computes;
``wkv6_bwd_chunked_ref`` is the kernel's chunked decomposition, for the
tests and tools (with a ``product`` hook for the kernel's TF32 passes).  All
compute in float32 and return float32.

``u`` is (H, dk), shared by the batch, or (G, H, dk): batch element b reads
row b // (B // G) (a vmapped call's peers folded into the batch, each with
its own u).
"""
from __future__ import annotations

import torch

# the backward kernel's chunk and sub-chunk (kQ and kSub in csrc/wkv6_bwd.cu)
BWD_Q = 64
BWD_SUB = 16


def per_batch(u: torch.Tensor, b: int) -> torch.Tensor:
    """u (H, dk) or (G, H, dk) as a (B, H, dk) float32 tensor: batch element
    b's row."""
    uf = u.float()
    return uf.expand(b, *uf.shape) if uf.dim() == 2 else uf.repeat_interleave(b // uf.shape[0], 0)


def _state0(state, b, h, dk, device):
    if state is None:
        return torch.zeros((b, h, dk, dk), dtype=torch.float32, device=device)
    return state.float()


def wkv6_ref(r, k, v, logdecay, u, initial_state=None):
    """r/k/v/logdecay: (B, T, H, dk); u: (H, dk). Returns (o (B,T,H,dk), S)."""
    b, t, h, dk = r.shape
    rf, kf, vf, ld = (x.float() for x in (r, k, v, logdecay))
    uf = u.float()
    s = _state0(initial_state, b, h, dk, r.device)
    outs = []
    for i in range(t):
        rt, kt, vt = rf[:, i], kf[:, i], vf[:, i]  # (B, H, dk)
        ot = (rt.unsqueeze(-2) @ s).squeeze(-2) + (rt * uf * kt).sum(-1, keepdim=True) * vt
        s = torch.exp(ld[:, i]).unsqueeze(-1) * s + kt.unsqueeze(-1) * vt.unsqueeze(-2)
        outs.append(ot)
    return torch.stack(outs, dim=1), s


def wkv6_chunked_ref(r, k, v, logdecay, u, state=None, chunk: int = 16):
    """The chunk scan: (B, T, H, dk) x4, u (H, dk), state (B, H, dk, dk) or
    None -> (o (B, T, H, dk), final state), both float32."""
    b, t, h, dk = r.shape
    q = min(chunk, t)
    rh, kh, vh, ld = (x.float() for x in (r, k, v, logdecay))
    uf = u.float() if u.dim() == 2 else per_batch(u, b)[:, None]
    pad = (-t) % q
    if pad:
        rh, kh, vh, ld = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (rh, kh, vh, ld))
    nc = (t + pad) // q
    s = _state0(state, b, h, dk, r.device)
    tri_strict = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), diagonal=-1)
    ys = []
    for c in range(nc):
        rq, kq, vq, ldq = (x[:, c * q:(c + 1) * q] for x in (rh, kh, vh, ld))  # (B,q,H,dk)
        cum = torch.cumsum(ldq, dim=1)  # inclusive; <= 0, decreasing in t
        cum_ex = cum - ldq  # exclusive: RWKV reads S_{t-1} (decay after read)
        # att[t,s] = sum_i r_t[i] k_s[i] exp(cum_ex_t - cum_s), strictly s < t;
        # above the diagonal the exponent can be large and positive, so it
        # goes to -inf before the exp
        pair = cum_ex[:, :, None] - cum[:, None]  # (B,t,s,H,dk)
        pair = torch.where(tri_strict[None, :, :, None, None], pair, float("-inf"))
        att = torch.einsum("bthi,bshi,btshi->btsh", rq, kq, torch.exp(pair))
        y = torch.einsum("btsh,bshj->bthj", att, vq)
        # current-step bonus: (r_t . (u * k_t)) v_t
        y = y + (rq * uf * kq).sum(-1, keepdim=True) * vq
        # inter-chunk: r_t . (exp(cum_ex_t) * S_prev)
        y = y + torch.einsum("bthi,bhij->bthj", rq * torch.exp(cum_ex), s)
        # contribution of s decays by steps s+1..last: exp(cum_last - cum_s)
        rem = torch.exp(cum[:, -1:] - cum)
        s = s * torch.exp(cum[:, -1]).unsqueeze(-1) + torch.einsum("bshi,bshj->bhij", kq * rem, vq)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], s


def wkv6_bwd_ref(r, k, v, logdecay, u, state, dout, dstate):
    """The gradients of ``wkv6_chunked_ref``'s (out, final state) against
    (r, k, v, logdecay, u, state), given ``dout`` (B, T, H, dk) and
    ``dstate`` (B, H, dk, dk) or None (zeros): (dr, dk, dv, dlogdecay,
    du of u's shape, dstate (B, H, dk, dk)), float32.

    Two passes over the tokens, as the kernel makes them.  Forward, from
    the state in: dr_t = S_{t-1} do_t + u k_t (v_t . do_t), and S to the
    final state.  Reverse, carrying G = dL/dS_t from ``dstate``:
    dk_t = G v_t + r_t u (v_t . do_t), dv_t = G^T k_t + (r_t . u k_t) do_t,
    then G = diag(w_t) G + r_t do_t^T (w = exp(logdecay)); the G left is
    the state's gradient.  The log-decays' gradient needs no state beside
    G: with c the prefix sum of the log-decays, S_{t-1} carries
    exp(c_{t-1}) on its rows and every k_s v_s^T in it exp(-c_s), so
    dL/dc_t = r_{t+1} (S_t do_{t+1}) - k_t (G_t v_t), plus the final state's
    rows of dstate * S_T at t = T; dlogdecay_t is the sum of these from t to
    T, a running sum in the reverse pass.  du_i = sum_t r_t,i k_t,i
    (v_t . do_t)."""
    b, t, h, dk = r.shape
    rf, kf, vf, ld, do = (x.float() for x in (r, k, v, logdecay, dout))
    ub = per_batch(u, b)  # (B, H, dk)
    w = torch.exp(ld)
    vdo = (vf * do).sum(-1, keepdim=True)  # (B, T, H, 1)
    ruk = (rf * ub[:, None] * kf).sum(-1, keepdim=True)
    s = _state0(state, b, h, dk, r.device)
    dr_state = []  # S_{t-1} do_t
    for kt, vt, dot, wt in zip(kf.unbind(1), vf.unbind(1), do.unbind(1), w.unbind(1)):
        dr_state.append((s @ dot.unsqueeze(-1)).squeeze(-1))
        s = wt.unsqueeze(-1) * s + kt.unsqueeze(-1) * vt.unsqueeze(-2)
    dr_state = torch.stack(dr_state, dim=1)
    dr = dr_state + ub[:, None] * kf * vdo
    g = torch.zeros_like(s) if dstate is None else dstate.float()
    run = (g * s).sum(-1)  # the final state's term of dL/dc_T
    dks, dvs, dld = [], [], []
    for i in reversed(range(t)):
        dk_state = (g @ vf[:, i].unsqueeze(-1)).squeeze(-1)  # G v_t
        dvs.append((kf[:, i].unsqueeze(-2) @ g).squeeze(-2))  # G^T k_t
        dks.append(dk_state)
        dld.append(run - kf[:, i] * dk_state)
        run = dld[-1] + rf[:, i] * dr_state[:, i]
        g = w[:, i].unsqueeze(-1) * g + rf[:, i].unsqueeze(-1) * do[:, i].unsqueeze(-2)
    dk_state, dv_state, dld = (torch.stack(x[::-1], dim=1) for x in (dks, dvs, dld))
    dk_ = dk_state + rf * ub[:, None] * vdo
    dv_ = dv_state + ruk * do
    du = (rf * kf * vdo).sum(1)  # (B, H, dk)
    du = du.sum(0) if u.dim() == 2 else du.view(u.shape[0], -1, h, dk).sum(1)
    return dr, dk_, dv_, dld, du, g


def wkv6_bwd_chunked_ref(r, k, v, logdecay, u, state, dout, dstate, *, chunk: int = BWD_Q,
                         sub: int = BWD_SUB, product=None):
    """``wkv6_bwd_ref``'s gradients by the backward kernel's decomposition
    (``csrc/wkv6_bwd.cu``): T zero-padded to chunks of ``chunk`` tokens, each
    cut into sub-chunks of ``sub``, with c the prefix sum of the log-decays
    restarted at every sub-chunk (``c_ex`` its exclusive form, ``ct`` the
    sub-chunk's total, w = exp(ct)), r^ = r o exp(c_ex) and k^ = k o exp(ct -
    c).  Every exponent is a sum of log-decays, <= 0.

    1. A pass over the sub-chunks for the state at every chunk's start,
       S <- diag(w) S + k^T v (k^, v of the sub-chunk) from the state in,
       and a reverse one for the gradient at every chunk's end, G <- diag(w)
       G + r^T do from ``dstate``; the G left is the state's gradient.
    2. Within a chunk, from its S_c and G_{c+1}, the same two passes over its
       sub-chunks give each sub-chunk's starting state S_J and ending
       gradient M_J, and with dAtt = do v^T and E[t,s] = exp(c_ex_t - c_s)
       (s < t in one sub-chunk):
         dr~ = exp(c_ex) o (do S_J^T) + sum_{s<t} dAtt[t,s] (k_s o E[t,s])
         dk~ = exp(ct - c) o (v M_J^T) + sum_{t>s} dAtt[t,s] (r_t o E[t,s])
         dv  = k^ M_J + A^T do,  A[t,s] = r_t . (k_s o E[t,s]) for s < t,
               A[t,t] = r_t . (u o k_t)
       dr = dr~ + u o k (v . do), dk = dk~ + r o u (v . do), du = sum_t r o k
       (v . do); the log-decays' gradient restarts at the chunk's end e:
         dld_t = rowsum(G_{c+1} o S_{c+1}) + sum_{m=t..e} (r_m o dr~_m -
                 k_m o dk~_m) - r_t o dr~_t,
       summed in reverse token order.

    ``product(m1, m2, split1, split2)`` computes each product m1 @ m2, told
    which operands the kernel splits (float32 values) and which are exact in
    TF32 (bf16 r, k, v and do): ``torch.matmul`` by default,
    ``mamba2.ref.tf32_product`` for the kernel's passes.  Returns (dr, dk,
    dv, dlogdecay, du, dstate) as ``wkv6_bwd_ref``, float32."""
    prod = product or (lambda m1, m2, _s1, _s2: m1 @ m2)
    if chunk % sub:
        raise ValueError(f"sub ({sub}) must divide chunk ({chunk})")
    b, t, h, dk = r.shape
    ns = chunk // sub
    nc = -(-t // chunk)
    n = nc * ns
    exact = all(x.dtype == torch.bfloat16 for x in (r, k, v, dout))
    split = not exact

    def subs(m):  # (B, T, H, dk) -> (B, H, n, sub, dk), zero-padded
        m = torch.nn.functional.pad(m.float(), (0, 0, 0, 0, 0, n * sub - t))
        return m.unflatten(1, (n, sub)).movedim(3, 1)

    rf, kf, vf, ld, do = (subs(x) for x in (r, k, v, logdecay, dout))
    c = torch.cumsum(ld, dim=3)
    c_ex = c - ld
    ct = c[..., -1:, :]  # (B, H, n, 1, dk)
    er, ek, w = torch.exp(c_ex), torch.exp(ct - c), torch.exp(ct[..., 0, :])
    rh, kh = rf * er, kf * ek
    ups = prod(kh.transpose(-1, -2), vf, True, split)  # (B, H, n, dk, dk)
    lows = prod(rh.transpose(-1, -2), do, True, split)

    s = (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    starts = []
    for i in range(n):
        if i % ns == 0:
            starts.append(s)
        s = w[:, :, i, :, None] * s + ups[:, :, i]
    g = torch.zeros_like(s) if dstate is None else dstate.float()
    ends = [None] * nc
    for i in reversed(range(n)):
        if i % ns == ns - 1:
            ends[i // ns] = g
        g = w[:, :, i, :, None] * g + lows[:, :, i]

    def chunks(m):  # (B, H, n, ...) -> (B, H, nc, ns, ...)
        return m.unflatten(2, (nc, ns))

    rf, kf, vf, do, c, c_ex, er, ek, kh, w, ups, lows = map(
        chunks, (rf, kf, vf, do, c, c_ex, er, ek, kh, w, ups, lows))
    sub_s = [torch.stack(starts, 2)]  # (B, H, nc, dk, dk)
    for j in range(ns):
        sub_s.append(w[:, :, :, j, :, None] * sub_s[-1] + ups[:, :, :, j])
    m = torch.stack(ends, 2)
    g_end, sub_m = m, [None] * ns
    for j in reversed(range(ns)):
        sub_m[j] = m
        m = w[:, :, :, j, :, None] * m + lows[:, :, :, j]
    s_j, m_j = torch.stack(sub_s[:ns], 3), torch.stack(sub_m, 3)  # (B, H, nc, ns, dk, dk)

    tri = torch.tril(torch.ones((sub, sub), dtype=torch.bool, device=r.device), diagonal=-1)
    pair = torch.where(tri[:, :, None], c_ex[..., :, None, :] - c[..., None, :, :],
                       float("-inf"))
    e = torch.exp(pair)  # (..., t, s, dk), 0 where s >= t
    datt = prod(do, vf.transpose(-1, -2), split, split)  # (..., t, s)
    vdo = torch.diagonal(datt, dim1=-2, dim2=-1)[..., None]  # v_t . do_t
    dlow = datt * tri
    ub = per_batch(u, b)[:, :, None, None, None]  # (B, H, 1, 1, 1, dk)
    att = torch.einsum("...ti,...si,...tsi->...ts", rf, kf, e)
    att = att + torch.diag_embed((rf * ub * kf).sum(-1))
    drt = er * prod(do, s_j.transpose(-1, -2), split, True) + torch.einsum(
        "...ts,...si,...tsi->...ti", dlow, kf, e)
    dkt = ek * prod(vf, m_j.transpose(-1, -2), split, True) + torch.einsum(
        "...ts,...ti,...tsi->...si", dlow, rf, e)
    dv = prod(kh, m_j, True, True) + prod(att.transpose(-1, -2), do, True, split)

    f = (g_end * sub_s[ns]).sum(-1)  # (B, H, nc, dk): rowsum(G_{c+1} o S_{c+1})
    y, z = (rf * drt).flatten(3, 4), (kf * dkt).flatten(3, 4)  # (B, H, nc, Q, dk)
    run, dls = f, []
    for i in reversed(range(chunk)):
        dls.append(run - z[:, :, :, i])
        run = dls[-1] + y[:, :, :, i]
    dld = torch.stack(dls[::-1], 3)

    def untiled(m):  # (B, H, nc, [ns,] Q or sub, dk) -> (B, T, H, dk)
        return m.flatten(2, -2).movedim(1, 2)[:, :t]

    dr = untiled(drt + ub * kf * vdo)
    dk_ = untiled(dkt + rf * ub * vdo)
    du = (rf * kf * vdo).sum((2, 3, 4))  # (B, H, dk)
    du = du.sum(0) if u.dim() == 2 else du.view(u.shape[0], -1, h, dk).sum(1)
    return dr, dk_, untiled(dv), untiled(dld), du, g

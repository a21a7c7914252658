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
token-sequential reverse recurrence it computes.  All compute in float32
and return float32.

``u`` is (H, dk), shared by the batch, or (G, H, dk): batch element b reads
row b // (B // G) (a vmapped call's peers folded into the batch, each with
its own u).
"""
from __future__ import annotations

import torch


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

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
so the state passes through the padded steps unchanged).  Both compute in
float32 and return float32.
"""
from __future__ import annotations

import torch


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
    uf = u.float()
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

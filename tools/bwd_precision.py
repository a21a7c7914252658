#!/usr/bin/env python3
"""How close the plain backwards of ``wkv6`` and ``ssd`` (``ref.wkv6_bwd_ref``,
``ref.ssd_bwd_ref``, which the CUDA backward kernels compute step for step)
come in float32 to float64 autograd through the token recurrence, on the
CPU: the relative norm error of each gradient of the log-decays.

- ``ssd`` at zamba2's head shape (B 2, T 1024, 8 heads of P = N = 64, one
  B/C group, bf16-valued x, B and C, dt ~ U(0.01, 1), a ~ -U(0.5, 2) a row
  for each batch element), ddt and da three ways: as the port computes
  them (the running sum of dl restarted from a direct inner product every
  ``ref.BWD_CHUNK`` tokens), with the restarts off (``BWD_CHUNK`` past T),
  and in the direct form alpha_t <G_t, S_{t-1}> with every state kept;
- ``wkv6`` at rwkv6-7b's head width (B 2, T 1024, 4 heads of 64), dlogdecay
  and the other gradients at three decay ranges.

Prints one JSON object a case.

    PYTHONPATH=src python3 tools/bwd_precision.py   # about a minute
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.mamba2 import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv6_ref  # noqa: E402


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).norm() / want.norm())


def ssd_direct_da(x, bm, cm, dt, a, dy) -> torch.Tensor:
    """da in float32 from alpha_t <G_t, S_{t-1}>, every state kept."""
    bs, t, h, _ = x.shape
    bf, cf = (ssd_ref.expand_groups(m, h) for m in (bm, cm))
    ab = ssd_ref.per_batch(a, bs)
    alpha = torch.exp(dt * ab[:, None])
    s = torch.zeros(bs, h, x.shape[3], bm.shape[3])
    prev = []
    for i in range(t):
        prev.append(s)
        s = (alpha[:, i, :, None, None] * s
             + (dt[:, i, :, None] * x[:, i])[..., None] * bf[:, i][:, :, None])
    g, da = torch.zeros_like(s), torch.zeros(bs, h)
    for i in reversed(range(t)):
        g = g + dy[:, i, :, :, None] * cf[:, i, :, None]
        da = da + dt[:, i] * alpha[:, i] * (g * prev[i]).sum((-2, -1))
        g = alpha[:, i, :, None, None] * g
    return da.view(a.shape[0], -1, h).sum(1)


def ssd_case() -> dict:
    torch.manual_seed(0)
    b, t, h, p, n = 2, 1024, 8, 64, 64
    x = torch.randn(b, t, h, p).bfloat16().float()
    bm, cm = (torch.randn(b, t, 1, n).bfloat16().float() for _ in range(2))
    dt = 0.01 + 0.99 * torch.rand(b, t, h)
    a = -(0.5 + 1.5 * torch.rand(2, h))
    dy = torch.randn(b, t, h, p)
    leaves = [v.double().requires_grad_(True) for v in (dt, a)]
    dd, aa = leaves
    bb, cc = (ssd_ref.expand_groups(m, h).double() for m in (bm, cm))
    ab = ssd_ref.per_batch(aa, b)
    s, ys = torch.zeros(b, h, p, n, dtype=torch.float64), []
    for i in range(t):
        s = (torch.exp(dd[:, i] * ab)[..., None, None] * s
             + (dd[:, i, :, None] * x[:, i].double())[..., None] * bb[:, i][:, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cc[:, i]))
    gdt, ga = torch.autograd.grad((torch.stack(ys, 1) * dy.double()).sum(), leaves)
    out = {"case": "ssd", "B": b, "T": t, "H": h, "P": p, "N": n}
    chunk = ssd_ref.BWD_CHUNK
    for tag, every in (("restarted", chunk), ("end_to_end", t + 1)):
        ssd_ref.BWD_CHUNK = every
        got = ssd_ref.ssd_bwd_ref(x, bm, cm, dt, a, None, dy, None)
        out[f"{tag}_ddt"], out[f"{tag}_da"] = rel(got[3], gdt), rel(got[4], ga)
    ssd_ref.BWD_CHUNK = chunk
    out["direct_da"] = rel(ssd_direct_da(x, bm, cm, dt, a, dy), ga)
    return out


def wkv6_cases() -> list[dict]:
    torch.manual_seed(0)
    b, t, h, dk = 2, 1024, 4, 64
    outs = []
    for name, ld in (("long", -(1e-4 + 2e-3 * torch.rand(b, t, h, dk))),
                     ("model_init", torch.full((b, t, h, dk), -0.0183)),
                     ("short", -(0.01 + 4 * torch.rand(b, t, h, dk)))):
        r, k, v, do = (torch.randn(b, t, h, dk).bfloat16().float() for _ in range(4))
        u = 0.5 * torch.randn(h, dk)
        leaves = [m.double().requires_grad_(True) for m in (r, k, v, ld, u)]
        rr, kk, vv, ll, uu = leaves
        s, outs_t = torch.zeros(b, h, dk, dk, dtype=torch.float64), []
        for i in range(t):
            outs_t.append((rr[:, i].unsqueeze(-2) @ s).squeeze(-2)
                          + (rr[:, i] * uu * kk[:, i]).sum(-1, keepdim=True) * vv[:, i])
            s = (torch.exp(ll[:, i]).unsqueeze(-1) * s
                 + kk[:, i].unsqueeze(-1) * vv[:, i].unsqueeze(-2))
        want = torch.autograd.grad((torch.stack(outs_t, 1) * do.double()).sum(), leaves)
        got = wkv6_ref.wkv6_bwd_ref(r, k, v, ld, u, None, do, None)
        outs.append({"case": f"wkv6_{name}", "B": b, "T": t, "H": h, "head_width": dk,
                     **{f"d{n}": rel(g, w) for n, g, w in zip(("r", "k", "v", "logdecay", "u"),
                                                               got, want)}})
    return outs


if __name__ == "__main__":
    for case in (ssd_case(), *wkv6_cases()):
        print(json.dumps(case), flush=True)

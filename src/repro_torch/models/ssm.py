"""State-space layers: Mamba2 (SSD) and RWKV6 (Finch) with data-dependent
decay (the port's ``repro.models.ssm``).

One layer's parameters are a flat dict with dotted names in the reference's
layouts (``"in_proj"`` (d, d_proj), ``"time_mix.w_r"`` (d, d),
``"time_mix.mix_lora_a"`` (d, 5, r), ...), applied as ``x @ w``.  The casts
are the reference's.  Mamba2: in_proj and the causal depthwise convolution
(the reference's explicit sum over its taps, plus ``conv_b``) in the
parameter type, SiLU and softplus in float32, the SSD core in float32, the
gate in float32 and the RMSNorm cast back.  RWKV6: the LoRA ``tanh`` runs in
float32 and is cast back to the model type, the log-decay is
``-exp(clip(w0 + dw, -12, 4))`` in float32, and r, k and v enter the WKV in
float32.

The chunked forms (prefill and training) send their core through the
hand-written kernels' wrappers: ``mamba2_apply_chunked`` through
``kernels.mamba2.ops.ssd``, ``rwkv6_time_mix_chunked`` through
``kernels.rwkv6.ops.wkv6``; each wrapper's backward is a hand-written
kernel too, so training on the card runs both ways through them.  A bf16
model trained from a bf16 flat buffer (``core.task.from_model``) hands
these layers its float32 leaves (``A_log``, ``D``, ``dt_bias``,
``decay_base``, ``bonus_u``) in bf16; each is widened where it is used.
The scans (``mamba2_apply_scan``, ``rwkv6_time_mix_scan``: decode, one
token at a time, and the oracles) are the token-sequential recurrences and
reach no kernel, in the reference as here.  With ``inplace=True`` (decode in the scanned decode,
``launch.steps.make_decode_scan``) they update the state they are given, in
place, instead of returning new tensors; the values are the same.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2 import ref as ssd_ref
from repro_torch.kernels.rwkv6 import ops as wkv6_ops
from repro_torch.models import common

# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def mamba2_dims(d_model: int, cfg: SSMConfig) -> dict:
    d_inner = cfg.expand * d_model
    nheads = d_inner // cfg.head_dim
    conv_channels = d_inner + 2 * cfg.ngroups * cfg.state_dim
    return dict(d_inner=d_inner, nheads=nheads, conv_channels=conv_channels)


def mamba2_init(
    generator: torch.Generator, d_model: int, cfg: SSMConfig, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """One layer's parameters, drawn on the generator's device."""
    dev = generator.device
    dims = mamba2_dims(d_model, cfg)
    d_in, h, cc = dims["d_inner"], dims["nheads"], dims["conv_channels"]
    d_proj = 2 * d_in + 2 * cfg.ngroups * cfg.state_dim + h
    return {
        "in_proj": common.dense_init(generator, d_model, d_proj, dtype),
        "conv_w": common.truncated_normal_init(generator, (cfg.conv_dim, cc),
                                               cfg.conv_dim**-0.5, dtype),
        "conv_b": torch.zeros((cc,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),  # A = -exp(A_log) = -1
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        **{f"norm.{k}": t for k, t in common.rmsnorm_init(d_in, dtype, dev).items()},
        "out_proj": common.dense_init(generator, d_in, d_model, dtype),
    }


def mamba2_shapes(d_model: int, cfg: SSMConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of ``mamba2_init``'s leaves, in its order, without drawing."""
    dims = mamba2_dims(d_model, cfg)
    d_in, h, cc = dims["d_inner"], dims["nheads"], dims["conv_channels"]
    d_proj = 2 * d_in + 2 * cfg.ngroups * cfg.state_dim + h
    return {"in_proj": (d_model, d_proj), "conv_w": (cfg.conv_dim, cc), "conv_b": (cc,),
            "dt_bias": (h,), "A_log": (h,), "D": (h,), "norm.scale": (d_in,),
            "out_proj": (d_in, d_model)}


def mamba2_state(d_model: int, cfg: SSMConfig, batch: int, dtype: torch.dtype,
                 device: torch.device) -> dict[str, torch.Tensor]:
    dims = mamba2_dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_dim - 1, dims["conv_channels"]), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, dims["nheads"], cfg.head_dim, cfg.state_dim),
                           dtype=torch.float32, device=device),
    }


def _mamba2_preproc(params, cfg: SSMConfig, x, conv_state, inplace: bool = False):
    """in_proj + causal depthwise conv; returns (z, xh, bm, cm, dt, new_conv_state).
    xh (B, L, H, P), bm and cm (B, L, G, N) are views of the convolution's
    output; dt (B, L, H) is float32.  ``inplace``: the new conv state is
    written into ``conv_state``, which is returned."""
    b, l, d_model = x.shape
    dims = mamba2_dims(d_model, cfg)
    d_in, h, p, n, g = dims["d_inner"], dims["nheads"], cfg.head_dim, cfg.state_dim, cfg.ngroups

    proj = x @ params["in_proj"]
    z, xbc, dt = torch.split(proj, [d_in, dims["conv_channels"], h], dim=-1)

    # causal depthwise conv over the sequence (kernel conv_dim); the new conv
    # state is copied out, so it does not hold the padded input alive
    xbc_pad = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    if cfg.conv_dim == 1:
        new_conv_state = conv_state
    elif inplace:
        new_conv_state = conv_state.copy_(xbc_pad[:, -(cfg.conv_dim - 1):])
    else:
        new_conv_state = xbc_pad[:, -(cfg.conv_dim - 1):].clone()
    conv = sum(xbc_pad[:, i:i + l] * params["conv_w"][i] for i in range(cfg.conv_dim))
    conv = conv + params["conv_b"]
    conv = torch.nn.functional.silu(conv.float()).to(x.dtype)

    xh = conv[..., :d_in].unflatten(-1, (h, p))
    bm = conv[..., d_in:d_in + g * n].unflatten(-1, (g, n))
    cm = conv[..., d_in + g * n:].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(dt.float() + params["dt_bias"])  # (B, L, H)
    return z, xh, bm, cm, dt, new_conv_state


def _mamba2_finish(params, z, y, x_dtype):
    y = y.float() * torch.nn.functional.silu(z.float())
    y = common.rmsnorm(common.sub(params, "norm."), y.to(x_dtype))
    return y @ params["out_proj"]


def mamba2_apply_scan(params, cfg: SSMConfig, x, state=None, *, inplace: bool = False):
    """Sequential oracle / decode path. x: (B, L, D). Returns (out, state);
    ``inplace``: ``state``'s tensors updated and returned."""
    b, l, d_model = x.shape
    if state is None:
        state = mamba2_state(d_model, cfg, b, x.dtype, x.device)
    z, xh, bm, cm, dt, conv_state = _mamba2_preproc(params, cfg, x, state["conv"], inplace)
    h = xh.shape[2]
    a = -torch.exp(params["A_log"].float())  # (H,)
    bm, cm = (ssd_ref.expand_groups(m, h).float() for m in (bm, cm))
    xf = xh.float()
    s = state["ssm"]
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * a)[..., None, None]  # (B, H, 1, 1)
        inject = (dt[:, t, :, None] * xf[:, t])[..., None] * bm[:, t, :, None, :]
        s = s.mul_(decay).add_(inject) if inplace else s * decay + inject
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cm[:, t]))
    y = torch.stack(ys, dim=1) + params["D"][:, None] * xf
    out = _mamba2_finish(params, z, y.reshape(b, l, -1), x.dtype)
    return out, {"conv": conv_state, "ssm": s}


def mamba2_apply_chunked(params, cfg: SSMConfig, x, state=None):
    """Chunk-parallel SSD through the ``ssd`` kernel's wrapper, from the
    carried state; a ragged last chunk is masked (the reference pads it with
    dt = 0, which leaves the state unchanged)."""
    b, l, d_model = x.shape
    if state is None:
        state = mamba2_state(d_model, cfg, b, x.dtype, x.device)
    z, xh, bm, cm, dt, conv_state = _mamba2_preproc(params, cfg, x, state["conv"])
    a = -torch.exp(params["A_log"].float())
    y, s_final = ssd_ops.ssd(xh, bm, cm, dt, a, state=state["ssm"], chunk=cfg.chunk)
    y = y + params["D"][:, None] * xh.float()
    out = _mamba2_finish(params, z, y.reshape(b, l, -1), x.dtype)
    return out, {"conv": conv_state, "ssm": s_final}


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

_TM_MIX_NAMES = ("r", "k", "v", "g", "w")


def rwkv6_init(
    generator: torch.Generator, d_model: int, d_ff: int, cfg: SSMConfig, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """One layer's parameters, drawn on the generator's device."""
    dev = generator.device
    d, r = d_model, cfg.lora_rank
    h = d // cfg.head_dim
    dense = lambda i, o: common.dense_init(generator, i, o, dtype)  # noqa: E731
    tn = lambda shape, scale, dt=dtype: common.truncated_normal_init(  # noqa: E731
        generator, shape, scale, dt)
    full = lambda shape, value, dt=dtype: torch.full(shape, value, dtype=dt, device=dev)  # noqa: E731
    tm = {
        **{f"ln.{k}": t for k, t in common.layernorm_init(d, dtype, dev).items()},
        "mu_base": full((d,), 0.5),
        "mix_mu": full((5, d), 0.5),  # r,k,v,g,w
        "mix_lora_a": dense(d, (5, r)),
        "mix_lora_b": tn((5, r, d), 0.01),
        "w_r": dense(d, d),
        "w_k": dense(d, d),
        "w_v": dense(d, d),
        "w_g": dense(d, d),
        "w_o": dense(d, d),
        "decay_base": full((d,), -4.0, torch.float32),  # w0: decay ~ exp(-exp(-4+dx))
        "decay_lora_a": dense(d, 2 * r),
        "decay_lora_b": tn((2 * r, d), 0.01),
        "bonus_u": tn((h, cfg.head_dim), 0.5, torch.float32),
        # per-head groupnorm folded to LN
        **{f"out_ln.{k}": t for k, t in common.layernorm_init(d, dtype, dev).items()},
    }
    cm = {
        **{f"ln.{k}": t for k, t in common.layernorm_init(d, dtype, dev).items()},
        "mu_k": full((d,), 0.5),
        "mu_r": full((d,), 0.5),
        "wk_ff": dense(d, d_ff),
        "wv_ff": dense(d_ff, d),
        "wr_gate": dense(d, d),
    }
    return {**{f"time_mix.{k}": t for k, t in tm.items()},
            **{f"channel_mix.{k}": t for k, t in cm.items()}}


def rwkv6_shapes(d_model: int, d_ff: int, cfg: SSMConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of ``rwkv6_init``'s leaves, in its order, without drawing."""
    d, r, hd = d_model, cfg.lora_rank, cfg.head_dim
    ln = {"ln.scale": (d,), "ln.bias": (d,)}
    tm = {**ln, "mu_base": (d,), "mix_mu": (5, d), "mix_lora_a": (d, 5, r),
          "mix_lora_b": (5, r, d), **{f"w_{n}": (d, d) for n in "rkvgo"},
          "decay_base": (d,), "decay_lora_a": (d, 2 * r), "decay_lora_b": (2 * r, d),
          "bonus_u": (d // hd, hd), "out_ln.scale": (d,), "out_ln.bias": (d,)}
    cm = {**ln, "mu_k": (d,), "mu_r": (d,), "wk_ff": (d, d_ff), "wv_ff": (d_ff, d),
          "wr_gate": (d, d)}
    return {**{f"time_mix.{k}": v for k, v in tm.items()},
            **{f"channel_mix.{k}": v for k, v in cm.items()}}


def rwkv6_state(
    d_model: int, cfg: SSMConfig, batch: int, dtype: torch.dtype, device: torch.device
) -> dict[str, torch.Tensor]:
    h = d_model // cfg.head_dim
    return {
        "tm_prev": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, cfg.head_dim, cfg.head_dim), dtype=torch.float32,
                           device=device),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """xx_t = x_{t-1}; xx_0 = prev (carried across calls). x: (B, L, D)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _tm_projections(tm: dict, x: torch.Tensor, prev: torch.Tensor):
    """Data-dependent token-shift mixing (ddlerp) + projections + decay."""
    b, l, d = x.shape
    xx = _token_shift(x, prev)
    sx = xx - x
    base = x + sx * tm["mu_base"]
    lora_a = tm["mix_lora_a"]  # (d, 5, r)
    lora_mid = torch.tanh((base @ lora_a.reshape(d, -1)).float()).view(b, l, *lora_a.shape[1:])
    lora_out = torch.einsum("blmr,mrd->blmd", lora_mid.to(x.dtype), tm["mix_lora_b"])
    mixed = {}
    for i, name in enumerate(_TM_MIX_NAMES):
        m = tm["mix_mu"][i] + lora_out[:, :, i]
        mixed[name] = x + sx * m
    r = mixed["r"] @ tm["w_r"]
    k = mixed["k"] @ tm["w_k"]
    v = mixed["v"] @ tm["w_v"]
    g = mixed["g"] @ tm["w_g"]
    dlo = torch.tanh((mixed["w"] @ tm["decay_lora_a"]).float())
    dw = dlo.to(x.dtype) @ tm["decay_lora_b"]
    # log-decay per channel: logd = -exp(w0 + dw)  (always negative)
    logd = -torch.exp(torch.clamp(tm["decay_base"] + dw.float(), -12.0, 4.0))
    return r, k, v, g, logd, x[:, -1]


def _heads(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, d // head_dim, head_dim)


def _tm_output(tm: dict, o: torch.Tensor, g: torch.Tensor, dtype: torch.dtype):
    b, l = o.shape[:2]
    o = common.layernorm(common.sub(tm, "out_ln."), o.reshape(b, l, -1).to(dtype))
    o = o * torch.nn.functional.silu(g.float()).to(dtype)
    return o @ tm["w_o"]


def rwkv6_time_mix_scan(tm: dict, cfg: SSMConfig, x, prev, wkv, *, inplace: bool = False):
    """Sequential WKV oracle / decode. Returns (out, new_prev, new_wkv);
    ``inplace``: ``wkv`` updated and returned as new_wkv."""
    r, k, v, g, logd, new_prev = _tm_projections(tm, x, prev)
    dk = cfg.head_dim
    rh, kh, vh = (_heads(t, dk).float() for t in (r, k, v))
    ld = _heads(logd, dk)
    u = tm["bonus_u"]  # (H, dk)
    s = wkv
    outs = []
    # unbind, not an index per token: its backward is one stack, where an
    # index's would write a full-length zero gradient for every token
    for rt, kt, vt, ldt in zip(*(t.unbind(1) for t in (rh, kh, vh, ld))):  # (B, H, dk)
        # o_t = r_t . (S_{t-1} + (u*k_t) v_t^T)
        ot = (rt.unsqueeze(-2) @ s).squeeze(-2) + (rt * u * kt).sum(-1, keepdim=True) * vt
        decay, kv = torch.exp(ldt).unsqueeze(-1), kt.unsqueeze(-1) * vt.unsqueeze(-2)
        s = s.mul_(decay).add_(kv) if inplace else decay * s + kv
        outs.append(ot)
    o = torch.stack(outs, dim=1)  # (B, L, H, dk)
    return _tm_output(tm, o, g, x.dtype), new_prev, s


def rwkv6_time_mix_chunked(tm: dict, cfg: SSMConfig, x, prev, wkv):
    """Chunk-parallel WKV through the ``wkv6`` kernel's wrapper, from the
    carried state; a ragged last chunk is masked (the reference pads it)."""
    q = min(cfg.chunk, x.shape[1])
    r, k, v, g, logd, new_prev = _tm_projections(tm, x, prev)
    dk = cfg.head_dim
    # r, k and v in the model's type: the kernel computes in float32 and
    # returns the output in r's type, which _tm_output would cast it to
    rh, kh, vh = (_heads(t, dk) for t in (r, k, v))
    o, wkv_final = wkv6_ops.wkv6(rh, kh, vh, _heads(logd, dk), tm["bonus_u"], state=wkv,
                                 chunk=q)
    return _tm_output(tm, o, g, x.dtype), new_prev, wkv_final


def rwkv6_channel_mix(cm: dict, x, prev):
    xx = _token_shift(x, prev)
    sx = xx - x
    xk = x + sx * cm["mu_k"]
    xr = x + sx * cm["mu_r"]
    k = xk @ cm["wk_ff"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ cm["wv_ff"]
    rg = torch.sigmoid((xr @ cm["wr_gate"]).float())
    return rg.to(x.dtype) * kv, x[:, -1]


def rwkv6_block_apply(params: dict, cfg: SSMConfig, x, state: dict, *, chunked: bool,
                      inplace: bool = False):
    """Full RWKV6 layer: time-mix + channel-mix with pre-LN residuals.
    ``inplace`` (the scan form only): ``state``'s tensors updated and returned."""
    tm, cm = common.sub(params, "time_mix."), common.sub(params, "channel_mix.")
    h_in = common.layernorm(common.sub(tm, "ln."), x)
    if chunked:
        o, tm_prev, wkv = rwkv6_time_mix_chunked(tm, cfg, h_in, state["tm_prev"], state["wkv"])
    else:
        o, tm_prev, wkv = rwkv6_time_mix_scan(tm, cfg, h_in, state["tm_prev"], state["wkv"],
                                              inplace=inplace)
    x = x + o
    c_in = common.layernorm(common.sub(cm, "ln."), x)
    o2, cm_prev = rwkv6_channel_mix(cm, c_in, state["cm_prev"])
    x = x + o2
    if inplace:
        state["tm_prev"].copy_(tm_prev)
        state["cm_prev"].copy_(cm_prev)
        return x, state
    return x, {"tm_prev": tm_prev, "cm_prev": cm_prev, "wkv": wkv}

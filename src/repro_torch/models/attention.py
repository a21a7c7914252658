"""Attention with KV caches (the port's ``repro.models.attention``): GQA
(full or sliding-window) and MLA (DeepSeek-V2's multi-head latent
attention).

Parameters are the reference's: ``w_q`` (D, H, dh), ``w_k`` and ``w_v``
(D, Kh, dh), ``w_o`` (H dh, D) and, with ``qkv_bias``, ``b_q`` / ``b_k`` /
``b_v``.  Every cache carries ``pos_ids``, the absolute position stored in
each slot (-1 = empty, int32 as in the reference).  Full-causal caches have
``cache_len = max_seq``; sliding-window caches are rings of ``cache_len =
window`` slots (write slot = pos % window).  ``cache_quant="int8"`` stores K
and V as int8 with a float16 absmax scale per (slot, head).

``gqa_apply`` has two paths, chosen by the caller:

- **Prefill** (``cache is None``, or ``prefill=True``: the T tokens at
  positions 0 .. T-1 written into an empty cache, which is how
  ``decoder_prefill`` calls it) attends through
  ``kernels.flash_attention.ops.gqa_flash_attention`` over the prompt's own
  rotated q, k and v, causal with ``cfg.sliding_window``: one kernel launch
  per layer on the card.  With an int8 cache it attends over the dequantized
  k and v, with q, in float32, as the reference attends over the dequantized
  cache.  The precondition (positions start at 0, the cache is empty) is
  checked on CPU tensors only, so a CUDA launch never waits on the host.
- **Cached** (a cache and ``prefill=False``: a decode step, or T > 1 tokens
  appended to a written cache, as a chunked prefill does) writes the tokens
  and runs the plain ``_attend`` over the whole cache, as the reference's
  einsum does; no kernel.

Under a sliding window the reference writes the whole prompt into the ring
and then attends over the ring, so a prompt longer than the window
overwrites early keys before early queries read them (ROADMAP.md §3).  Here
the prefill attends over the prompt with the kernel's window mask, which is
the reference's no-cache forward; and a write of T > cache_len positions
writes only the last cache_len of them (``index_put_`` with repeated slots
may keep any writer on CUDA), which leaves the ring the reference leaves.

Caches are updated functionally, as in the reference: the returned cache is
new and the one passed in is left as it was.  With ``inplace=True`` (the
scanned decode, ``launch.steps.make_decode_scan``, which owns its cache) the
new slots are written into the given buffers instead, and the returned cache
is the one passed in: the same values, without a copy of the cache.

MLA (``mla_apply``) caches the latent: ``c_kv`` (B, C, kv_lora_rank) and
``k_rope`` (B, C, qk_rope_dim), with ``pos_ids``.  Its parameters are the
reference's: ``w_dkv`` (D, lora + rope), ``kv_norm``, ``w_uk`` (lora, H,
nope), ``w_uv`` (lora, H, v), ``w_o`` (H v, D), and ``w_dq`` / ``q_norm`` /
``w_uq`` with a query rank (``w_q`` without).  No TPU kernel computes it:
the scores and the context are the reference's float32 einsums, in plain
PyTorch on the card too.  The expanded form re-expands K and V from the
latent; ``mla_absorb`` (with a cache) scores and reads in the latent space.
The prefill (``prefill=True``, or no cache) attends over the prompt's own
latents, as ``gqa_apply``'s prefill attends over the prompt's own k and v:
the reference attends over the whole cache after writing the prompt, whose
empty slots are masked out (the same values, summed over C = T slots here
instead of C = cache_len).  A write of T > cache_len positions keeps the
last cache_len, as in ``gqa_apply``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import common


def init(generator: torch.Generator, d_model: int, cfg: AttentionConfig,
         dtype: torch.dtype) -> dict[str, torch.Tensor]:
    if cfg.kind == "mla":
        return _mla_init(generator, d_model, cfg, dtype)
    return _gqa_init(generator, d_model, cfg, dtype)


def _gqa_init(generator: torch.Generator, d_model: int, cfg: AttentionConfig,
              dtype: torch.dtype) -> dict[str, torch.Tensor]:
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p = {
        "w_q": common.dense_init(generator, d_model, (h, dh), dtype),
        "w_k": common.dense_init(generator, d_model, (kh, dh), dtype),
        "w_v": common.dense_init(generator, d_model, (kh, dh), dtype),
        "w_o": common.dense_init(generator, h * dh, d_model, dtype),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((h, dh), dtype=dtype, device=dev)
        p["b_k"] = torch.zeros((kh, dh), dtype=dtype, device=dev)
        p["b_v"] = torch.zeros((kh, dh), dtype=dtype, device=dev)
    return p


def _mla_init(generator: torch.Generator, d_model: int, cfg: AttentionConfig,
              dtype: torch.dtype) -> dict[str, torch.Tensor]:
    h, dev = cfg.num_heads, generator.device
    nope, rope, vd, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    p = {
        "w_dkv": common.dense_init(generator, d_model, lora + rope, dtype),
        "kv_norm.scale": common.rmsnorm_init(lora, dtype, dev)["scale"],
        "w_uk": common.dense_init(generator, lora, (h, nope), dtype),
        "w_uv": common.dense_init(generator, lora, (h, vd), dtype),
        "w_o": common.dense_init(generator, h * vd, d_model, dtype),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = common.dense_init(generator, d_model, cfg.q_lora_rank, dtype)
        p["q_norm.scale"] = common.rmsnorm_init(cfg.q_lora_rank, dtype, dev)["scale"]
        p["w_uq"] = common.dense_init(generator, cfg.q_lora_rank, (h, nope + rope), dtype)
    else:
        p["w_q"] = common.dense_init(generator, d_model, (h, nope + rope), dtype)
    return p


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: AttentionConfig, batch: int, max_seq: int, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """Decode cache; a ring of ``window`` slots under a sliding window."""
    cache_len = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    pos_ids = torch.full((batch, cache_len), -1, dtype=torch.int32, device=device)
    if cfg.kind == "mla":
        return {
            "c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                                  device=device),
            "pos_ids": pos_ids,
        }
    kv_shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.cache_quant == "int8":
        return {
            "k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(kv_shape[:3], dtype=torch.float16, device=device),
            "v_scale": torch.zeros(kv_shape[:3], dtype=torch.float16, device=device),
            "pos_ids": pos_ids,
        }
    return {
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
        "pos_ids": pos_ids,
    }


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, Kh, D) -> (int8 values, float16 per-(token, head) scales)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()[..., None]


def cache_bytes(cfg: AttentionConfig, batch: int, max_seq: int, bytes_per_el: int = 2) -> int:
    cache_len = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    if cfg.kind == "mla":
        return batch * cache_len * (cfg.kv_lora_rank + cfg.qk_rope_dim) * bytes_per_el
    return batch * cache_len * 2 * cfg.num_kv_heads * cfg.head_dim * bytes_per_el


def _write_slots(cache_len: int, positions: torch.Tensor) -> torch.Tensor:
    """Ring-buffer slot for each absolute position (identity if the cache covers the sequence)."""
    return positions % cache_len


def _scatter_cache(buf: torch.Tensor, slots: torch.Tensor, values: torch.Tensor, *,
                   inplace: bool = False) -> torch.Tensor:
    """A copy of buf (B, C, ...) with values (B, T, ...) at slots (B, T);
    ``inplace``: buf itself, written there."""
    out = buf if inplace else buf.clone()
    bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
    out[bidx, slots] = values.to(buf.dtype)
    return out


def _write_cache(cache: dict, new: dict, *, inplace: bool = False) -> dict:
    """``new``'s (B, T, ...) leaves, ``pos_ids`` among them, written at their
    slots: a copy of each leaf of ``cache`` (``inplace``: the leaf itself).
    Of T > cache_len positions (a prompt longer than the ring) only the last
    cache_len are written: ``index_put_`` with repeated slots may keep any
    writer on CUDA."""
    cache_len = cache["pos_ids"].shape[1]
    if new["pos_ids"].shape[1] > cache_len:
        new = {name: a[:, -cache_len:] for name, a in new.items()}
    slots = _write_slots(cache_len, new["pos_ids"])
    return {name: _scatter_cache(cache[name], slots, new[name], inplace=inplace)
            for name in new}


# ---------------------------------------------------------------------------
# Core attend (decode)
# ---------------------------------------------------------------------------


def _attend(q, k, v, mask, scale):
    """q: (B, T, Kh, G, dh) grouped query; k/v: (B, C, Kh, dh); mask:
    (B, 1, 1, T, C) bool.  Float32 context (B, T, Kh, G, dh)."""
    scores = torch.einsum("btkgd,bckd->bkgtc", q.float(), k.float())
    scores = scores * scale + torch.where(mask, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgtc,bckd->btkgd", probs, v.float())


def _make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int | None) -> torch.Tensor:
    """(B, T, C) bool: causal, slot-valid, and optionally windowed."""
    m = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        m &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    return m


def _check_prefill(positions: torch.Tensor, cache: dict | None) -> None:
    """The prefill path's precondition, on CPU tensors only (a check of a
    CUDA tensor would make the host wait for the device)."""
    if positions.device.type != "cpu" or cache is None:
        return
    t = positions.shape[1]
    want = torch.arange(t, dtype=positions.dtype)
    if not bool((positions == want).all()) or not bool((cache["pos_ids"] == -1).all()):
        raise ValueError(
            "a prefill (prefill=True) writes positions 0 .. T-1 into an empty cache; "
            "append to a written cache with prefill=False"
        )


def project_qkv(params: dict, cfg: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, T, H, dh), k and v (B, T, Kh, dh): projected, biased, q and k rotated."""
    b, t, d_model = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["w_q"].reshape(d_model, h * dh)).view(b, t, h, dh)
    k = (x @ params["w_k"].reshape(d_model, kh * dh)).view(b, t, kh, dh)
    v = (x @ params["w_v"].reshape(d_model, kh * dh)).view(b, t, kh, dh)
    if "b_q" in params:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return (common.apply_rope(q, positions, cfg.rope_theta),
            common.apply_rope(k, positions, cfg.rope_theta), v)


def gqa_apply(
    params: dict,
    cfg: AttentionConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: dict | None = None,
    causal: bool = True,
    prefill: bool = False,
    inplace: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B, T, D); positions: (B, T) absolute.  Returns (out, new_cache).
    ``prefill``: the tokens are a whole prompt written into an empty cache
    (attended through the kernel); ignored without a cache.  ``inplace``:
    the tokens are written into the given cache, which is returned."""
    b, t, _ = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = project_qkv(params, cfg, x, positions)
    prefill = prefill or cache is None
    if prefill:
        _check_prefill(positions, cache)

    kk = vv = kv_pos = None
    if cache is not None:
        if "k_scale" in cache:  # int8-quantized cache
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            cache = _write_cache(cache, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
                                         "pos_ids": positions}, inplace=inplace)
            if prefill:  # the prompt's own k and v as the reference reads them back
                q = q.float()
                k = _dequantize_kv(*_quantize_kv(k))
                v = _dequantize_kv(*_quantize_kv(v))
            else:
                kk = _dequantize_kv(cache["k"], cache["k_scale"])
                vv = _dequantize_kv(cache["v"], cache["v_scale"])
        else:
            cache = _write_cache(cache, {"k": k, "v": v, "pos_ids": positions},
                                 inplace=inplace)
            kk, vv = cache["k"], cache["v"]
        kv_pos = cache["pos_ids"]

    if prefill:
        ctx = flash_ops.gqa_flash_attention(q, k, v, causal=causal,
                                            window=cfg.sliding_window if causal else None,
                                            scale=dh**-0.5)
    else:
        if causal:
            mask = _make_mask(positions, kv_pos, cfg.sliding_window)
        else:
            mask = (kv_pos[:, None, :] >= 0) & torch.ones((b, t, 1), dtype=torch.bool,
                                                           device=x.device)
        ctx = _attend(q.view(b, t, kh, h // kh, dh), kk, vv, mask[:, None, None], dh**-0.5)
    ctx = ctx.reshape(b, t, h * dh).to(x.dtype)
    return ctx @ params["w_o"], cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(params: dict, cfg: AttentionConfig, x: torch.Tensor,
           positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q_nope (B, T, H, nope) and the rotated q_rope (B, T, H, rope)."""
    b, t, d_model = x.shape
    width = cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    if cfg.q_lora_rank:
        cq = common.rmsnorm(common.sub(params, "q_norm."), x @ params["w_dq"])
        q = cq @ params["w_uq"].reshape(cfg.q_lora_rank, width)
    else:
        q = x @ params["w_q"].reshape(d_model, width)
    q = q.view(b, t, cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return (q[..., :cfg.qk_nope_dim],
            common.apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta))


def mla_apply(
    params: dict,
    cfg: AttentionConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: dict | None = None,
    prefill: bool = False,
    inplace: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B, T, D); positions: (B, T) absolute.  Returns (out, new_cache);
    ``prefill`` and ``inplace`` as in ``gqa_apply``."""
    b, t, _ = x.shape
    h, lora = cfg.num_heads, cfg.kv_lora_rank
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    dkv = x @ params["w_dkv"]
    c_kv = common.rmsnorm(common.sub(params, "kv_norm."), dkv[..., :lora])
    k_rope = common.apply_rope(dkv[..., lora:], positions, cfg.rope_theta)
    prefill = prefill or cache is None
    if prefill:
        _check_prefill(positions, cache)

    c_all, krope_all, kv_pos = c_kv, k_rope, positions
    if cache is not None:
        cache = _write_cache(cache, {"c_kv": c_kv, "k_rope": k_rope, "pos_ids": positions},
                             inplace=inplace)
        if not prefill:
            c_all, krope_all, kv_pos = cache["c_kv"], cache["k_rope"], cache["pos_ids"]

    bias = torch.where(_make_mask(positions, kv_pos, cfg.sliding_window)[:, None], 0.0,
                       NEG_INF)  # (B, 1, T, C)
    if cfg.mla_absorb and cache is not None:
        # absorbed: score and read in the latent space, never expanding K or V
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), params["w_uk"].float())
        scores = torch.einsum("bthr,bcr->bhtc", q_lat, c_all.float())
        scores += torch.einsum("bthp,bcp->bhtc", q_rope.float(), krope_all.float())
        probs = torch.softmax(scores.mul_(scale).add_(bias), dim=-1)
        ctx_lat = torch.einsum("bhtc,bcr->bthr", probs, c_all.float())
        ctx = torch.einsum("bthr,rhv->bthv", ctx_lat, params["w_uv"].float())
    else:
        # expanded: K and V re-expanded from the latent (model dtype)
        c = c_all.shape[1]
        k_nope = (c_all @ params["w_uk"].reshape(lora, h * nope)).view(b, c, h, nope)
        vv = (c_all @ params["w_uv"].reshape(lora, h * vd)).view(b, c, h, vd)
        scores = torch.einsum("bthn,bchn->bhtc", q_nope.float(), k_nope.float())
        scores += torch.einsum("bthp,bcp->bhtc", q_rope.float(), krope_all.float())
        probs = torch.softmax(scores.mul_(scale).add_(bias), dim=-1)
        ctx = torch.einsum("bhtc,bchv->bthv", probs, vv.float())
    ctx = ctx.reshape(b, t, h * vd).to(x.dtype)
    return ctx @ params["w_o"], cache


def apply(params, cfg: AttentionConfig, x, positions, *, cache=None, causal=True,
          prefill=False, inplace=False):
    if cfg.kind == "mla":  # causal always, as in the reference
        return mla_apply(params, cfg, x, positions, cache=cache, prefill=prefill,
                         inplace=inplace)
    return gqa_apply(params, cfg, x, positions, cache=cache, causal=causal, prefill=prefill,
                     inplace=inplace)

"""Model stacks of the port (the port's ``repro.models.transformer``: the
dense and MoE decoders, the RWKV6 stack and the zamba2 hybrid; the vlm and
encoder-decoder families are ROADMAP.md queue 1 item 16b).

Parameters are a flat dict with dotted names in the reference's tree
(``"embed"``, ``"layers.attn.w_q"``, ``"layers.moe.w_gate"``,
``"layers.time_mix.w_r"``, ``"lm_head"``, ...).  Layer-stacked leaves keep
the reference's leading (L, ...) axis, and the trunks loop over L on views
of them.  A MoE decoder's leading dense layers (``cfg.moe.first_dense_layers``,
DeepSeek-V2's layer 0, a dense MLP of ``dense_ff``) are their own stack,
``"first_layers."``, run before ``"layers."``.  The decoder's KV cache is a
dict of (L, ...) leaves under ``"main."`` (``"main.k"``, ``"main.v"``,
``"main.pos_ids"``; MLA's ``"main.c_kv"``, ``"main.k_rope"``; the
reference's ``{"main": {...}}``) and, with first layers, ``"first."``, the
RWKV6 recurrent state one of (L, ...) leaves (``"tm_prev"``, ``"cm_prev"``,
``"wkv"``), the hybrid's cache the Mamba2 states stacked over the layers
(``"mamba.conv"``, ``"mamba.ssm"``) and one attention cache per application
of the shared block (``"attn.k"``, ``"attn.v"``, ``"attn.pos_ids"``).  The
reference's ``cfg.remat`` (``jax.checkpoint`` around each block) trades
recomputation for activation memory in a backward pass; it has no
counterpart here: the one model the port trains (the sequence classifier of
``rwkv6_features``, ``models.registry``) is small.

Every prefill runs one hand-written kernel per layer: each GQA decoder
layer's and each shared-block application's attention through
``flash_attention`` (``models/attention.py``), each Mamba2 layer's SSD
through ``ssd`` (``models/ssm.py``); MLA and the MoE dispatch
(``models/moe.py``) have no TPU kernel in the reference and run in plain
PyTorch; decode steps attend over the cache and run the Mamba2 recurrence
in plain PyTorch.

``rwkv6_features`` (the trunk's hidden states) and ``rwkv6_loss_fn`` (the
language-model loss, its WKV through the forward-only ``wkv6`` kernel on
the card) serve training; the dense and hybrid losses are ROADMAP.md
queue 1 item 18.

Caches are updated functionally (each layer's new cache, then the stack of
them), as in the reference.  The decode steps also take ``inplace=True``
(the scanned decode, ``launch.steps.make_decode_scan``, which owns its
cache): every layer writes its new slot or state into its row of the
stacked buffers, and the step returns the cache it was given.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, moe, ssm

LAYERS = "layers."
FIRST_LAYERS = "first_layers."
MAIN_CACHE = "main."
FIRST_CACHE = "first."


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def stacked_init(n: int, init_one: Callable[[int], dict]) -> dict[str, torch.Tensor]:
    """``n`` draws of ``init_one(i)`` stacked along a new leading axis, each
    copied into the stacked leaves as it is drawn (one draw live at a time)."""
    first = init_one(0)
    out = {name: torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
           for name, t in first.items()}
    for i in range(n):
        one = first if i == 0 else init_one(i)
        for name, t in one.items():
            out[name][i].copy_(t)
        del one
    del first
    return out


def decoder_logits(params, cfg: ModelConfig, x):
    if "lm_head" in params:
        return common.unembed(params["lm_head"], x, transpose=False)
    return common.unembed(params["embed"], x, transpose=True)


# ===========================================================================
# Decoder block (dense MLP or MoE) and the decoder
# ===========================================================================


def _block_init(generator: torch.Generator, cfg: ModelConfig, *, use_moe: bool = False,
                dense_ff: int | None = None) -> dict[str, torch.Tensor]:
    """One decoder block: RMSNorm, attention (GQA or MLA), RMSNorm, then a
    SwiGLU MLP of ``dense_ff or d_ff`` or, with ``use_moe``, the experts."""
    dtype, dev = compute_dtype(cfg), generator.device
    p = {f"ln1.{k}": t for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()}
    p.update({f"attn.{k}": t
              for k, t in attention.init(generator, cfg.d_model, cfg.attention, dtype).items()})
    p.update({f"ln2.{k}": t for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()})
    if use_moe:
        p.update({f"moe.{k}": t
                  for k, t in moe.init(generator, cfg.d_model, cfg.moe, dtype).items()})
    else:
        p.update({f"mlp.{k}": t for k, t in common.mlp_init(
            generator, cfg.d_model, dense_ff or cfg.d_ff, dtype).items()})
    return p


def _block_apply(p, cfg: ModelConfig, x, positions, cache, *, prefill=False, inplace=False):
    """Returns (x, new_cache, aux): aux is the MoE load-balance loss, a
    float32 scalar tensor (the float 0.0 for a dense MLP: no device work in a
    dense decode step); ``prefill`` and ``inplace`` as in
    ``attention.gqa_apply``."""
    h, cache = attention.apply(common.sub(p, "attn."), cfg.attention,
                               common.rmsnorm(common.sub(p, "ln1."), x, cfg.norm_eps),
                               positions, cache=cache, prefill=prefill, inplace=inplace)
    x = x + h
    h2 = common.rmsnorm(common.sub(p, "ln2."), x, cfg.norm_eps)
    experts = common.sub(p, "moe.")
    if experts:
        h2, aux = moe.apply(experts, cfg.moe, h2, act=cfg.act)
    else:
        h2, aux = common.mlp_apply(common.sub(p, "mlp."), h2, act=cfg.act), 0.0
    return x + h2, cache, aux


def _num_first_layers(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe else 0


def decoder_init(generator: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The whole decoder's parameters, drawn on the generator's device; the
    layer-stacked leaves one layer's draw at a time."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            "the vlm projector and image prefix are not ported yet: ROADMAP.md queue 1 "
            "item 16b")
    dtype, dev = compute_dtype(cfg), generator.device
    n_first = _num_first_layers(cfg)
    p = {"embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
    if n_first:
        first = stacked_init(n_first, lambda _i: _block_init(
            generator, cfg, dense_ff=cfg.moe.dense_ff or cfg.d_ff))
        p.update({FIRST_LAYERS + name: t for name, t in first.items()})
    layers = stacked_init(cfg.num_layers - n_first,
                          lambda _i: _block_init(generator, cfg, use_moe=cfg.moe is not None))
    p.update({LAYERS + name: t for name, t in layers.items()})
    p.update({f"final_norm.{k}": t
              for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()})
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(generator, cfg.d_model, cfg.vocab_size, dtype)
    return p


def _decoder_embed(params, cfg: ModelConfig, tokens, patches=None):
    if patches is not None:
        raise NotImplementedError(
            "vlm image patches (the projector prefix) are not ported yet: "
            "ROADMAP.md queue 1 item 16b"
        )
    return common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))


def _decoder_trunk(params, cfg: ModelConfig, x, positions, caches, *, prefill=False,
                   inplace=False):
    """caches: the ``"first."`` and ``"main."`` leaves, each stacked over its
    layers, or None (no cache); ``prefill``: x is the whole prompt, written
    into empty caches; ``inplace``: each layer writes into its row of
    ``caches``.  The first layers run, then the main ones.  Returns (x after
    the final norm, new caches or None, the summed MoE aux loss: 0.0
    without MoE layers)."""
    aux = 0.0
    new_caches = {}
    for layer_prefix, cache_prefix in ((FIRST_LAYERS, FIRST_CACHE), (LAYERS, MAIN_CACHE)):
        layers = common.sub(params, layer_prefix)
        if not layers:
            continue
        stack = None if caches is None else common.sub(caches, cache_prefix)
        new = []
        for i in range(next(iter(layers.values())).shape[0]):
            x, c, a = _block_apply(common.row(layers, i), cfg, x, positions,
                                   None if stack is None else common.row(stack, i),
                                   prefill=prefill, inplace=inplace)
            aux = aux + a
            new.append(c)
        if caches is not None and not inplace:
            new_caches.update({cache_prefix + name: torch.stack([c[name] for c in new])
                               for name in stack})
    x = common.rmsnorm(common.sub(params, "final_norm."), x, cfg.norm_eps)
    if caches is None or inplace:
        return x, caches, aux
    return x, new_caches, aux


def decoder_loss_fn(params, cfg: ModelConfig, batch):
    raise NotImplementedError(
        "training the decoder language model (run_p2p_lm) is not ported yet: "
        "ROADMAP.md queue 1 item 18"
    )


def decoder_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                       device) -> dict[str, torch.Tensor]:
    """One attention cache per layer: the main layers' under ``"main."``, the
    first layers' (if any) under ``"first."``."""
    dtype, dev = compute_dtype(cfg), torch.device(device)
    n_first = _num_first_layers(cfg)

    def stack(n, prefix):
        caches = stacked_init(
            n, lambda _i: attention.init_cache(cfg.attention, batch, max_seq, dtype, dev))
        return {prefix + name: t for name, t in caches.items()}

    out = stack(cfg.num_layers - n_first, MAIN_CACHE)
    if n_first:
        out.update(stack(n_first, FIRST_CACHE))
    return out


def decoder_prefill(params, cfg: ModelConfig, batch, caches):
    x = _decoder_embed(params, cfg, batch["tokens"], batch.get("patches"))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, caches, _ = _decoder_trunk(params, cfg, x, positions, caches, prefill=True)
    return decoder_logits(params, cfg, x[:, -1:]), caches


def decoder_decode_step(params, cfg: ModelConfig, token, pos, caches, *, inplace=False):
    """token: (B,) int; pos: (B,) absolute position of this token."""
    x = _decoder_embed(params, cfg, token[:, None])
    x, caches, _ = _decoder_trunk(params, cfg, x, pos[:, None], caches, inplace=inplace)
    return decoder_logits(params, cfg, x), caches


# ===========================================================================
# RWKV6 stack
# ===========================================================================


def rwkv6_init_model(generator: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The whole model's parameters, drawn on the generator's device."""
    dtype = compute_dtype(cfg)
    dev = generator.device
    p = {"embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
    p.update({f"ln0.{k}": t for k, t in common.layernorm_init(cfg.d_model, dtype, dev).items()})
    layers = stacked_init(
        cfg.num_layers,
        lambda _i: ssm.rwkv6_init(generator, cfg.d_model, cfg.d_ff, cfg.ssm, dtype),
    )
    p.update({LAYERS + name: t for name, t in layers.items()})
    p.update({f"final_norm.{k}": t
              for k, t in common.layernorm_init(cfg.d_model, dtype, dev).items()})
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(generator, cfg.d_model, cfg.vocab_size, dtype)
    return p


def rwkv6_init_state(cfg: ModelConfig, batch: int, device) -> dict[str, torch.Tensor]:
    dtype = compute_dtype(cfg)
    return stacked_init(
        cfg.num_layers,
        lambda _i: ssm.rwkv6_state(cfg.d_model, cfg.ssm, batch, dtype, torch.device(device)),
    )


def _rwkv6_trunk(params, cfg: ModelConfig, x, states, *, chunked: bool, inplace: bool = False):
    layers = common.sub(params, LAYERS)
    new_states = []
    for i in range(cfg.num_layers):
        x, s = ssm.rwkv6_block_apply(common.row(layers, i), cfg.ssm, x, common.row(states, i),
                                     chunked=chunked, inplace=inplace)
        new_states.append(s)
    stacked = states if inplace else {
        name: torch.stack([s[name] for s in new_states]) for name in states}
    return common.layernorm(common.sub(params, "final_norm."), x, cfg.norm_eps), stacked


def rwkv6_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of ``rwkv6_init_model``'s leaves, in its order, without drawing."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab_size, d), "ln0.scale": (d,), "ln0.bias": (d,)}
    shapes.update({LAYERS + name: (cfg.num_layers, *shape)
                   for name, shape in ssm.rwkv6_shapes(d, cfg.d_ff, cfg.ssm).items()})
    shapes.update({"final_norm.scale": (d,), "final_norm.bias": (d,)})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def rwkv6_loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy of ``batch`` = {"tokens", "labels"}
    (B, S), over the chunked trunk from a zero state (the WKV through the
    ``wkv6`` kernel's wrapper: forward only on the card)."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = rwkv6_features(params, cfg, tokens, chunked=True)
    return common.cross_entropy_loss(decoder_logits(params, cfg, x), labels)


def rwkv6_features(params, cfg: ModelConfig, tokens, *, chunked: bool = True):
    """Trunk hidden states (B, S, D) for sequence-level heads (no unembed):
    embed, ln0, the layers from a zero recurrent state, the final norm.

    ``chunked=False`` runs the token-sequential recurrence
    (``ssm.rwkv6_time_mix_scan``, no kernel) instead of the chunked scan
    (``ssm.rwkv6_time_mix_chunked``, the ``wkv6`` kernel on the card): the
    same function, with O(B * D) live state and no (chunk, chunk)
    intermediates.  It updates no tensor in place, so ``torch.func.vmap``
    maps it over stacked peers (``registry.build_sequence_classifier``).
    """
    x = common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    x = common.layernorm(common.sub(params, "ln0."), x, cfg.norm_eps)
    states = rwkv6_init_state(cfg, tokens.shape[0], tokens.device)
    x, _ = _rwkv6_trunk(params, cfg, x, states, chunked=chunked)
    return x


def rwkv6_prefill(params, cfg: ModelConfig, batch, states):
    tokens = batch["tokens"]
    x = common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    x = common.layernorm(common.sub(params, "ln0."), x, cfg.norm_eps)
    x, states = _rwkv6_trunk(params, cfg, x, states, chunked=True)
    return decoder_logits(params, cfg, x[:, -1:]), states


def rwkv6_decode_step(params, cfg: ModelConfig, token, pos, states, *, inplace=False):
    del pos  # recurrent: position-free
    x = common.embed_lookup(params["embed"], token[:, None], compute_dtype(cfg))
    x = common.layernorm(common.sub(params, "ln0."), x, cfg.norm_eps)
    x, states = _rwkv6_trunk(params, cfg, x, states, chunked=False, inplace=inplace)
    return decoder_logits(params, cfg, x), states


# ===========================================================================
# Zamba2-style hybrid: Mamba2 backbone + weight-shared attention block
# ===========================================================================

MAMBA_CACHE = "mamba."
ATTN_CACHE = "attn."


def hybrid_init(generator: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The whole model's parameters, drawn on the generator's device."""
    dtype, dev = compute_dtype(cfg), generator.device

    def mamba_layer(_i):
        p = {f"ln.{k}": t for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()}
        p.update({f"mamba.{k}": t
                  for k, t in ssm.mamba2_init(generator, cfg.d_model, cfg.ssm, dtype).items()})
        return p

    p = {"embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
    p.update({LAYERS + name: t for name, t in stacked_init(cfg.num_layers, mamba_layer).items()})
    p.update({f"final_norm.{k}": t
              for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()})
    if cfg.shared_block_period:
        p["shared_proj"] = common.dense_init(generator, 2 * cfg.d_model, cfg.d_model, dtype)
        p.update({f"shared_block.{k}": t for k, t in _block_init(generator, cfg).items()})
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(generator, cfg.d_model, cfg.vocab_size, dtype)
    return p


def hybrid_num_shared_applications(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.shared_block_period if cfg.shared_block_period else 0


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict[str, torch.Tensor]:
    """Every layer's Mamba2 state and one attention cache per application of
    the shared block (one, unused, without a shared block), as the reference."""
    dtype, dev = compute_dtype(cfg), torch.device(device)
    mamba = stacked_init(cfg.num_layers,
                         lambda _i: ssm.mamba2_state(cfg.d_model, cfg.ssm, batch, dtype, dev))
    attn = stacked_init(max(hybrid_num_shared_applications(cfg), 1),
                        lambda _i: attention.init_cache(cfg.attention, batch, max_seq, dtype, dev))
    return {**{MAMBA_CACHE + k: t for k, t in mamba.items()},
            **{ATTN_CACHE + k: t for k, t in attn.items()}}


def _hybrid_layers(params, cfg: ModelConfig, x, positions, mamba_states, attn_caches, *,
                   chunked: bool, prefill: bool, inplace: bool = False):
    """The trunk shared by the cached and the cache-free forms: the Mamba2
    layers in groups of ``shared_block_period``, the shared block after each
    group on ``concat(h, embedding) @ shared_proj``.  ``attn_caches`` None
    runs the shared block without a cache.  Returns (x after the final norm,
    the new Mamba2 states stacked, the new attention caches stacked or None);
    ``inplace`` (decode) writes them into ``mamba_states`` and
    ``attn_caches`` and returns those."""
    period = cfg.shared_block_period
    groups = hybrid_num_shared_applications(cfg) if period else 1
    per = cfg.num_layers // groups
    mamba_fn = (ssm.mamba2_apply_chunked if chunked
                else functools.partial(ssm.mamba2_apply_scan, inplace=inplace))
    layers = common.sub(params, LAYERS)
    shared = common.sub(params, "shared_block.")
    x0 = x  # the embedding, concatenated into every shared-block input
    new_mamba, new_attn = [], []
    for gi in range(groups):
        for i in range(gi * per, (gi + 1) * per):
            lp = common.row(layers, i)
            o, s = mamba_fn(common.sub(lp, "mamba."), cfg.ssm,
                            common.rmsnorm(common.sub(lp, "ln."), x, cfg.norm_eps),
                            common.row(mamba_states, i))
            x = x + o
            new_mamba.append(s)
        cache = None if attn_caches is None else common.row(attn_caches, gi)
        if period:
            inp = torch.cat([x, x0], dim=-1) @ params["shared_proj"]
            out, cache, _ = _block_apply(shared, cfg, inp, positions, cache, prefill=prefill,
                                         inplace=inplace)
            x = x + out
        new_attn.append(cache)
    x = common.rmsnorm(common.sub(params, "final_norm."), x, cfg.norm_eps)
    if inplace:
        return x, mamba_states, attn_caches
    mamba = {name: torch.stack([s[name] for s in new_mamba]) for name in mamba_states}
    if attn_caches is None:
        return x, mamba, None
    return x, mamba, {name: torch.stack([c[name] for c in new_attn]) for name in attn_caches}


def _hybrid_trunk(params, cfg: ModelConfig, x, positions, cache, *, chunked: bool,
                  inplace: bool = False):
    """``chunked``: the prompt, written into empty caches (the SSD through the
    kernel, the shared block's attention through ``flash_attention``);
    otherwise decode steps (the Mamba2 recurrence, cached attention),
    ``inplace`` as in ``_hybrid_layers``."""
    x, mamba, attn = _hybrid_layers(params, cfg, x, positions, common.sub(cache, MAMBA_CACHE),
                                    common.sub(cache, ATTN_CACHE), chunked=chunked,
                                    prefill=chunked, inplace=inplace)
    return x, {**{MAMBA_CACHE + k: t for k, t in mamba.items()},
               **{ATTN_CACHE + k: t for k, t in attn.items()}}


def _hybrid_trunk_nocache(params, cfg: ModelConfig, x, positions, mamba_states):
    """The training / cache-free form: chunked Mamba2 layers from
    ``mamba_states`` (stacked over the layers), the shared block without an
    attention cache.  Returns (x after the final norm, new Mamba2 states)."""
    x, mamba, _ = _hybrid_layers(params, cfg, x, positions, mamba_states, None, chunked=True,
                                 prefill=True)
    return x, mamba


def hybrid_loss_fn(params, cfg: ModelConfig, batch):
    raise NotImplementedError(
        "training the hybrid language model is not ported yet: ROADMAP.md queue 1 item 18"
    )


def hybrid_prefill(params, cfg: ModelConfig, batch, cache):
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, cache = _hybrid_trunk(params, cfg, x, positions, cache, chunked=True)
    return decoder_logits(params, cfg, x[:, -1:]), cache


def hybrid_decode_step(params, cfg: ModelConfig, token, pos, cache, *, inplace=False):
    """token: (B,) int; pos: (B,) absolute position of this token."""
    x = common.embed_lookup(params["embed"], token[:, None], compute_dtype(cfg))
    x, cache = _hybrid_trunk(params, cfg, x, pos[:, None], cache, chunked=False,
                             inplace=inplace)
    return decoder_logits(params, cfg, x), cache

"""Model stacks of the port (the port's ``repro.models.transformer``: the
dense, MoE and vlm decoders, the RWKV6 stack, the zamba2 hybrid and the
encoder-decoder).

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
of the shared block (``"attn.k"``, ``"attn.v"``, ``"attn.pos_ids"``).  A vlm
decoder has a ``"projector"`` (frontend_dim, d_model) that maps the image
patches to a prefix of the text's embeddings.  The encoder-decoder keeps
``"enc_layers."`` and ``"dec_layers."`` (each decoder layer with
``"ln_cross."`` and ``"cross."``), and its cache is the decoder's
self-attention cache under ``"self."`` and the encoder's projected keys and
values, ``"cross_k"`` and ``"cross_v"`` (L, B, S_enc, Kh, dh), which the
prefill computes and every decode step reads.  The
reference's ``cfg.remat`` (``jax.checkpoint`` around each block) trades
recomputation for activation memory in a backward pass; it has no
counterpart here: the models the port trains keep every activation (the
sequence classifier of ``rwkv6_features`` is small; smollm-135m's LM round
at K = 4, batch 4, seq 1024 fits an 80 GB card, ``chip_smoke.py``).

Every prefill runs one hand-written kernel per layer: each GQA decoder
layer's and each shared-block application's attention through
``flash_attention`` (``models/attention.py``; the encoder's non-causal
self-attention too, one launch per encoder layer, and the encoder-decoder's
causal decoder self-attention; its cross-attention stays plain PyTorch, as
in the reference), each Mamba2 layer's SSD
through ``ssd`` (``models/ssm.py``); MLA and the MoE dispatch
(``models/moe.py``) have no TPU kernel in the reference and run in plain
PyTorch; decode steps attend over the cache and run the Mamba2 recurrence
in plain PyTorch.

``rwkv6_features`` (the trunk's hidden states) and ``rwkv6_loss_fn`` (the
language-model loss, its WKV through the ``wkv6`` kernel and its backward
kernel on the card) serve training, ``decoder_loss_fn`` trains the dense,
MoE and vlm decoders (its attention through ``flash_attention`` and its
backward kernel on the card) and ``hybrid_loss_fn`` the zamba2 hybrid (its
SSD through ``ssd`` and its backward kernel, the shared block's attention
through ``flash_attention``'s) and ``encdec_loss_fn`` the encoder-decoder
(the encoder's non-causal and the decoder's causal self-attention through
``flash_attention`` and its backward, the cross-attention plain PyTorch, as
in the reference).

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


# The leaves the layers keep float32 whatever the model's type, as the inits
# draw them (and the reference's): rwkv6's decay base and bonus, Mamba2's dt
# bias, A_log and D, a MoE layer's router; by the end of their names.
FLOAT32_LEAVES = (".time_mix.decay_base", ".time_mix.bonus_u", ".mamba.dt_bias",
                  ".mamba.A_log", ".mamba.D", ".moe.router")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtypes(cfg: ModelConfig, names) -> dict[str, torch.dtype]:
    """Each of the named leaves' type, as the family's init draws it: the
    model's type, float32 for ``FLOAT32_LEAVES``."""
    dtype = compute_dtype(cfg)
    return {name: torch.float32 if name.endswith(FLOAT32_LEAVES) else dtype for name in names}


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


def _block_apply(p, cfg: ModelConfig, x, positions, cache, *, prefill=False, inplace=False,
                 causal=True):
    """Returns (x, new_cache, aux): aux is the MoE load-balance loss, a
    float32 scalar tensor (the float 0.0 for a dense MLP: no device work in a
    dense decode step); ``prefill``, ``inplace`` and ``causal`` as in
    ``attention.gqa_apply``."""
    h, cache = attention.apply(common.sub(p, "attn."), cfg.attention,
                               common.rmsnorm(common.sub(p, "ln1."), x, cfg.norm_eps),
                               positions, cache=cache, causal=causal, prefill=prefill,
                               inplace=inplace)
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
    if cfg.family == "vlm":
        p["projector"] = common.dense_init(generator, cfg.frontend_dim, cfg.d_model, dtype)
    return p


def _decoder_embed(params, cfg: ModelConfig, tokens, patches=None):
    """The tokens' embeddings (B, S, D); vlm ``patches`` (B, Np, F) are
    projected in the model's dtype and put before them (B, Np + S, D)."""
    x = common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    if patches is not None:
        x = torch.cat([patches.to(x.dtype) @ params["projector"], x], dim=1)
    return x


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


def _block_shapes(cfg: ModelConfig, use_moe: bool = False,
                  dense_ff: int | None = None) -> dict[str, tuple[int, ...]]:
    """The shapes of ``_block_init``'s leaves, in its order."""
    d = cfg.d_model
    shapes = {"ln1.scale": (d,)}
    shapes.update({f"attn.{k}": s for k, s in attention.param_shapes(d, cfg.attention).items()})
    shapes["ln2.scale"] = (d,)
    if use_moe:
        shapes.update({f"moe.{k}": s for k, s in moe.param_shapes(d, cfg.moe).items()})
    else:
        shapes.update({f"mlp.{k}": s for k, s in common.mlp_shapes(
            d, dense_ff or cfg.d_ff).items()})
    return shapes


def decoder_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of ``decoder_init``'s leaves, in its order, without drawing."""
    d = cfg.d_model
    n_first = _num_first_layers(cfg)
    block = functools.partial(_block_shapes, cfg)
    shapes = {"embed": (cfg.vocab_size, d)}
    if n_first:
        shapes.update({FIRST_LAYERS + k: (n_first, *s) for k, s in block(
            False, cfg.moe.dense_ff or cfg.d_ff).items()})
    shapes.update({LAYERS + k: (cfg.num_layers - n_first, *s)
                   for k, s in block(cfg.moe is not None).items()})
    shapes["final_norm.scale"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    if cfg.family == "vlm":
        shapes["projector"] = (cfg.frontend_dim, d)
    return shapes


def decoder_loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy of ``batch`` = {"tokens", "labels"} (B,
    S) and, for a vlm, "patches" (B, Np, F) (the reference's
    ``decoder_loss_fn``): the embedding (the projected patches first), the
    trunk with no cache (each layer's attention through the
    ``flash_attention`` kernel, forward and backward, on the card), the loss
    over the text positions only; a MoE decoder adds ``router_aux_coef *
    aux / num_layers``."""
    tokens, labels = batch["tokens"], batch["labels"]
    patches = batch.get("patches")
    x = _decoder_embed(params, cfg, tokens, patches)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, _, aux = _decoder_trunk(params, cfg, x, positions, None)
    if patches is not None:
        x = x[:, patches.shape[1]:]  # loss over text positions only
    loss = common.cross_entropy_loss(decoder_logits(params, cfg, x), labels)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux / cfg.num_layers
    return loss


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
    ``wkv6`` kernel, forward and backward, on the card)."""
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


def hybrid_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of ``hybrid_init``'s leaves, in its order, without drawing."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab_size, d), LAYERS + "ln.scale": (cfg.num_layers, d)}
    shapes.update({LAYERS + "mamba." + name: (cfg.num_layers, *shape)
                   for name, shape in ssm.mamba2_shapes(d, cfg.ssm).items()})
    shapes["final_norm.scale"] = (d,)
    if cfg.shared_block_period:
        shapes["shared_proj"] = (2 * d, d)
        shapes["shared_block.ln1.scale"] = (d,)
        shapes.update({f"shared_block.attn.{k}": s
                       for k, s in attention.param_shapes(d, cfg.attention).items()})
        shapes["shared_block.ln2.scale"] = (d,)
        shapes.update({f"shared_block.mlp.{k}": s
                       for k, s in common.mlp_shapes(d, cfg.d_ff).items()})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def hybrid_loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy of ``batch`` = {"tokens", "labels"}
    (B, S) (the reference's ``hybrid_loss_fn``): the embedding, the trunk
    from zero Mamba2 states with no attention cache (each layer's SSD through
    the ``ssd`` kernel and each shared-block application's attention
    through ``flash_attention``, forward and backward, on the card), the
    logits."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    dtype = compute_dtype(cfg)
    x = common.embed_lookup(params["embed"], tokens, dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    states = stacked_init(cfg.num_layers, lambda _i: ssm.mamba2_state(
        cfg.d_model, cfg.ssm, b, dtype, tokens.device))
    x, _ = _hybrid_trunk_nocache(params, cfg, x, positions, states)
    return common.cross_entropy_loss(decoder_logits(params, cfg, x), labels)


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


# ===========================================================================
# Encoder-decoder (seamless-m4t backbone; the audio frontend a stub)
# ===========================================================================

ENC_LAYERS = "enc_layers."
DEC_LAYERS = "dec_layers."
SELF_CACHE = "self."


def encdec_init(generator: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The whole model's parameters, drawn on the generator's device: the
    frame projection, the encoder's blocks and norm, the embedding (tied to
    the unembedding), the decoder's blocks, each with a cross-attention, and
    the final norm."""
    dtype, dev = compute_dtype(cfg), generator.device

    def dec_layer(_i):
        p = _block_init(generator, cfg)
        p.update({f"ln_cross.{k}": t
                  for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()})
        p.update({f"cross.{k}": t
                  for k, t in attention.init(generator, cfg.d_model, cfg.attention, dtype).items()})
        return p

    p = {"frontend_proj": common.dense_init(generator, cfg.frontend_dim, cfg.d_model, dtype)}
    p.update({ENC_LAYERS + name: t for name, t in stacked_init(
        cfg.encoder_layers, lambda _i: _block_init(generator, cfg)).items()})
    p.update({f"enc_norm.{k}": t for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()})
    p["embed"] = common.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)
    p.update({DEC_LAYERS + name: t for name, t in stacked_init(cfg.num_layers, dec_layer).items()})
    p.update({f"final_norm.{k}": t
              for k, t in common.rmsnorm_init(cfg.d_model, dtype, dev).items()})
    return p


def encdec_encode(params, cfg: ModelConfig, frames):
    """frames (B, S, F) -> the encoder's output (B, S, D): each layer's
    self-attention non-causal over the frames (RoPE at frame positions), one
    ``flash_attention`` launch per layer on the card."""
    x = frames.to(compute_dtype(cfg)) @ params["frontend_proj"]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    layers = common.sub(params, ENC_LAYERS)
    for i in range(cfg.encoder_layers):
        x, _, _ = _block_apply(common.row(layers, i), cfg, x, positions, None, causal=False)
    return common.rmsnorm(common.sub(params, "enc_norm."), x, cfg.norm_eps)


def encdec_cross_kv(params, cfg: ModelConfig, enc_out):
    """Every decoder layer's cross-attention k and v of the encoder's
    output, stacked: two (L, B, S, Kh, dh) tensors."""
    layers = common.sub(params, DEC_LAYERS)
    kv = [attention.encoder_kv(common.sub(common.row(layers, i), "cross."), cfg.attention,
                               enc_out) for i in range(cfg.num_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def _encdec_dec_block(p, cfg: ModelConfig, x, positions, cache, enc_kv, *, prefill=False,
                      inplace=False):
    """Self-attention (cached; ``prefill`` and ``inplace`` as in
    ``attention.gqa_apply``), cross-attention over ``enc_kv``, the MLP.
    Returns (x, new_cache)."""
    h, cache = attention.apply(common.sub(p, "attn."), cfg.attention,
                               common.rmsnorm(common.sub(p, "ln1."), x, cfg.norm_eps),
                               positions, cache=cache, prefill=prefill, inplace=inplace)
    x = x + h
    x = x + attention.cross_attention_apply(
        common.sub(p, "cross."), cfg.attention,
        common.rmsnorm(common.sub(p, "ln_cross."), x, cfg.norm_eps), enc_kv)
    return x + common.mlp_apply(common.sub(p, "mlp."),
                                common.rmsnorm(common.sub(p, "ln2."), x, cfg.norm_eps),
                                act=cfg.act), cache


def _encdec_dec_trunk(params, cfg: ModelConfig, x, positions, caches, cross_kv, *,
                      prefill=False, inplace=False):
    """caches: the self-attention caches stacked over the layers, or None
    (no cache: the training loss); cross_kv: (cross_k, cross_v) stacked.
    Returns (x after the final norm, the new caches stacked; ``inplace`` or
    no cache: ``caches``, written)."""
    layers = common.sub(params, DEC_LAYERS)
    cross_k, cross_v = cross_kv
    new = []
    for i in range(cfg.num_layers):
        x, c = _encdec_dec_block(common.row(layers, i), cfg, x, positions,
                                 None if caches is None else common.row(caches, i),
                                 (cross_k[i], cross_v[i]), prefill=prefill, inplace=inplace)
        new.append(c)
    x = common.rmsnorm(common.sub(params, "final_norm."), x, cfg.norm_eps)
    if inplace or caches is None:
        return x, caches
    return x, {name: torch.stack([c[name] for c in new]) for name in caches}


def encdec_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of ``encdec_init``'s leaves, in its order, without drawing."""
    d = cfg.d_model
    shapes = {"frontend_proj": (cfg.frontend_dim, d)}
    shapes.update({ENC_LAYERS + k: (cfg.encoder_layers, *s)
                   for k, s in _block_shapes(cfg).items()})
    shapes["enc_norm.scale"] = (d,)
    shapes["embed"] = (cfg.vocab_size, d)
    dec = _block_shapes(cfg)
    dec["ln_cross.scale"] = (d,)
    dec.update({f"cross.{k}": s for k, s in attention.param_shapes(d, cfg.attention).items()})
    shapes.update({DEC_LAYERS + k: (cfg.num_layers, *s) for k, s in dec.items()})
    shapes["final_norm.scale"] = (d,)
    return shapes


def encdec_loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross entropy of the decoder over ``batch`` =
    {"frames" (B, S_enc, F), "tokens", "labels" (B, S)} (the reference's
    ``encdec_loss_fn``): the frames encoded (non-causal self-attention
    through ``flash_attention``), every decoder layer's cross k and v of
    the encoder's output, the decoder trunk with no cache (causal
    self-attention through ``flash_attention``, the cross-attention plain),
    the logits and the loss."""
    cross_kv = encdec_cross_kv(params, cfg, encdec_encode(params, cfg, batch["frames"]))
    x = common.embed_lookup(params["embed"], batch["tokens"], compute_dtype(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, _ = _encdec_dec_trunk(params, cfg, x, positions, None, cross_kv)
    return common.cross_entropy_loss(decoder_logits(params, cfg, x), batch["labels"])


def encdec_init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
                      device) -> dict[str, torch.Tensor]:
    """The decoder's self-attention caches of ``max_seq`` slots under
    ``"self."`` and zeroed cross k and v of ``enc_len`` frames (the prefill
    replaces them with the encoder's, as the reference does)."""
    dtype, dev, a = compute_dtype(cfg), torch.device(device), cfg.attention
    caches = stacked_init(cfg.num_layers,
                          lambda _i: attention.init_cache(a, batch, max_seq, dtype, dev))
    kv_shape = (cfg.num_layers, batch, enc_len, a.num_kv_heads, a.head_dim)
    return {**{SELF_CACHE + name: t for name, t in caches.items()},
            "cross_k": torch.zeros(kv_shape, dtype=dtype, device=dev),
            "cross_v": torch.zeros(kv_shape, dtype=dtype, device=dev)}


def encdec_prefill(params, cfg: ModelConfig, batch, caches):
    """Encode ``batch["frames"]``, then run the decoder over the prompt's
    tokens: the self-attention caches written, the cross k and v the new
    encoder output's."""
    cross_k, cross_v = encdec_cross_kv(params, cfg, encdec_encode(params, cfg, batch["frames"]))
    tokens = batch["tokens"]
    x = common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, self_c = _encdec_dec_trunk(params, cfg, x, positions, common.sub(caches, SELF_CACHE),
                                  (cross_k, cross_v), prefill=True)
    return decoder_logits(params, cfg, x[:, -1:]), {
        **{SELF_CACHE + name: t for name, t in self_c.items()},
        "cross_k": cross_k, "cross_v": cross_v}


def encdec_decode_step(params, cfg: ModelConfig, token, pos, caches, *, inplace=False):
    """token: (B,) int; pos: (B,) absolute decoder position of this token."""
    x = common.embed_lookup(params["embed"], token[:, None], compute_dtype(cfg))
    x, self_c = _encdec_dec_trunk(params, cfg, x, pos[:, None], common.sub(caches, SELF_CACHE),
                                  (caches["cross_k"], caches["cross_v"]), inplace=inplace)
    if inplace:
        return decoder_logits(params, cfg, x), caches
    return decoder_logits(params, cfg, x), {
        **{SELF_CACHE + name: t for name, t in self_c.items()},
        "cross_k": caches["cross_k"], "cross_v": caches["cross_v"]}

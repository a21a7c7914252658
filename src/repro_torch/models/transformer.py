"""Model stacks of the port (the port's ``repro.models.transformer``, its
RWKV6 stack; the decoder, hybrid and encoder-decoder families are ROADMAP.md
queue 1 item 16).

Parameters are a flat dict with dotted names in the reference's tree
(``"embed"``, ``"ln0.scale"``, ``"layers.time_mix.w_r"``, ``"lm_head"``, ...).
Layer-stacked leaves keep the reference's leading (L, ...) axis, and the
trunk loops over L on views of them; the recurrent state is a dict of
(L, ...) leaves (``"tm_prev"``, ``"cm_prev"``, ``"wkv"``).  The reference's
``cfg.remat`` (``jax.checkpoint`` around each block) saves activations for a
backward pass; this forward-only serving path keeps none, so it has no
counterpart here.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, ssm

LAYERS = "layers."


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


def _rwkv6_trunk(params, cfg: ModelConfig, x, states, *, chunked: bool):
    layers = common.sub(params, LAYERS)
    new_states = []
    for i in range(cfg.num_layers):
        x, s = ssm.rwkv6_block_apply(common.row(layers, i), cfg.ssm, x, common.row(states, i),
                                     chunked=chunked)
        new_states.append(s)
    stacked = {name: torch.stack([s[name] for s in new_states]) for name in states}
    return common.layernorm(common.sub(params, "final_norm."), x, cfg.norm_eps), stacked


def rwkv6_loss_fn(params, cfg: ModelConfig, batch):
    raise NotImplementedError(
        "training the RWKV6 language model is not ported yet: ROADMAP.md queue 1 item 14"
    )


def rwkv6_features(params, cfg: ModelConfig, tokens, *, chunked: bool = True):
    raise NotImplementedError(
        "rwkv6_features (the sequence classifier's trunk) is not ported yet: "
        "ROADMAP.md queue 1 item 14"
    )


def rwkv6_prefill(params, cfg: ModelConfig, batch, states):
    tokens = batch["tokens"]
    x = common.embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    x = common.layernorm(common.sub(params, "ln0."), x, cfg.norm_eps)
    x, states = _rwkv6_trunk(params, cfg, x, states, chunked=True)
    return decoder_logits(params, cfg, x[:, -1:]), states


def rwkv6_decode_step(params, cfg: ModelConfig, token, pos, states):
    del pos  # recurrent: position-free
    x = common.embed_lookup(params["embed"], token[:, None], compute_dtype(cfg))
    x = common.layernorm(common.sub(params, "ln0."), x, cfg.norm_eps)
    x, states = _rwkv6_trunk(params, cfg, x, states, chunked=False)
    return decoder_logits(params, cfg, x), states

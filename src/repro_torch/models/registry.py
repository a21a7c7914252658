"""A uniform Model interface from a ModelConfig (the port's
``repro.models.registry``, for the ``dense``, ``rwkv6`` and ``hybrid``
families; ``moe``, ``vlm`` and ``encdec`` are ROADMAP.md queue 1 item 16).

Every family exposes:
    init(generator) -> params                 (drawn on the generator's device)
    loss_fn(params, batch) -> scalar          (training: ROADMAP.md queue 1
                                               item 14 for rwkv6, item 18 for
                                               dense and hybrid)
    init_cache(batch, seq_len, device) -> cache
    prefill(params, batch, cache) -> (logits, cache)
    decode_step(params, token, pos, cache, *, inplace=False) -> (logits, cache)
                                              (``inplace``: the new slot or
                                               state written into ``cache``)
    make_batch(generator, batch, seq) -> {"tokens", "labels"} (B, S) int64

The reference's ``batch_specs`` (shape stand-ins for its XLA dry run) has no
counterpart here (ROADMAP.md queue 1 item 18).  Tokens are int64, torch's
index type; the reference's are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], dict]
    loss_fn: Callable[[dict, dict], torch.Tensor]
    init_cache: Callable[..., dict]
    prefill: Callable[[dict, dict, dict], tuple]
    decode_step: Callable[[dict, torch.Tensor, torch.Tensor, dict], tuple]
    make_batch: Callable[[torch.Generator, int, int], dict]


def _token_batch(generator: torch.Generator, cfg: ModelConfig, b: int, s: int) -> dict:
    def draw():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=generator,
                             device=generator.device)

    return {"tokens": draw(), "labels": draw()}


def build_sequence_classifier(cfg: ModelConfig, num_classes: int):
    raise NotImplementedError(
        "build_sequence_classifier (rwkv6_seqmnist) is not ported yet: ROADMAP.md queue 1 item 14"
    )


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return Model(
            cfg=cfg,
            init=lambda g: tf.decoder_init(g, cfg),
            loss_fn=lambda p, b: tf.decoder_loss_fn(p, cfg, b),
            init_cache=lambda b, s, device: tf.decoder_init_cache(cfg, b, s, device),
            prefill=lambda p, batch, c: tf.decoder_prefill(p, cfg, batch, c),
            decode_step=lambda p, t, pos, c, inplace=False: tf.decoder_decode_step(
                p, cfg, t, pos, c, inplace=inplace),
            make_batch=lambda g, b, s: _token_batch(g, cfg, b, s),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda g: tf.hybrid_init(g, cfg),
            loss_fn=lambda p, b: tf.hybrid_loss_fn(p, cfg, b),
            init_cache=lambda b, s, device: tf.hybrid_init_cache(cfg, b, s, device),
            prefill=lambda p, batch, c: tf.hybrid_prefill(p, cfg, batch, c),
            decode_step=lambda p, t, pos, c, inplace=False: tf.hybrid_decode_step(
                p, cfg, t, pos, c, inplace=inplace),
            make_batch=lambda g, b, s: _token_batch(g, cfg, b, s),
        )
    if cfg.family != "rwkv6":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: ROADMAP.md queue 1 item 16"
        )
    return Model(
        cfg=cfg,
        init=lambda g: tf.rwkv6_init_model(g, cfg),
        loss_fn=lambda p, b: tf.rwkv6_loss_fn(p, cfg, b),
        init_cache=lambda b, s, device: tf.rwkv6_init_state(cfg, b, device),
        prefill=lambda p, batch, c: tf.rwkv6_prefill(p, cfg, batch, c),
        decode_step=lambda p, t, pos, c, inplace=False: tf.rwkv6_decode_step(
            p, cfg, t, pos, c, inplace=inplace),
        make_batch=lambda g, b, s: _token_batch(g, cfg, b, s),
    )

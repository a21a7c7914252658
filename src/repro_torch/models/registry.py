"""A uniform Model interface from a ModelConfig (the port's
``repro.models.registry``, for the ``dense``, ``moe``, ``rwkv6`` and
``hybrid`` families; ``vlm`` and ``encdec`` are ROADMAP.md queue 1 item
16b).

Every family exposes:
    init(generator) -> params                 (drawn on the generator's device)
    loss_fn(params, batch) -> scalar          (training: rwkv6; dense, moe
                                               and hybrid are ROADMAP.md
                                               queue 1 item 18)
    init_cache(batch, seq_len, device) -> cache
    prefill(params, batch, cache) -> (logits, cache)
    decode_step(params, token, pos, cache, *, inplace=False) -> (logits, cache)
                                              (``inplace``: the new slot or
                                               state written into ``cache``)
    make_batch(generator, batch, seq) -> {"tokens", "labels"} (B, S) int64

The reference's ``batch_specs`` (shape stand-ins for its XLA dry run) has no
counterpart here (ROADMAP.md queue 1 item 18).  ``build_sequence_classifier``
gives one model's (init, apply, loss) for sequence classification
(``core.task``'s ``rwkv6_seqmnist``).  Tokens are int64, torch's
index type; the reference's are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
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


def sequence_classifier_shapes(cfg: ModelConfig, num_classes: int) -> dict[str, tuple[int, ...]]:
    """The shapes of ``build_sequence_classifier``'s leaves, in its init's
    order, without drawing: the trunk's, then ``cls_head.w`` and ``cls_head.b``."""
    return {**tf.rwkv6_param_shapes(cfg), "cls_head.w": (cfg.d_model, num_classes),
            "cls_head.b": (num_classes,)}


def build_sequence_classifier(cfg: ModelConfig, num_classes: int):
    """(init, apply, loss) for sequence classification on a registry family.

    ``apply(params, tokens (B, S) int) -> (B, num_classes) float32 logits``:
    the trunk run over the token sequence in RNN form, the final position's
    hidden state (the RNN's summary) through one float32 linear head.
    ``loss(params, (tokens, labels (B,) int))`` is the mean cross entropy.
    One model each; ``core.task`` maps them over stacked peers.

    rwkv6 only, as in the reference: a recurrent family has a natural "state
    after the whole sequence" readout.
    """
    if cfg.family != "rwkv6":
        raise ValueError(
            f"build_sequence_classifier supports family 'rwkv6', got {cfg.family!r}"
        )
    dtype = tf.compute_dtype(cfg)

    def init(generator: torch.Generator) -> dict[str, torch.Tensor]:
        params = tf.rwkv6_init_model(generator, cfg)
        params["cls_head.w"] = common.dense_init(generator, cfg.d_model, num_classes, dtype)
        params["cls_head.b"] = torch.zeros((num_classes,), dtype=dtype, device=generator.device)
        return params

    def apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        # RNN form (chunked=False): the token-sequential recurrence, which
        # reaches no kernel and updates nothing in place
        h = tf.rwkv6_features(params, cfg, tokens, chunked=False)[:, -1]  # (B, D)
        return h.float() @ params["cls_head.w"].float() + params["cls_head.b"].float()

    def loss(params: dict, batch) -> torch.Tensor:
        tokens, labels = batch
        return common.cross_entropy_loss(apply(params, tokens), labels)

    return init, apply, loss


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe"):  # one decoder: MoE blocks and first_layers by config
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
            f"model family {cfg.family!r} is not ported yet (the vlm prefix and the "
            "encoder-decoder family): ROADMAP.md queue 1 item 16b"
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

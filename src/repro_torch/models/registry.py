"""A uniform Model interface from a ModelConfig (the port's
``repro.models.registry``, for every family of the reference: ``dense``,
``moe``, ``vlm``, ``rwkv6``, ``hybrid`` and ``encdec``).

Every family exposes:
    init(generator) -> params                 (drawn on the generator's device)
    loss_fn(params, batch) -> scalar          (training, every family: the
                                               batch is ``make_batch``'s dict)
    init_cache(batch, seq_len, device) -> cache
    prefill(params, batch, cache) -> (logits, cache)
    decode_step(params, token, pos, cache, *, inplace=False) -> (logits, cache)
                                              (``inplace``: the new slot or
                                               state written into ``cache``)
    make_batch(generator, batch, seq) -> {"tokens", "labels"} (B, S) int64
                                              (vlm: S - Np tokens and float32
                                               ``patches`` (B, Np, F); encdec:
                                               S - S//4 tokens and float32
                                               ``frames`` (B, S//4, F), as
                                               ``split_vlm_seq`` and
                                               ``split_encdec_seq`` say)
    batch_specs(batch, seq) -> make_batch's dict of ``meta`` tensors
                                              (shape and type stand-ins, no
                                               data: the dry run's,
                                               ``launch.dryrun_lib``)

The encoder-decoder's ``init_cache(b, s, device)`` splits ``s`` as its
``make_batch`` does, as the reference does: a cache for ``prompt_len +
gen_tokens`` has ``s - max(s//4, 1)`` decoder slots, fewer than the
positions a decode reaches, so the last positions wrap onto the first
slots through the ``pos % cache_len`` ring (ROADMAP.md section 3).

``batch_specs`` is the counterpart of the reference's (its
``ShapeDtypeStruct`` stand-ins): the same keys and shapes, as meta tensors.
``build_sequence_classifier`` gives one model's (init, apply, loss) for
sequence classification (``core.task``'s ``rwkv6_seqmnist``).  Tokens are
int64, torch's index type; the reference's are int32.
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
    batch_specs: Callable[[int, int], dict]


def _token_batch(generator: torch.Generator, cfg: ModelConfig, b: int, s: int) -> dict:
    def draw():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=generator,
                             device=generator.device)

    return {"tokens": draw(), "labels": draw()}


def _token_specs(b: int, s: int) -> dict:
    def spec():
        return torch.empty((b, s), dtype=torch.int64, device="meta")

    return {"tokens": spec(), "labels": spec()}


def _vlm_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    np_, st = split_vlm_seq(cfg, s)
    return {**_token_specs(b, st),
            "patches": torch.empty((b, np_, cfg.frontend_dim), device="meta")}


def _encdec_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    enc, dec = split_encdec_seq(s)
    return {**_token_specs(b, dec),
            "frames": torch.empty((b, enc, cfg.frontend_dim), device="meta")}


def split_vlm_seq(cfg: ModelConfig, s: int) -> tuple[int, int]:
    """(prefix embeddings, text tokens) of a vlm sequence of length ``s``."""
    np_ = min(cfg.num_prefix_embeddings, max(s - 1, 1))
    return np_, s - np_


def split_encdec_seq(s: int) -> tuple[int, int]:
    """(encoder frames, decoder tokens) of an encoder-decoder sequence of length ``s``."""
    enc = max(s // 4, 1)
    return enc, max(s - enc, 1)


def _vlm_batch(generator: torch.Generator, cfg: ModelConfig, b: int, s: int) -> dict:
    np_, st = split_vlm_seq(cfg, s)
    out = _token_batch(generator, cfg, b, st)
    out["patches"] = torch.randn((b, np_, cfg.frontend_dim), generator=generator,
                                 device=generator.device)
    return out


def _encdec_batch(generator: torch.Generator, cfg: ModelConfig, b: int, s: int) -> dict:
    enc, dec = split_encdec_seq(s)
    out = _token_batch(generator, cfg, b, dec)
    out["frames"] = torch.randn((b, enc, cfg.frontend_dim), generator=generator,
                                device=generator.device)
    return out


def _encdec_init_cache(cfg: ModelConfig, b: int, s: int, device) -> dict:
    enc, dec = split_encdec_seq(s)
    return tf.encdec_init_cache(cfg, b, dec, enc, device)


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
    if cfg.family in ("dense", "moe", "vlm"):  # one decoder: MoE blocks, first_layers and
        # the vlm projector by config
        make_batch = _vlm_batch if cfg.family == "vlm" else _token_batch
        return Model(
            cfg=cfg,
            init=lambda g: tf.decoder_init(g, cfg),
            loss_fn=lambda p, b: tf.decoder_loss_fn(p, cfg, b),
            init_cache=lambda b, s, device: tf.decoder_init_cache(cfg, b, s, device),
            prefill=lambda p, batch, c: tf.decoder_prefill(p, cfg, batch, c),
            decode_step=lambda p, t, pos, c, inplace=False: tf.decoder_decode_step(
                p, cfg, t, pos, c, inplace=inplace),
            make_batch=lambda g, b, s: make_batch(g, cfg, b, s),
            batch_specs=lambda b, s: (_vlm_specs(cfg, b, s) if cfg.family == "vlm"
                                      else _token_specs(b, s)),
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
            batch_specs=_token_specs,
        )
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda g: tf.encdec_init(g, cfg),
            loss_fn=lambda p, b: tf.encdec_loss_fn(p, cfg, b),
            init_cache=lambda b, s, device: _encdec_init_cache(cfg, b, s, device),
            prefill=lambda p, batch, c: tf.encdec_prefill(p, cfg, batch, c),
            decode_step=lambda p, t, pos, c, inplace=False: tf.encdec_decode_step(
                p, cfg, t, pos, c, inplace=inplace),
            make_batch=lambda g, b, s: _encdec_batch(g, cfg, b, s),
            batch_specs=lambda b, s: _encdec_specs(cfg, b, s),
        )
    if cfg.family != "rwkv6":
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(
        cfg=cfg,
        init=lambda g: tf.rwkv6_init_model(g, cfg),
        loss_fn=lambda p, b: tf.rwkv6_loss_fn(p, cfg, b),
        init_cache=lambda b, s, device: tf.rwkv6_init_state(cfg, b, device),
        prefill=lambda p, batch, c: tf.rwkv6_prefill(p, cfg, batch, c),
        decode_step=lambda p, t, pos, c, inplace=False: tf.rwkv6_decode_step(
            p, cfg, t, pos, c, inplace=inplace),
        make_batch=lambda g, b, s: _token_batch(g, cfg, b, s),
        batch_specs=_token_specs,
    )

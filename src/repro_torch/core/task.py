"""TrainTask: what the P2P drivers need to train one model family (the port's
``repro.core.task``), chosen by name through ``P2PConfig.model``.

A task provides:

``param_shapes``
    Per-peer leaf shapes, in the order the flat parameter row stores them.
``init_params(generator) -> params``
    One peer's parameter dict, drawn on the CPU.
``loss_fn(stacked_params, batch) -> (K,) losses``
    Every peer's training loss on its own batch, in one batched pass.
``apply_fn(stacked_params, inputs) -> (K, N, C) logits``
    The eval head, every peer on one shared input set.
``make_peer_batches(parts, batch_size, *, seed) -> PeerBatcher``
``prepare_eval(x) -> inputs``
    Raw evaluation images in the model's input format (identity for the
    MLP; the pixel-stream tokens for sequence models).
``eval_batch_size``, ``eval_set_size``
    None: the whole test set in one apply.  An int caps the eval minibatch
    (a sequence trunk's intermediates grow with B * S * D), and subsamples
    the test set (a seeded permutation), as the reference does.
``dtype``
    The parameters' type, and so the flat buffer's (``p2p.ParamLayout``):
    float32, or bfloat16 for a bf16 model.
``param_dtypes``
    Each leaf's type where some differ from ``dtype`` (a bf16 model's
    float32 leaves, which ``p2p.ParamLayout`` keeps in a second, float32
    buffer), else None: every leaf of ``dtype``.
``init_on_device``
    Whether ``p2p.init_state`` draws the peers' parameters on the compute
    device (a registry model: 135 M parameters a peer take seconds on the
    CPU) rather than on the CPU.

``mnist_mlp`` is the paper's 2NN, written with the peer axis explicit.
``from_model`` makes a task of a registry language model
(``models.registry.build_model``: a decoder, rwkv6, the hybrid or the
encoder-decoder): its leaves, its init and its per-peer loss on the
registry's batch dict vmapped over the peers, with no eval head;
``launch.train.run_p2p_lm`` trains one.
``rwkv6_seqmnist`` is RWKV6 run as a recurrent network over the 196-token
pixel stream of sequential MNIST, classified from the final position
(``models.registry.build_sequence_classifier`` on
``seqmnist_model_config``); its stacked functions are ``torch.func.vmap``
of the one-model classifier over the peers, as the reference vmaps its
per-peer loss, so one backward of the summed losses gives each peer its own
gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data import pipeline
from repro_torch.models import mlp


@dataclasses.dataclass(frozen=True)
class TrainTask:
    """Everything the P2P drivers need to train one model family."""

    name: str
    param_shapes: dict[str, tuple[int, ...]]
    init_params: Callable[..., dict]
    loss_fn: Callable[[dict, Any], Any]
    apply_fn: Callable[[dict, Any], Any]
    make_peer_batches: Callable[..., Any]
    prepare_eval: Callable[[Any], Any]
    eval_batch_size: int | None = None
    eval_set_size: int | None = None
    description: str = ""
    dtype: torch.dtype = torch.float32
    init_on_device: bool = False
    param_dtypes: dict[str, torch.dtype] | None = None


_BUILDERS: dict[str, Callable[[], TrainTask]] = {}
_CACHE: dict[str, TrainTask] = {}


def register_task(name: str, builder: Callable[[], TrainTask]) -> None:
    """Register a lazy task builder (built once, on first ``get_task``)."""
    if name in _BUILDERS:
        raise ValueError(f"task {name!r} already registered")
    _BUILDERS[name] = builder


def task_names() -> tuple[str, ...]:
    """Registered task names (no tasks are built)."""
    return tuple(sorted(_BUILDERS))


def get_task(name: str) -> TrainTask:
    """Build (once) and return the named task."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown model {name!r}; one of {task_names()}")
    if name not in _CACHE:
        _CACHE[name] = _BUILDERS[name]()
    return _CACHE[name]


def _build_mnist_mlp() -> TrainTask:
    return TrainTask(
        name="mnist_mlp",
        param_shapes=mlp.param_shapes(),
        init_params=mlp.init_2nn,
        loss_fn=mlp.loss_2nn,
        apply_fn=mlp.apply_2nn,
        make_peer_batches=pipeline.PeerBatcher,
        prepare_eval=lambda x: x,
        description="the paper's 2NN MLP (784-200-200-10) on flat MNIST images",
    )


# 2x2-pooled 28x28 -> 14x14 = 196 intensity tokens an image; chunk 49 tiles
# the sequence exactly (4 chunks) where the chunked form runs
SEQMNIST_POOL = 2
SEQMNIST_BINS = 16
_SEQMNIST_SEQ_LEN = (28 // SEQMNIST_POOL) ** 2


def seqmnist_model_config():
    """The reduced RWKV6 config of the sequential-MNIST task (the reference's)."""
    from repro_torch.configs.base import ModelConfig, SSMConfig

    return ModelConfig(
        name="rwkv6-seqmnist",
        family="rwkv6",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=SEQMNIST_BINS,
        ssm=SSMConfig(kind="rwkv6", state_dim=16, head_dim=16, chunk=49, lora_rank=8),
        tie_embeddings=True,
        dtype="float32",
        remat=False,
    )


def _tokens_of(x) -> np.ndarray:
    """Eval images -> int64 pixel-stream tokens (torch's index type)."""
    return pipeline.images_to_tokens(x, num_bins=SEQMNIST_BINS,
                                     pool=SEQMNIST_POOL).astype(np.int64)


def _build_rwkv6_seqmnist() -> TrainTask:
    from repro_torch.models import registry

    cfg = seqmnist_model_config()
    init, apply, loss = registry.build_sequence_classifier(cfg, num_classes=10)
    # every peer its own parameters and batch; eval: one input set for all
    stacked_loss = torch.func.vmap(loss, in_dims=(0, (0, 0)))
    stacked_apply = torch.func.vmap(apply, in_dims=(0, None))

    def make_peer_batches(parts, batch_size, *, seed=0):
        return pipeline.TokenSequenceBatcher(parts, batch_size, seed=seed,
                                             num_bins=SEQMNIST_BINS, pool=SEQMNIST_POOL)

    return TrainTask(
        name="rwkv6_seqmnist",
        param_shapes=registry.sequence_classifier_shapes(cfg, num_classes=10),
        init_params=init,
        loss_fn=stacked_loss,
        apply_fn=stacked_apply,
        make_peer_batches=make_peer_batches,
        prepare_eval=_tokens_of,
        eval_batch_size=256,
        eval_set_size=512,
        description="RWKV6 (2 layers, d_model=64) as a recurrent net over the "
                    f"{_SEQMNIST_SEQ_LEN}-token pixel stream of sequential MNIST, "
                    "classified from the final state",
    )


def _no_eval(*_args):
    raise NotImplementedError("a language-model task has no eval head (run_p2p_lm reports "
                              "its training losses and the peers' drift)")


def from_model(model) -> TrainTask:
    """A task of a registry language model (``models.registry.Model``): its
    leaves (the family's ``*_param_shapes``, nothing drawn), its init, and
    its per-peer loss mapped over the peers by ``torch.func.vmap``, as the
    reference's ``make_round_fn(model.loss_fn)`` vmaps the model's loss; no
    eval head.  The dense, MoE and vlm decoders, rwkv6, the zamba2 hybrid
    and the encoder-decoder.

    A batch is the registry's dict (``Model.make_batch``'s keys), every leaf
    (K, B, ...): ``"tokens"`` and ``"labels"`` (B, S) int, a vlm's float32
    ``"patches"`` (B, Np, F), an encoder-decoder's float32 ``"frames"`` (B,
    S_enc, F); or ``(tokens, labels)``, the text-only batch, which a vlm
    trains without its image prefix and an encoder-decoder refuses.

    Each leaf keeps its init's type (``transformer.param_dtypes``): the
    model's, but float32 for a bf16 rwkv6's decay base and bonus, a bf16
    Mamba2 layer's ``dt_bias``, ``A_log`` and ``D`` and a bf16 MoE router,
    as the reference keeps them; the flat layout holds those in a float32
    block of their own (``p2p.ParamLayout``)."""
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    shapes_of = {"dense": tf.decoder_param_shapes, "moe": tf.decoder_param_shapes,
                 "vlm": tf.decoder_param_shapes, "rwkv6": tf.rwkv6_param_shapes,
                 "hybrid": tf.hybrid_param_shapes, "encdec": tf.encdec_param_shapes}
    if cfg.family not in shapes_of:
        raise ValueError(f"unknown family {cfg.family!r}; one of {sorted(shapes_of)}")
    dtype = tf.compute_dtype(cfg)
    shapes = shapes_of[cfg.family](cfg)
    types = tf.param_dtypes(cfg, shapes)

    def peer_loss(params, batch):
        if not isinstance(batch, dict):
            tokens, labels = batch
            batch = {"tokens": tokens, "labels": labels}
        return model.loss_fn(params, batch)

    return TrainTask(
        name=cfg.name,
        param_shapes=shapes,
        init_params=model.init,
        loss_fn=torch.func.vmap(peer_loss, in_dims=(0, 0)),
        apply_fn=_no_eval,
        make_peer_batches=_no_eval,
        prepare_eval=_no_eval,
        description=f"the {cfg.name} language model ({cfg.family}, {cfg.num_layers} layers, "
                    f"d_model={cfg.d_model}, {cfg.dtype})",
        dtype=dtype,
        init_on_device=True,
        param_dtypes=types if set(types.values()) != {dtype} else None,
    )


register_task("mnist_mlp", _build_mnist_mlp)
register_task("rwkv6_seqmnist", _build_rwkv6_seqmnist)

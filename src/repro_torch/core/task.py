"""TrainTask: what the P2P drivers need to train one model family (the port's
``repro.core.task``; ``mnist_mlp`` only — ``rwkv6_seqmnist`` is ROADMAP.md
queue 1 item 14).

A task provides:

``param_shapes``
    Per-peer leaf shapes, in the order the flat parameter row stores them.
``init_params(generator) -> params``
    One peer's parameter dict, drawn on the CPU.
``loss_fn(stacked_params, batch) -> (K,) losses``
    Every peer's training loss on its own batch, in one batched pass.
``apply_fn(stacked_params, inputs) -> (K, N, C) logits``
    The eval head.
``make_peer_batches(parts, batch_size, *, seed) -> PeerBatcher``
``prepare_eval(x) -> inputs``
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

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


def _build_mnist_mlp() -> TrainTask:
    return TrainTask(
        name="mnist_mlp",
        param_shapes=mlp.param_shapes(),
        init_params=mlp.init_2nn,
        loss_fn=mlp.loss_2nn,
        apply_fn=mlp.apply_2nn,
        make_peer_batches=pipeline.PeerBatcher,
        prepare_eval=lambda x: x,
    )


_BUILDERS: dict[str, Callable[[], TrainTask]] = {"mnist_mlp": _build_mnist_mlp}
# names the reference registers that this port does not run yet
UNPORTED_TASKS = ("rwkv6_seqmnist",)


def task_names() -> tuple[str, ...]:
    """Registered task names."""
    return tuple(sorted(_BUILDERS))


def get_task(name: str) -> TrainTask:
    """Build and return the named task."""
    if name in UNPORTED_TASKS:
        raise NotImplementedError(f"task {name!r} is not ported yet: ROADMAP.md queue 1 item 14")
    if name not in _BUILDERS:
        raise ValueError(f"unknown model {name!r}; one of {task_names()}")
    return _BUILDERS[name]()

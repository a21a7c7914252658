"""Optimizers over trees of tensors (the port's ``repro.optim``).

``sgd`` is the paper's PyTorch-default Polyak momentum,
``buf <- mu * buf + g;  w <- w - lr * buf``; ``adamw`` serves the language
models.  Each is an ``Optimizer(init, update)`` pair of plain functions over
any tree (``repro_torch.pytree``: the port's dicts of dotted names, nested
dicts, lists), with ``update(grads, state, params, step) -> (new_params,
new_state)``.  The state is float32 whatever the parameter's type, and
each update is computed in float32 and cast back to the parameter's type,
as the reference does; ``torch.optim`` would keep a bf16 parameter's state
in bf16.  ``step`` is an int or a 0-d tensor (on the parameters' device, or
on the CPU); the schedules take either.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import pytree

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], tuple[PyTree, PyTree]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step_f32(step) -> torch.Tensor:
    """``step`` as a float32 0-d tensor, on its own device (an int: the CPU,
    which an operation on a device tensor takes as a scalar)."""
    return torch.as_tensor(step).to(torch.float32)


def sgd(lr: float | Callable[[Any], Any], momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _s: lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return pytree.tree_map(_zeros_f32, params)

    def update(grads, state, params, step):
        eta = lr_fn(step)
        if momentum == 0.0:
            new = pytree.tree_map(lambda p, g: (_f32(p) - eta * _f32(g)).to(p.dtype), params, grads)
            return new, state
        buf = pytree.tree_map(lambda m, g: momentum * m + _f32(g), state, grads)
        new = pytree.tree_map(lambda p, m: (_f32(p) - eta * m).to(p.dtype), params, buf)
        return new, buf

    return Optimizer(init, update)


def adamw(
    lr: float | Callable[[Any], Any],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _s: lr)

    def init(params):
        return {"m": pytree.tree_map(_zeros_f32, params),
                "v": pytree.tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        t = _step_f32(step) + 1.0
        m = pytree.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * _f32(g), state["m"], grads)
        v = pytree.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(_f32(g)),
                            state["v"], grads)
        # bias corrections as float32 0-d tensors, as the reference's b ** t
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        eta = lr_fn(step)

        def upd(p, m_, v_):
            pf = _f32(p)
            step_ = (m_ / c1) / (torch.sqrt(v_ / c2) + eps) + weight_decay * pf
            return (pf - eta * step_).to(p.dtype)

        return pytree.tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def constant_schedule(lr: float):
    return lambda _step: lr


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total``; a float32 0-d tensor on the step's device."""
    def fn(step):
        s = _step_f32(step)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return fn


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(_f32(x))) for x in pytree.leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """``grads`` scaled by min(1, max_norm / global_norm), each leaf in its type."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: (_f32(g) * scale).to(g.dtype), grads)

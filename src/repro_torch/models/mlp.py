"""The paper's model: the 2NN MLP from McMahan et al. [9], Sec. V, with the K
peers written out as a batch dimension.

784 -> 200 -> 200 -> 10 with ReLU.  Parameters are a flat dict of named
leaves (``"fc1.w"``, ``"fc1.b"``, ...) in the reference's layout: ``w`` is
(fan_in, fan_out) and the forward is ``x @ w + b`` — not ``nn.Linear``'s
(out, in) — so parameters exported from ``repro.models.mlp`` load without a
transpose.  The functions below take the *stacked* form, every leaf with a
leading K axis, and run each layer as one batched matmul over the peers.
"""
from __future__ import annotations

import torch

LAYERS = ("fc1", "fc2", "out")


def _layer_dims(in_dim: int, hidden: int, num_classes: int):
    """(name, fan_in, fan_out) per layer."""
    return zip(LAYERS, (in_dim, hidden, hidden), (hidden, hidden, num_classes))


def param_shapes(
    *, in_dim: int = 784, hidden: int = 200, num_classes: int = 10
) -> dict[str, tuple[int, ...]]:
    """Per-peer leaf shapes, in the order the flat parameter row stores them."""
    shapes: dict[str, tuple[int, ...]] = {}
    for name, fan_in, fan_out in _layer_dims(in_dim, hidden, num_classes):
        shapes[f"{name}.w"] = (fan_in, fan_out)
        shapes[f"{name}.b"] = (fan_out,)
    return shapes


def init_2nn(
    generator: torch.Generator,
    *,
    in_dim: int = 784,
    hidden: int = 200,
    num_classes: int = 10,
) -> dict[str, torch.Tensor]:
    """One peer's parameters, PyTorch-default init: uniform +-1/sqrt(fan_in).

    Drawn on the CPU from ``generator`` (callers move them to the device).
    ``jax.random`` cannot be reproduced here, so parity tests feed exported
    reference parameters instead (``repro_torch.interop``).
    """
    out = {}
    for name, fan_in, fan_out in _layer_dims(in_dim, hidden, num_classes):
        bound = fan_in**-0.5
        for leaf, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,))):
            out[f"{name}.{leaf}"] = torch.empty(shape).uniform_(
                -bound, bound, generator=generator
            )
    return out


def apply_2nn(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Stacked forward: logits (K, N, 10).

    ``x`` is (K, N, 784) — each peer its own batch — or (N, 784), one input
    set shared by every peer (evaluation).
    """
    w1, b1 = params["fc1.w"], params["fc1.b"]
    if x.dim() == 2:
        # one (N, F) @ (F, K*H) product instead of K copies of the inputs
        h = torch.einsum("nf,kfh->knh", x, w1) + b1.unsqueeze(1)
    else:
        h = torch.baddbmm(b1.unsqueeze(1), x, w1)
    h = torch.relu(h)
    h = torch.relu(torch.baddbmm(params["fc2.b"].unsqueeze(1), h, params["fc2.w"]))
    return torch.baddbmm(params["out.b"].unsqueeze(1), h, params["out.w"])


def loss_2nn(params: dict[str, torch.Tensor], batch) -> torch.Tensor:
    """Per-peer mean cross-entropy, (K,).  batch = (images (K,B,784), labels (K,B))."""
    x, y = batch
    logp = torch.log_softmax(apply_2nn(params, x), dim=-1)
    return -logp.gather(-1, y.unsqueeze(-1)).squeeze(-1).mean(dim=-1)


def accuracy_2nn(params: dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-peer accuracy (K,) on a shared (N, 784) input set."""
    return (apply_2nn(params, x).argmax(-1) == y).float().mean(dim=-1)

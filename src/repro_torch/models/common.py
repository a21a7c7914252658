"""Shared layer primitives of the language models (the port's
``repro.models.common``, the parts the RWKV6 and dense decoder families need).

Parameters are flat dicts of tensors with dotted names in the reference's
layouts: a dense kernel is (in, out) and is applied as ``x @ w``; a norm is
``{"scale", "bias"}``.  ``sub(params, prefix)`` selects one module's leaves.
Norms, RoPE, the MLP's activation and the unembedding compute in float32,
as the reference does, and cast back to the input's type.

Initializers draw from an explicit ``torch.Generator`` on the device the
parameters live on: at 7.6 B parameters a draw on the CPU would take minutes.
``jax.random`` cannot be reproduced here, so parity tests load parameters
exported from the reference instead (``repro_torch.interop``).
"""
from __future__ import annotations

from typing import Sequence

import torch


def sub(params: dict[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """The leaves under ``prefix`` (``"time_mix."``), with the prefix removed."""
    n = len(prefix)
    return {name[n:]: value for name, value in params.items() if name.startswith(prefix)}


def row(tree: dict[str, torch.Tensor], i: int) -> dict[str, torch.Tensor]:
    """Views of index ``i`` of every leaf: layer ``i`` of layer-stacked
    leaves, or peer ``i`` of a stacked fleet (no copies)."""
    return {name: t[i] for name, t in tree.items()}


def truncated_normal_init(
    generator: torch.Generator, shape: Sequence[int], scale: float, dtype: torch.dtype
) -> torch.Tensor:
    """A normal truncated at +-2, drawn in float32 on the generator's device,
    times ``scale``, cast to ``dtype``."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out * scale).to(dtype)


def dense_init(
    generator: torch.Generator,
    in_dim: int,
    out_dims: Sequence[int] | int,
    dtype: torch.dtype,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Fan-in scaled init for a dense kernel (in_dim, *out_dims)."""
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    scale = scale if scale is not None else in_dim**-0.5
    return truncated_normal_init(generator, (in_dim, *out_dims), scale, dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype: torch.dtype):
    # dim**-0.5 keeps tied-unembedding logits O(1) at init.
    return truncated_normal_init(generator, (vocab, dim), dim**-0.5, dtype)


def layernorm_init(dim: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32, cast back to ``x``'s type."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis in float32, cast back to ``x``'s type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"].float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on split halves, in float32.  x: (..., S, H, D) or
    (..., S, D); positions: (..., S) integer."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # (D/2,)
    angles = positions.float()[..., None] * freqs  # (..., S, D/2)
    if x.dim() == angles.dim() + 1:  # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def act_fn(name: str):
    """The reference's activations (``jax.nn.gelu`` is the tanh form)."""
    return {
        "silu": torch.nn.functional.silu,
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "relu2": lambda x: torch.relu(x).square(),
    }[name]


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, *,
             gated: bool = True) -> dict[str, torch.Tensor]:
    p = {
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
    }
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    return p


def mlp_shapes(d_model: int, d_ff: int, *, gated: bool = True) -> dict[str, tuple[int, ...]]:
    """The shapes of ``mlp_init``'s leaves, in its order, without drawing."""
    shapes = {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
    if gated:
        shapes["w_gate"] = (d_model, d_ff)
    return shapes


def mlp_apply(params: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """SwiGLU when ``w_gate`` is present, a plain activation MLP otherwise;
    the activation runs in float32 and is cast back.  x: (B, S, D)."""
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = act_fn(act)((x @ params["w_gate"]).float()).to(x.dtype) * up
    else:
        h = act_fn(act)(up.float()).to(x.dtype)
    return h @ params["w_down"]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return table[tokens].to(compute_dtype)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *, transpose: bool) -> torch.Tensor:
    """Logits in f32. transpose=True when sharing the embedding table (V, D)."""
    head = table_or_head.float()
    return x.float() @ (head.T if transpose else head)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_id: int = -100) -> torch.Tensor:
    """Mean token cross entropy in float32, positions labelled ``ignore_id``
    left out (the mean over at least one position)."""
    logits = logits.float()
    mask = (labels != ignore_id).float()
    safe = torch.where(labels == ignore_id, torch.zeros_like(labels), labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)

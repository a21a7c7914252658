"""Serving steps built from a Model (the port's ``repro.launch.steps``, its
serving half).

``make_decode_loop`` is the counterpart of the reference's
``make_decode_scan``: the reference collapses the greedy decode into one
``lax.scan`` dispatch; PyTorch runs eagerly, so here it is a Python loop over
``make_serve_step``, the reference's ``decode_impl="python"`` baseline.  A
CUDA graph of the loop is later work (ROADMAP.md queue 1 item 17).  Everything
runs under ``torch.no_grad``: serving builds no autograd graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model


def make_prefill_step(model: Model) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        logits, cache = model.prefill(params, batch, cache)
        return torch.argmax(logits[:, -1], dim=-1), cache

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode step: greedy-sample the next token, update the cache."""

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, token, pos, cache)
        return torch.argmax(logits[:, -1], dim=-1), pos + 1, cache

    return serve_step


def prompt_dec_len(batch: dict) -> int:
    """Decoder-side length of a prompt batch: the position decode resumes at.

    vlm prefix embeddings (``patches``) occupy decoder cache slots ahead of
    the text tokens, so they advance the decode position; encoder inputs
    (encdec ``frames``) live in a separate cross-attention cache and do NOT.
    """
    n = batch["tokens"].shape[1]
    if "patches" in batch:
        n += batch["patches"].shape[1]
    return n


def make_decode_loop(model: Model, num_steps: int) -> Callable:
    """(params, cache, token, pos) -> (tokens (B, num_steps), cache).

    ``num_steps`` greedy decode steps in a Python loop.  ``num_steps == 0``
    is rejected: callers take the empty-decode path structurally (see
    ``make_generate_fn``).
    """
    if num_steps < 1:
        raise ValueError(
            f"make_decode_loop needs num_steps >= 1, got {num_steps}; a "
            "zero-step decode is the explicit empty-decode case — skip the "
            "loop entirely (make_generate_fn does this structurally)"
        )
    step = make_serve_step(model)

    def decode_loop(params, cache, token, pos):
        toks = []
        for _ in range(num_steps):
            token, pos, cache = step(params, cache, token, pos)
            toks.append(token)
        return torch.stack(toks, dim=1), cache

    return decode_loop


def make_generate_fn(model: Model, gen_tokens: int) -> Callable:
    """(params, batch, cache) -> (tokens (B, gen_tokens), cache).

    Prefill + greedy decode: the prefill argmax is the first generated
    token, the remaining ``gen_tokens - 1`` come from ``make_decode_loop``.
    ``gen_tokens == 1`` skips the loop STRUCTURALLY (prefill only — the
    explicit empty decode).
    """
    if gen_tokens < 1:
        raise ValueError(f"need gen_tokens >= 1, got {gen_tokens}")
    prefill = make_prefill_step(model)
    decode = make_decode_loop(model, gen_tokens - 1) if gen_tokens > 1 else None

    def generate(params, batch, cache):
        tok, cache = prefill(params, batch, cache)
        if decode is None:
            return tok[:, None], cache
        pos = torch.full(tok.shape, prompt_dec_len(batch), dtype=torch.int64, device=tok.device)
        toks, cache = decode(params, cache, tok, pos)
        return torch.cat([tok[:, None], toks], dim=1), cache

    return generate

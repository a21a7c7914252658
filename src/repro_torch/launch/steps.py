"""Serving steps built from a Model (the port's ``repro.launch.steps``, its
serving half).

``make_decode_scan`` is the counterpart of the reference's
``make_decode_scan``, which collapses the greedy decode into one
``lax.scan``: it captures ONE decode step as a CUDA graph over static
token, position and cache buffers (the cache written in place) and replays
it once per token (``repro_torch.capture``); on the CPU it runs the same
step eagerly.  ``make_generate_fn`` (prefill, then the scanned decode) uses
it, as the reference's does.  ``make_decode_loop`` is the
``decode_impl="python"`` baseline: a Python loop over ``make_serve_step``
with functional caches.  The two give the same tokens.  Everything runs
under ``torch.no_grad``: serving builds no autograd graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import capture as capture_lib
from repro_torch.models.registry import Model


def make_prefill_step(model: Model) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        logits, cache = model.prefill(params, batch, cache)
        return torch.argmax(logits[:, -1], dim=-1), cache

    return prefill_step


def make_serve_step(model: Model, *, inplace: bool = False) -> Callable:
    """One decode step: greedy-sample the next token, update the cache
    (``inplace``: write the given cache, as ``model.decode_step`` says)."""

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, token, pos, cache, inplace=inplace)
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


class DecodeScan:
    """(params, cache, token, pos) -> (tokens (B, num_steps), cache).

    ``num_steps`` greedy decode steps of one decode step written in place
    (``make_serve_step(model, inplace=True)``) over static buffers: a copy
    of ``token`` and ``pos``, and ``cache`` itself, which the call consumes
    (the reference donates it) and returns.  The first step runs eagerly as
    the warm-up; the step is then captured once per call (the parameters
    and the cache may sit elsewhere at every call) and replayed for the
    others, each token copied out after its replay.  On the CPU every step
    runs eagerly.  ``capture_seconds`` sums the warm-up and capture time of
    every call.
    """

    def __init__(self, model: Model, num_steps: int):
        if num_steps < 1:
            raise ValueError(
                f"make_decode_scan needs num_steps >= 1, got {num_steps}; a "
                "zero-step decode is the explicit empty-decode case — skip the "
                "scan entirely (make_generate_fn does this structurally)"
            )
        self.num_steps = num_steps
        self.step = make_serve_step(model, inplace=True)
        self.capture_seconds = 0.0

    @torch.no_grad()
    def capture_step(self, params, cache, token, pos) -> capture_lib.Captured:
        """One decode step over the static ``token``, ``pos`` and ``cache``,
        run once (the warm-up: one greedy step, token and position advanced
        in place) and captured; each ``replay()`` takes one more step."""

        def body():
            tok, nxt, _ = self.step(params, cache, token, pos)
            token.copy_(tok)
            pos.copy_(nxt)

        return capture_lib.capture(body, token.device)

    @torch.no_grad()
    def __call__(self, params, cache, token, pos):
        token, pos = token.clone(), pos.clone()
        out = token.new_empty((token.shape[0], self.num_steps))
        if self.num_steps == 1:
            tok, _, cache = self.step(params, cache, token, pos)
            out[:, 0] = tok
            return out, cache
        captured = self.capture_step(params, cache, token, pos)
        self.capture_seconds += captured.seconds
        out[:, 0] = token
        for i in range(1, self.num_steps):
            captured.replay()
            out[:, i] = token
        return out, cache


def make_decode_scan(model: Model, num_steps: int) -> DecodeScan:
    """The scanned greedy decode of ``num_steps`` tokens (``DecodeScan``)."""
    return DecodeScan(model, num_steps)


def make_generate_fn(model: Model, gen_tokens: int) -> Callable:
    """(params, batch, cache) -> (tokens (B, gen_tokens), cache).

    Prefill + scanned greedy decode: the prefill argmax is the first
    generated token, the remaining ``gen_tokens - 1`` come from
    ``make_decode_scan``, which consumes the prefill's cache.
    ``gen_tokens == 1`` skips the scan STRUCTURALLY (prefill only — the
    explicit empty decode).  The returned function's ``decode`` is the
    ``DecodeScan`` (None without one), whose ``capture_seconds`` add up.
    """
    if gen_tokens < 1:
        raise ValueError(f"need gen_tokens >= 1, got {gen_tokens}")
    prefill = make_prefill_step(model)
    decode = make_decode_scan(model, gen_tokens - 1) if gen_tokens > 1 else None

    def generate(params, batch, cache):
        tok, cache = prefill(params, batch, cache)
        if decode is None:
            return tok[:, None], cache
        pos = torch.full(tok.shape, prompt_dec_len(batch), dtype=torch.int64, device=tok.device)
        toks, cache = decode(params, cache, tok, pos)
        return torch.cat([tok[:, None], toks], dim=1), cache

    generate.decode = decode
    return generate

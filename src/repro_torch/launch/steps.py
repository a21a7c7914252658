"""Step functions built from a Model (the port's ``repro.launch.steps``).

Training: the paper's round at production scale is T calls of
``make_train_step``'s step on each peer (Eq. 3: gradient, optimizer update,
plus ``eta_d * d``), then one call of ``make_consensus_step``'s step on the
peer-stacked trees (Eq. 4 and the affinity d, through the ``consensus_mix``
kernel: one launch per leaf type).  ``make_consensus_step_psum`` is the
reference's one-reduction form for a uniform complete graph.
``make_multipod_train_step`` and ``make_multipod_serve_step`` are the
single-peer steps over a leading peer axis: the loss, the update and the
decode step under ``torch.func.vmap``, the gradient of the peers' summed
loss by autograd (the reference vmaps its steps with
``spmd_axis_name="pod"``, which only places the work; here the peers share
a device).

Serving: ``make_decode_scan`` is the counterpart of the reference's
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

import numpy as np
import torch

from repro_torch import capture as capture_lib
from repro_torch import pytree
from repro_torch.core import graph as graph_lib
from repro_torch.core import p2p
from repro_torch.kernels.consensus_mix import ops as cm_ops
from repro_torch.models.registry import Model
from repro_torch.optim import Optimizer


def _grads_and_loss(loss_fn: Callable, params) -> tuple[dict, torch.Tensor]:
    """``loss_fn(params)`` and the gradient of its sum by autograd: the
    kernels' backwards on the card (a ``torch.func`` transform of the
    gradient would hand their Functions' backwards tensors without storage,
    which a kernel launch cannot read).  A loss of K peers' stacked params
    (a vmapped loss) gives each peer its own gradient, as the peers share
    no parameter; a leaf the loss does not read gets zeros, as jax.grad."""
    live = {path: leaf.detach().requires_grad_(True)
            for path, leaf in pytree.leaves_with_path(params)}
    with torch.enable_grad():
        loss = loss_fn(pytree.map_with_path(lambda p, _: live[p], params))
        grads = dict(zip(live, torch.autograd.grad(loss.sum(), list(live.values()),
                                                   materialize_grads=True)))
    return pytree.map_with_path(lambda p, _: grads[p], params), loss.detach()


def _update(opt: Optimizer, eta_d: float) -> Callable:
    """(grads, opt_state, params, d_bias, step) -> (params, opt_state): one
    peer's ``opt.update``, then ``w + eta_d * d`` in float32, cast back to
    w's type (d not read when ``eta_d`` is 0)."""

    def update(grads, opt_state, params, d_bias, step):
        params, opt_state = opt.update(grads, opt_state, params, step)
        if eta_d:
            params = pytree.tree_map(
                lambda w, d: (w.to(torch.float32) + eta_d * d.to(torch.float32)).to(w.dtype),
                params, d_bias)
        return params, opt_state

    return update


def make_train_step(model: Model, opt: Optimizer, *, eta_d: float = 0.0) -> Callable:
    """(params, opt_state, d_bias, batch, step) -> (params, opt_state, loss).

    One peer's local step: the loss ``model.loss_fn(params, batch)`` and its
    gradient (``_grads_and_loss``), then ``_update``: ``opt.update`` and
    ``w + eta_d * d``.  ``params`` may be any tree of tensors (views of a
    stacked buffer too); the step returns fresh tensors and leaves its
    inputs as they are.  ``d_bias`` is not read when ``eta_d`` is 0."""
    update = _update(opt, eta_d)

    def train_step(params, opt_state, d_bias, batch, step):
        grads, loss = _grads_and_loss(lambda p: model.loss_fn(p, batch), params)
        params, opt_state = update(grads, opt_state, params, d_bias, step)
        return params, opt_state, loss

    return train_step


def make_multipod_train_step(model: Model, opt: Optimizer, *, eta_d: float = 0.0) -> Callable:
    """(params, opt_state, d_bias, batch, step) -> (params, opt_state, loss
    (K,)), every tree with a leading peer axis K (``step`` shared):
    ``make_train_step``'s step over the peers, its loss and its ``_update``
    under ``torch.func.vmap`` and the gradient of the K losses' sum by
    autograd, as the reference's ``jax.vmap`` of the single-peer step
    computes it.  ``d_bias`` is not read when ``eta_d`` is 0 (None will do)."""
    loss_fn = torch.func.vmap(model.loss_fn)
    update = torch.func.vmap(_update(opt, eta_d), in_dims=(0, 0, 0, 0 if eta_d else None, None))

    def multipod_train_step(params, opt_state, d_bias, batch, step):
        grads, losses = _grads_and_loss(lambda p: loss_fn(p, batch), params)
        params, opt_state = update(grads, opt_state, params, d_bias, step)
        return params, opt_state, losses

    return multipod_train_step


def make_consensus_step(
    w_mat: np.ndarray,
    beta_mat: np.ndarray,
    *,
    local_steps: int,
    use_affinity: bool,
) -> Callable:
    """Stacked-peer gossip: (stacked_params, d_bias) -> (mixed_params, new_d).

    The trees' leaves carry a leading K (peer) axis.  The leaves of each type
    are flattened into one (K, row) buffer (float32 or bf16;
    ``p2p.ParamLayout.block``, as the runtime lays out a mixed task's
    blocks) and mixed by one ``consensus_mix`` launch, which gives W x and
    the affinity d = (Beta x - x) / T together, summed in float32.  The
    dense (K, K) W and Beta become sparse operands here, once, and are
    uploaded on the device of the first call.  Mixed leaves come back in
    their own type; d comes back float32 (the reference's type: it does
    not cast d back), its values those of the kernel, which rounds a bf16
    block's d once (the reference rounds the Beta-average to bf16 before
    it subtracts x; ROADMAP.md section 3).  A peer with no affinity
    neighbor (a zero Beta row) gets d = 0, as in the runtime, where the
    reference's dense form gives -x / T.  Without ``use_affinity`` d_bias
    is returned as given."""
    sparse = graph_lib.SparseSchedule.from_dense(np.asarray(w_mat)[None],
                                                 np.asarray(beta_mat)[None])
    uploaded: dict[torch.device, cm_ops.SparseOperands] = {}

    def consensus_step(stacked_params, d_bias):
        paths = pytree.leaves_with_path(stacked_params)
        dev = paths[0][1].device
        if dev not in uploaded:
            uploaded[dev] = cm_ops.select_round(cm_ops.upload_schedule(sparse, dev), 0)
        blocks: dict[torch.dtype, dict] = {}
        for p, leaf in paths:
            blocks.setdefault(leaf.dtype, {})[p] = leaf
        mixed, d = {}, {}
        for dtype, leaves in blocks.items():  # one buffer and one launch a leaf type
            layout = p2p.ParamLayout.block({p: tuple(v.shape[1:]) for p, v in leaves.items()},
                                           dtype)
            mixed_flat, d_flat = cm_ops.consensus_mix_stacked(layout.flatten(leaves),
                                                              uploaded[dev], local_steps)
            mixed.update(layout.views(mixed_flat))
            d.update((p, v.to(torch.float32)) for p, v in layout.views(d_flat).items())
        mixed_tree = pytree.map_with_path(lambda p, _: mixed[p], stacked_params)
        if use_affinity:
            d_bias = pytree.map_with_path(lambda p, _: d[p], stacked_params)
        return mixed_tree, d_bias

    return consensus_step


def make_consensus_step_psum(
    num_peers: int,
    *,
    self_weight: float,
    peer_weight: float,
    local_steps: int,
    use_affinity: bool,
) -> Callable:
    """Gossip on a uniform complete graph from one peer-axis reduction:

        out_k = a x_k + b sum_{j != k} x_j = (a - b) x_k + b S,   S = sum_k x_k
        d_k   = ((S - x_k) / (K - 1) - x_k) / T                   (uniform Beta)

    in float32, each cast back to the leaf's type, d too (the reference's
    formula; plain torch, as the reference computes it outside any
    kernel)."""

    def consensus_step(stacked_params, d_bias):
        out = {}
        for p, x in pytree.leaves_with_path(stacked_params):
            xf = x.to(torch.float32)
            s = torch.sum(xf, dim=0, keepdim=True)
            mixed = ((self_weight - peer_weight) * xf + peer_weight * s).to(x.dtype)
            nbr_avg = (s - xf) / max(num_peers - 1, 1)
            out[p] = mixed, ((nbr_avg - xf) / local_steps).to(x.dtype)
        mixed = pytree.map_with_path(lambda p, _: out[p][0], stacked_params)
        if use_affinity:
            d_bias = pytree.map_with_path(lambda p, _: out[p][1], stacked_params)
        return mixed, d_bias

    return consensus_step


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


def make_multipod_serve_step(model: Model) -> Callable:
    """(params, cache, token, pos) -> (next token, pos + 1, cache), each
    with a leading peer axis: ``make_serve_step``'s step (functional cache)
    under ``torch.func.vmap``."""
    return torch.func.vmap(make_serve_step(model), in_dims=(0, 0, 0, 0))


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

"""Mixture-of-Experts with grouped-capacity dispatch (the port's
``repro.models.moe``).

The reference's semantics, step for step:

- tokens split into G routing groups (``_num_groups``: the gcd of
  ``router_groups`` and the token count); every expert takes at most C
  tokens a group (``capacity``: rounded up to a multiple of 8, at least 8);
- router logits, softmax and top-k in float32, the top-k gates renormalised;
- the Switch load-balance aux loss ``E * mean_g sum_e f_e / k * P_e``;
- assignments flattened token-major, choice-minor; an assignment's position
  is the exclusive running count of its expert; ``pos >= C`` drops it;
- three grouped (G, E, C, D) expert products, ``act(h_gate.float())`` cast
  to the model dtype times ``h_up``;
- each slot's output scaled by its gate cast to the model dtype, then the
  combine in the model dtype and the shared expert added after.

Where the port departs in form (not in value):

- **Top-k ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  ``_top_k`` takes the first k of
  a stable descending sort, which keeps index order among ties (a router
  of zeros makes every entry tie).
- **Slot table.** The reference's ``.at[dest].set`` writes duplicates only
  at the overflow slot ``E*C``, which it drops; ``scatter_`` may leave any
  of them there.  Kept slots are unique, so what is kept is exact.
- **A deterministic combine.** The reference scatter-adds slot outputs into
  their tokens.  On CUDA ``index_add_`` / ``scatter_add_`` use atomics whose
  order changes from run to run, which would break the bit equality of the
  python and the scanned decodes.  Here each token gathers its ``top_k``
  slots in choice order (a dropped choice reads a zero row) and sums them
  one add at a time in the model dtype, as the reference's bf16
  scatter-add does (in slot order there: allclose, not bitwise, in bf16).
- **Nothing that stops a CUDA graph.** G and C are Python ints from
  shapes; no ``.item()``, ``nonzero`` or boolean-mask indexing, so the
  scanned decode captures the layer.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import common


def init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
         dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The router (float32, (D, E)), the experts' gate / up (E, D, F) and down
    (E, F, D) kernels, and the shared experts' SwiGLU under ``shared.``."""
    e, f = cfg.num_experts, cfg.expert_ff
    p = {
        "router": common.dense_init(generator, d_model, e, torch.float32),
        "w_gate": common.truncated_normal_init(generator, (e, d_model, f), d_model**-0.5, dtype),
        "w_up": common.truncated_normal_init(generator, (e, d_model, f), d_model**-0.5, dtype),
        "w_down": common.truncated_normal_init(generator, (e, f, d_model), f**-0.5, dtype),
    }
    if cfg.num_shared:
        p.update({f"shared.{k}": t for k, t in common.mlp_init(
            generator, d_model, cfg.num_shared * f, dtype, gated=True).items()})
    return p


def _num_groups(cfg: MoEConfig, n_tokens: int) -> int:
    return math.gcd(max(1, cfg.router_groups), n_tokens)


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    c = math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _route(router: torch.Tensor, x: torch.Tensor, k: int):
    """Float32 logits, softmax and renormalised top-k gates of x (..., D)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    gates, experts = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def _aux_loss(probs: torch.Tensor, experts: torch.Tensor, e: int, k: int) -> torch.Tensor:
    """Switch load balance over routing groups: probs (G, Ng, E), experts
    (G, Ng, K) -> ``E * mean_g sum_e f_e / k * P_e`` (float32 scalar)."""
    f_e = torch.nn.functional.one_hot(experts, e).float().sum(dim=(1, 2)) / probs.shape[1]
    return e * torch.mean(torch.sum(f_e / k * probs.mean(dim=1), dim=-1))


def _experts(params: dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The grouped SwiGLU products over xe (E, M, D) -> (E, M, D)."""
    h_gate = torch.bmm(xe, params["w_gate"])
    h_up = torch.bmm(xe, params["w_up"])
    h = common.act_fn(act)(h_gate.float()).to(xe.dtype) * h_up
    return torch.bmm(h, params["w_down"])


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Row gather per group: table (G, R, D), index (G, M) -> (G, M, D)."""
    g, r, d = table.shape
    offsets = torch.arange(g, device=index.device)[:, None] * r
    return table.reshape(g * r, d).index_select(0, (index + offsets).reshape(-1)).view(
        g, -1, d)


def _slots(experts: torch.Tensor, e: int, c: int) -> torch.Tensor:
    """Each assignment's slot: experts (G, Ng, K) -> dest (G, Ng K), flattened
    token-major, choice-minor; slot ``expert * C + pos`` with pos the
    exclusive running count of its expert, ``E * C`` (dropped) when pos >= C."""
    flat_e = experts.reshape(experts.shape[0], -1)
    # (G, E, A) with the assignments innermost: a scan along the last axis
    # (along the middle one a prefill's took 8 ms on the card)
    onehot = (flat_e[:, None, :] == torch.arange(e, device=flat_e.device)[:, None]).int()
    pos_in_e = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot  # exclusive count
    pos = torch.gather(pos_in_e, 1, flat_e[:, None, :])[:, 0].long()
    return torch.where(pos < c, flat_e * c + pos, e * c)


def dropped_share(params: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """The share of x's (B, S, D) top-k assignments that ``apply`` drops at
    ``cfg.capacity_factor`` (float32 scalar)."""
    b, s, d = x.shape
    g = _num_groups(cfg, b * s)
    ng = b * s // g
    c = capacity(cfg, ng)
    _, _, experts = _route(params["router"], x.reshape(g, ng, d), cfg.top_k)
    return (_slots(experts, cfg.num_experts, c) == cfg.num_experts * c).float().mean()


def apply(params: dict, cfg: MoEConfig, x: torch.Tensor, *,
          act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (out (B, S, D), the load-balance aux loss, a
    float32 scalar)."""
    b, s, d = x.shape
    n = b * s
    g = _num_groups(cfg, n)
    ng = n // g
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(cfg, ng)
    xg = x.reshape(g, ng, d)

    # --- routing (float32) --------------------------------------------------
    probs, gates, experts = _route(params["router"], xg, k)  # (G, Ng, E), (G, Ng, K) x 2
    aux = _aux_loss(probs, experts, e, k)

    # --- slot assignment ----------------------------------------------------
    dest = _slots(experts, e, c)  # (G, A); the overflow slot E*C
    flat_tok = torch.arange(ng, device=x.device)[:, None].expand(ng, k).reshape(1, ng * k)
    flat_tok = flat_tok.expand(g, ng * k)
    slot_tok = torch.full((g, e * c + 1), ng, dtype=torch.int64, device=x.device)
    slot_tok.scatter_(1, dest, flat_tok)  # kept slots unique; the overflow slot dropped
    slot_gate = torch.zeros((g, e * c + 1), dtype=torch.float32, device=x.device)
    slot_gate.scatter_(1, dest, gates.reshape(g, ng * k))
    slot_tok, slot_gate = slot_tok[:, :-1], slot_gate[:, :-1]

    # --- gather -> expert products -> combine -------------------------------
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)  # row ng: the empty slot's input
    xe = _rows(x_pad, slot_tok)  # (G, E*C, D)
    xe = xe.view(g, e, c, d).transpose(0, 1).reshape(e, g * c, d)
    ye = _experts(params, xe, act).view(e, g, c, d).transpose(0, 1).reshape(g, e * c, d)
    y = ye * slot_gate[..., None].to(ye.dtype)
    # each assignment reads its slot's output (a dropped one the zero row E*C),
    # summed over the token's choices in order, in the model dtype
    y_pad = torch.cat([y, y.new_zeros((g, 1, d))], dim=1)
    picked = _rows(y_pad, dest).view(g, ng, k, d)
    out = torch.zeros((g, ng, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + picked[:, :, j]

    shared = common.sub(params, "shared.")
    if shared:
        out = out + common.mlp_apply(shared, xg, act=act)
    return out.reshape(b, s, d), aux


def apply_dense_reference(params: dict, cfg: MoEConfig, x: torch.Tensor, *,
                          act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """O(N E) oracle: every expert on every token, masked by the top-k gates,
    no capacity dropping (the reference's test oracle for ``apply``)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs, gates, experts = _route(params["router"], xf, cfg.top_k)
    dense_gates = torch.zeros_like(probs).scatter_(1, experts, gates)  # (N, E)
    ye = _experts(params, xf.expand(cfg.num_experts, *xf.shape), act)  # (E, N, D)
    out = torch.einsum("end,ne->nd", ye.float(), dense_gates)
    aux = _aux_loss(probs[None], experts[None], cfg.num_experts, cfg.top_k)
    out = out.to(x.dtype)
    shared = common.sub(params, "shared.")
    if shared:
        out = out + common.mlp_apply(shared, x, act=act).reshape(-1, d)
    return out.reshape(b, s, d), aux

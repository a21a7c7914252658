"""Consensus protocols: how one gossip step moves parameters (the port's
``repro.core.protocols``, gossip only).

A protocol owns its per-run state, its stacked (R, K, K) round constants, and
one consensus step.  ``gossip`` is the paper's row-stochastic Eq. 4 mix and is
stateless.  Push-sum is still to be ported (ROADMAP.md queue 1 item 8b).

The port's round does not mix with the dense constants: ``operands`` turns a
round's (K, K) slice into the padded sparse operands of the fused kernel,
once per run, and ``mix`` runs one step through
``kernels.consensus_mix.ops.consensus_mix_stacked``, which returns the mixed
parameters and the affinity bias d together.  The dense form of the same
step, ``core.consensus.mix_stacked``, is the tests' reference.
``mix_compressed`` is the step of a compressed wire, through
``kernels.consensus_mix.dequant.dequant_mix_stacked``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.compression import FlatPayload
from repro_torch.core import graph as graph_lib
from repro_torch.kernels.consensus_mix import dequant as cm_dequant
from repro_torch.kernels.consensus_mix import ops as cm_ops


class ProtocolConstants(NamedTuple):
    """Per-round mixing constants: (R, K, K) stacks, or one round's (K, K)
    slice once selected via ``round_constants``."""

    w: Any
    beta: Any


def round_constants(consts: ProtocolConstants, idx) -> ProtocolConstants:
    """Select round ``idx`` of a stacked (R, ...) constants pair."""
    return ProtocolConstants(w=consts.w[idx], beta=consts.beta[idx])


class GossipProtocol:
    """The paper's protocol: row-stochastic averaging (Eq. 4), stateless."""

    name = "gossip"
    stochasticity = "row"

    def init_state(self, params, data_sizes: Sequence[int] | None = None):
        """Gossip carries no protocol state: always ``()``."""
        return ()

    def constants(
        self,
        schedule: graph_lib.GraphSchedule,
        mixing: str = "data_weighted",
        *,
        data_sizes: Sequence[int] | None = None,
        consensus_step_size: float | np.ndarray = 1.0,
    ) -> ProtocolConstants:
        """Row-stochastic (R, K, K) float64 W/Beta stacks for the schedule."""
        w, beta = graph_lib.schedule_matrices(
            schedule, mixing, data_sizes=data_sizes,
            consensus_step_size=consensus_step_size,
        )
        return ProtocolConstants(w=w, beta=beta)

    def operands(
        self, consts: ProtocolConstants, device: torch.device | str
    ) -> cm_ops.SparseOperands:
        """One round's (K, K) float64 slice -> the kernel's sparse operands."""
        return cm_ops.sparse_from_matrices(
            np.asarray(consts.w), np.asarray(consts.beta), device=device
        )

    def mix(
        self, proto_state, flat: torch.Tensor, ops: cm_ops.SparseOperands, local_steps: int
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """One step through the fused kernel: (proto_state, mixed, d_bias)."""
        mixed, d_bias = cm_ops.consensus_mix_stacked(flat, ops, local_steps)
        return proto_state, mixed, d_bias

    def mix_compressed(
        self,
        proto_state,
        flat: torch.Tensor,
        payload: FlatPayload,
        ops: cm_ops.SparseOperands,
        leaf_offsets: tuple[int, ...],
        local_steps: int,
    ) -> tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Convex estimate-gossip, ``diag(W) x + (W - diag(W)) x̂``, with x̂ the
        estimates advanced by this step's payload, and d from estimate
        differences; one step through the fused dequantize-and-mix kernel.
        Returns (proto_state, mixed, d_bias, advanced estimates)."""
        mixed, d_bias, est = cm_dequant.dequant_mix_stacked(
            flat, payload.est, payload.q, payload.scale, ops, leaf_offsets, local_steps
        )
        return proto_state, mixed, d_bias, est


_PROTOCOLS = {"gossip": GossipProtocol()}
# names the reference registers that this port does not run yet
UNPORTED_PROTOCOLS = ("push_sum",)


def protocol_names() -> tuple[str, ...]:
    """Registered protocol names."""
    return tuple(sorted(_PROTOCOLS))


def get_protocol(name: str) -> GossipProtocol:
    """The named protocol instance."""
    if name in UNPORTED_PROTOCOLS:
        raise NotImplementedError(
            f"protocol {name!r} is not ported yet: ROADMAP.md queue 1 item 8b"
        )
    if name not in _PROTOCOLS:
        raise ValueError(f"unknown protocol {name!r}; one of {protocol_names()}")
    return _PROTOCOLS[name]

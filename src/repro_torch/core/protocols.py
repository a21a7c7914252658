"""Consensus protocols: how one gossip step moves parameters (the port's
``repro.core.protocols``).

A protocol (``ConsensusProtocol``, the interface the runtime calls) owns its
per-run state, its stacked (R, K, K) round constants, and one consensus step;
``register_protocol`` adds one to the registry that ``P2PConfig.protocol``
names (``get_protocol``, ``protocol_names``).  ``gossip`` is the paper's
row-stochastic Eq. 4 mix and is stateless.  ``push_sum`` runs directed and
churning schedules: every peer carries a scalar mass y (``PushSumState``),
the weights A are column-stochastic, and one step is

    y'_k = sum_j A[k, j] y_j,    x'_k = sum_j A[k, j] y_j x_j / y'_k

so the parameters stay de-biased and sum_k y_k = K holds on any round.

The port's round does not mix with the dense constants: ``operands`` builds
the schedule's padded sparse operands straight from its graphs
(``graph.SparseSchedule.from_schedule``, no (K, K) float array) and uploads
them once per run, stacked over the period; ``mix`` runs one step through
``kernels.consensus_mix.ops.consensus_mix_stacked``, which returns the mixed
parameters and the affinity bias d together.  The dense form of the same
step, ``core.consensus.mix_stacked``, is the tests' reference.
``mix_compressed`` is the step of a compressed wire, through
``kernels.consensus_mix.dequant.dequant_mix_stacked``, ``mix_hier`` the
step of the one-slice hierarchical runtime ("bridge" or "segment"), and
``mix_stale`` the step of bounded-staleness consensus, through the
``consensus_mix`` kernel's snapshot mode on the round's age-decayed
operands (``age_decayed_operands``, the slot-table form of
``age_decayed_constants``).  Push-sum's steps go through the same kernels in
their mass mode.

The sharded runtime (one process per peer, ``core.p2p.make_sharded_round_fn``)
calls a protocol's rank forms: ``mix_sharded_begin`` once a consensus step
(push-sum's mass exchanged over the lanes), then for each parameter block
``mix_sharded_leaf`` or, under bounded staleness, ``mix_stale_sharded``: the
same kernel launch as the stacked step on the (K, N) buffer of the rank's
row and its in-neighbors' rows, with the rank's row as the launch's row
range, so the row is the stacked step's bit for bit.  A protocol that
overrides only the whole-block ``mix_sharded`` (the reference's interface
before the begin / leaf split) runs through it instead.

The hierarchical runtime over several ranks (a block of p peers a rank,
``core.p2p.make_sharded_round_fn`` with ``peers_per_device`` = p) calls
``mix_hier_begin`` once a consensus step and ``mix_hier_leaf`` for each
parameter block, in the reference's two modes: "bridge" launches the stacked
step's ``consensus_mix`` on the all-gathered (K, N) stack with the rank's
rows as the row range (push-sum's (K,) mass all-gathered once a step), so
every row is the vmap runtime's bit for bit; "segment" launches the slot
form of ``segment_mix`` on the block and its ring-gathered (p, D, N)
neighbor slots (push-sum's (p, D) sender masses ring-gathered once a step).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.compression import FlatPayload
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import graph as graph_lib
from repro_torch.kernels.consensus_mix import dequant as cm_dequant
from repro_torch.kernels.consensus_mix import ops as cm_ops
from repro_torch.kernels.consensus_mix import segment as cm_segment

# One round of a ``graph.SparseSchedule`` on the device, or the whole period
# stacked along a leading axis R: the reference's ``SparseRoundOps``, which
# is the type the kernels' wrappers take (``ops.SparseOperands``).
SparseRoundOps = cm_ops.SparseOperands


class ProtocolConstants(NamedTuple):
    """Per-round mixing constants: (R, K, K) stacks, or one round's (K, K)
    slice once selected via ``round_constants``."""

    w: Any
    beta: Any


def round_constants(consts: ProtocolConstants, idx) -> ProtocolConstants:
    """Select round ``idx`` of a stacked (R, ...) constants pair."""
    return ProtocolConstants(w=consts.w[idx], beta=consts.beta[idx])


def age_decayed_constants(
    consts: ProtocolConstants, decay: torch.Tensor, stochasticity: str
) -> ProtocolConstants:
    """One async round's renormalized age-decayed dense (K, K) constants, in
    float32 (the reference's ``age_decayed_constants``; the round runs the
    slot-table form, ``age_decayed_operands``):

    * off-diagonal entry (k, j) becomes ``w_kj * decay_j`` (axis 1 indexes
      the sender);
    * the diagonal absorbs the freed mass: ``1 - sum`` of the row's
      (gossip, "row") or the column's (push-sum, "column") decayed
      off-diagonals, so the matrix stays stochastic;
    * beta is decayed per sender, then row-renormalized; all-zero rows stay
      zero.

    With ``decay == 1`` the result equals ``consts`` up to the rounding of
    the rebuilt diagonal.
    """
    if stochasticity not in ("row", "column"):
        raise ValueError(f"unknown stochasticity {stochasticity!r}")
    w = torch.as_tensor(consts.w).to(torch.float32)
    decay = torch.as_tensor(decay, device=w.device).to(torch.float32)
    diag = torch.diagonal(w)
    off = (w - torch.diag(diag)) * decay[None, :]
    new_diag = 1.0 - off.sum(dim=1 if stochasticity == "row" else 0)
    beta_d = torch.as_tensor(consts.beta, device=w.device).to(torch.float32) * decay[None, :]
    row_sums = beta_d.sum(dim=1, keepdim=True)
    has = row_sums > 0
    beta = torch.where(has, beta_d / torch.where(has, row_sums, torch.ones_like(row_sums)),
                       torch.zeros_like(beta_d))
    return ProtocolConstants(w=off + torch.diag(new_diag), beta=beta)


class StaleRoundOps(NamedTuple):
    """One round's operands of bounded-staleness consensus on the device:
    the round's sparse operands, the column sums of their off-diagonal
    weights and the profile's publication schedule for the round.  Every
    field is a tensor, so a round driver refreshes them in place."""

    self_w: torch.Tensor  # (K,) float32
    nbr_idx: torch.Tensor  # (K, D) int32
    nbr_w: torch.Tensor  # (K, D) float32
    beta: torch.Tensor  # (K, D) float32 — undecayed
    col_off: torch.Tensor  # (K,) float32 — sum_k of W_off[k, j] over the float32 weights
    scheduled: torch.Tensor  # (K,) bool — sender j publishes on its compute schedule


def column_sums(sparse: graph_lib.SparseSchedule) -> np.ndarray:
    """(R, K) float32: each round's sums over receivers of the off-diagonal
    weights each sender j ships, ``c_j = sum_k W_off[k, j]``, from the
    float32 weights the kernels read, summed in float64 on the host (padding
    slots weigh 0).  Push-sum's age-decayed diagonal is ``1 - decay_j c_j``:
    decay_j factors out of the column, so c_j is a constant of the round."""
    w32 = sparse.nbr_w.astype(np.float32).astype(np.float64)
    out = np.zeros((sparse.period, sparse.num_peers))
    for r in range(sparse.period):
        np.add.at(out[r], sparse.nbr_idx[r].ravel(), w32[r].ravel())
    return out.astype(np.float32)


def age_decayed_operands(
    ops: StaleRoundOps, decay: torch.Tensor, stochasticity: str
) -> SparseRoundOps:
    """One async round's age-decayed operands (the counterpart of the
    reference's ``age_decayed_constants`` on the slot table), float32:

    * off-diagonal weights ``nbr_w[k, s] * decay[nbr_idx[k, s]]``;
    * the diagonal rebuilt so that the matrix stays stochastic: row
      (gossip) ``self_w[k] = 1 - sum_s`` of row k's decayed weights, column
      (push-sum) ``self_w[j] = 1 - decay_j c_j`` (``column_sums``);
    * beta decayed per sender, then row-renormalised; all-zero rows stay 0.

    ``decay`` is the (K,) float32 per-sender ``staleness_decay ** age``.
    With decay 1 the result equals the round's operands up to the rounding
    of the rebuilt diagonal.  Every operation is a device kernel of fixed
    shape (no host sync, no atomics), so a captured round gives the bits of
    an eager one.
    """
    if stochasticity not in ("row", "column"):
        raise ValueError(f"unknown stochasticity {stochasticity!r}")
    sender = decay[ops.nbr_idx.long()]  # (K, D)
    nbr_w = ops.nbr_w * sender
    if stochasticity == "row":
        self_w = 1.0 - nbr_w.sum(dim=1)
    else:
        self_w = 1.0 - decay * ops.col_off
    beta_d = ops.beta * sender
    row_sums = beta_d.sum(dim=1, keepdim=True)
    has = row_sums > 0
    beta = torch.where(has, beta_d / torch.where(has, row_sums, torch.ones_like(row_sums)),
                       torch.zeros_like(beta_d))
    return SparseRoundOps(self_w, ops.nbr_idx, nbr_w, beta)


class PushSumState(NamedTuple):
    """Push-sum's protocol state: the (K,) float32 mass y on the device."""

    mass: torch.Tensor


class SlotMass(NamedTuple):
    """What a rank's push-sum step reads in the hierarchical "segment" mode:
    its block's (p,) masses and each neighbor slot's sender mass (p, D),
    ring-gathered as the parameter slots are."""

    mass: torch.Tensor
    slot_mass: torch.Tensor


class ConsensusProtocol:
    """The interface the port's runtime calls on a consensus protocol.

    A protocol declares its ``name`` (the registry key), whether it is
    unbiased on directed schedules (``directed_capable``) and which
    normalization its weights obey (``stochasticity``: "row" for
    gossip-style averaging, "column" for push-sum mass splitting).  The
    schedule's constants and operands (``constants``, ``sparse_schedule``,
    ``operands``) follow from ``stochasticity`` alone and are built here;
    a protocol implements its state (``init_state``) and its steps over the
    (K, N) flat buffer: ``mix`` (a round's sparse operands), ``mix_compressed``
    (a compressed wire), ``mix_stale`` (bounded staleness) and ``mix_hier``
    (the one-slice hierarchical runtime).  Each step returns the new protocol
    state, the mixed buffer and the affinity d.  ``register_protocol`` makes
    an instance reachable by name from ``P2PConfig.protocol``.
    """

    name: str = "base"
    directed_capable: bool = False
    stochasticity: str = "row"

    def init_state(self, params, data_sizes: Sequence[int] | None = None):
        """Per-run protocol state, carried in ``P2PState.protocol``."""
        raise NotImplementedError

    def constants(
        self,
        schedule: graph_lib.GraphSchedule,
        mixing: str = "data_weighted",
        *,
        data_sizes: Sequence[int] | None = None,
        consensus_step_size: float | np.ndarray = 1.0,
    ) -> ProtocolConstants:
        """(R, K, K) float64 W/Beta stacks for the schedule, W row- or
        column-stochastic as the protocol's ``stochasticity`` says."""
        w, beta = graph_lib.schedule_matrices(
            schedule, mixing, data_sizes=data_sizes,
            consensus_step_size=consensus_step_size, stochasticity=self.stochasticity,
        )
        return ProtocolConstants(w=w, beta=beta)

    def sparse_schedule(
        self,
        schedule: graph_lib.GraphSchedule,
        mixing: str = "data_weighted",
        *,
        data_sizes: Sequence[int] | None = None,
        consensus_step_size: float | np.ndarray = 1.0,
    ) -> graph_lib.SparseSchedule:
        """The schedule's padded float64 slot table, row- or
        column-stochastic as the protocol's ``stochasticity`` says: the
        values of ``constants``, built without any (K, K) array.  A row's
        slots are its in-neighbors in the graph, so an edge whose mixing
        weight is 0 keeps its affinity weight."""
        return graph_lib.SparseSchedule.from_schedule(
            schedule, mixing, data_sizes=data_sizes,
            consensus_step_size=consensus_step_size, stochasticity=self.stochasticity,
        )

    def operands(
        self,
        schedule: graph_lib.GraphSchedule,
        mixing: str = "data_weighted",
        *,
        data_sizes: Sequence[int] | None = None,
        consensus_step_size: float | np.ndarray = 1.0,
        device: torch.device | str = "cpu",
    ) -> SparseRoundOps:
        """The schedule's stacked (R, K) / (R, K, D) sparse operands on
        ``device`` (``sparse_schedule``, cast to float32 once)."""
        sparse = self.sparse_schedule(schedule, mixing, data_sizes=data_sizes,
                                      consensus_step_size=consensus_step_size)
        return cm_ops.upload_schedule(sparse, device)

    def mix(self, proto_state, flat: torch.Tensor, ops: SparseRoundOps, local_steps: int):
        """One consensus step: (proto_state, mixed, d_bias)."""
        raise NotImplementedError

    def mix_compressed(self, proto_state, flat: torch.Tensor, payload: FlatPayload,
                       ops: SparseRoundOps, leaf_offsets: tuple[int, ...], local_steps: int):
        """One step across a compressed wire: (proto_state, mixed, d_bias,
        advanced estimates)."""
        raise NotImplementedError

    def mix_stale(self, proto_state, flat: torch.Tensor, published: torch.Tensor,
                  ops: SparseRoundOps, local_steps: int):
        """One bounded-staleness step: (proto_state, mixed, d_bias)."""
        raise NotImplementedError

    def mix_hier(self, proto_state, flat: torch.Tensor, ops_s: SparseRoundOps, round_idx: int,
                 local_steps: int, *, mode: str):
        """One step of the one-slice hierarchical runtime: (proto_state,
        mixed, d_bias)."""
        raise NotImplementedError

    def mix_sharded_begin(self, proto_state, *, group, lanes):
        """A rank's per-step setup in the sharded runtime, once a consensus
        step: the protocol state its mixes read (push-sum: the (K,) mass of
        the rank and its in-neighbors, exchanged over ``lanes``)."""
        raise NotImplementedError(
            f"protocol {self.name!r} implements neither mix_sharded_begin / "
            "mix_sharded_leaf nor a mix_sharded override")

    def mix_sharded_leaf(self, proto_state, x_full: torch.Tensor, ops: SparseRoundOps, row: int,
                         local_steps: int):
        """One block of a sharded step: ``mix``'s launch on the (K, N) stack
        ``x_full`` (the rank's row and its in-neighbors'), row ``row`` only.
        Returns (the rank's protocol state, mixed (1, N), d (1, N))."""
        raise NotImplementedError

    def mix_stale_sharded(self, proto_state, x_full: torch.Tensor, pub_full: torch.Tensor,
                          ops: SparseRoundOps, row: int, local_steps: int):
        """One block of a sharded bounded-staleness step: ``mix_stale``'s
        launch, row ``row`` only (``x_full``'s own row the live one,
        ``pub_full`` the exchanged snapshots).  Returns (the rank's protocol
        state, mixed (1, N), d (1, N))."""
        raise NotImplementedError

    def mix_hier_begin(self, proto_state, *, group, mode: str, nbr_idx: torch.Tensor):
        """A rank's per-step setup in the hierarchical runtime over several
        ranks, once a consensus step: the protocol state its leaf mixes read
        (push-sum: the (K,) mass all-gathered in "bridge" mode, the block's
        mass and its slots' sender masses, ring-gathered over the block's
        (p, D) global ``nbr_idx``, in "segment" mode)."""
        raise NotImplementedError(
            f"protocol {self.name!r} does not implement the hierarchical "
            "(peers_per_device > 1) mix")

    def mix_hier_leaf(self, step_state, x_block: torch.Tensor, x_view: torch.Tensor,
                      ops: SparseRoundOps, row0: int, local_steps: int, *, mode: str):
        """One block of a rank's hierarchical step.  "bridge": ``x_view`` is
        the all-gathered (K, N) stack and ``ops`` the round's operands of
        every peer; the stacked step's launch on rows row0 .. row0 + p - 1.
        "segment": ``x_view`` is the block's (p, D, N) ring-gathered slots
        and ``ops`` the block's rows of the round; the slot form of
        ``segment_mix``.  Returns (the rank's protocol state, mixed (p, N),
        d (p, N))."""
        raise NotImplementedError

    def mix_sharded(self, proto_state, x_block: torch.Tensor, x_full: torch.Tensor,
                    ops: SparseRoundOps, *, group, lanes):
        """The whole-block form of a sharded step (the reference's interface
        before the begin / leaf split): ``mix_sharded_begin`` then
        ``mix_sharded_leaf``'s mix.  Returns (proto_state, mixed (1, N)); a
        protocol that overrides only this runs through it, with d from the
        kernel (``p2p.consensus_phase_sharded``)."""
        state = self.mix_sharded_begin(proto_state, group=group, lanes=lanes)
        state, mixed, _ = self.mix_sharded_leaf(state, x_full, ops, group.rank, 1)
        return state, mixed


class GossipProtocol(ConsensusProtocol):
    """The paper's protocol: row-stochastic averaging (Eq. 4), stateless."""

    name = "gossip"
    stochasticity = "row"
    directed_capable = False

    def init_state(self, params, data_sizes: Sequence[int] | None = None):
        """Gossip carries no protocol state: always ``()``."""
        return ()

    def mix(
        self, proto_state, flat: torch.Tensor, ops: SparseRoundOps, local_steps: int
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """One step through the fused kernel: (proto_state, mixed, d_bias)."""
        mixed, d_bias = cm_ops.consensus_mix_stacked(flat, ops, local_steps)
        return proto_state, mixed, d_bias

    def mix_compressed(
        self,
        proto_state,
        flat: torch.Tensor,
        payload: FlatPayload,
        ops: SparseRoundOps,
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

    def mix_stale(
        self, proto_state, flat: torch.Tensor, published: torch.Tensor, ops: SparseRoundOps,
        local_steps: int,
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """One bounded-staleness step (the reference's ``mix_compressed``
        with the published snapshots for the estimates, plus d) through the
        kernel's snapshot mode: ``diag(W) x + W_off P`` and ``d = (Beta P -
        x) / T`` on the round's age-decayed operands.  Returns
        (proto_state, mixed, d_bias)."""
        mixed, d_bias = cm_ops.consensus_mix_snapshot_stacked(flat, published, ops, local_steps)
        return proto_state, mixed, d_bias

    def mix_hier(
        self,
        proto_state,
        flat: torch.Tensor,
        ops_s: SparseRoundOps,
        round_idx: int,
        local_steps: int,
        *,
        mode: str,
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """One step of the one-slice hierarchical runtime over round
        ``round_idx % R`` of the stacked operands: (proto_state, mixed, d_bias).

        The counterpart of the reference's ``mix_hier_begin`` +
        ``mix_hier_leaf`` with the whole fleet on one device and one flat
        leaf.  "bridge" runs the vmap runtime's step (the ``consensus_mix``
        kernel on the round's operands, so it equals that runtime bit for
        bit); "segment" runs the ``segment_mix`` kernel, which selects the
        round itself and takes any degree bound.
        """
        if mode == "bridge":
            return self.mix(proto_state, flat, cm_ops.select_round(ops_s, round_idx),
                            local_steps)
        if mode == "segment":
            mixed, d_bias = cm_segment.segment_mix_schedule(flat, round_idx, ops_s, local_steps)
            return proto_state, mixed, d_bias
        raise ValueError(f"unknown mix_mode {mode!r}; 'bridge' or 'segment'")

    def mix_sharded_begin(self, proto_state, *, group, lanes):
        """Gossip carries no state: ``proto_state`` as it is."""
        return proto_state

    def mix_sharded_leaf(
        self, proto_state, x_full: torch.Tensor, ops: SparseRoundOps, row: int,
        local_steps: int,
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """``mix``'s ``consensus_mix`` launch, row ``row`` only."""
        mixed, d_bias = cm_ops.consensus_mix_stacked(x_full, ops, local_steps, rows=(row, 1))
        return proto_state, mixed, d_bias

    def mix_stale_sharded(
        self, proto_state, x_full: torch.Tensor, pub_full: torch.Tensor, ops: SparseRoundOps,
        row: int, local_steps: int,
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """``mix_stale``'s snapshot-mode launch, row ``row`` only."""
        mixed, d_bias = cm_ops.consensus_mix_snapshot_stacked(x_full, pub_full, ops, local_steps,
                                                              rows=(row, 1))
        return proto_state, mixed, d_bias


    def mix_hier_begin(self, proto_state, *, group, mode: str, nbr_idx: torch.Tensor):
        """Gossip carries no state: ``proto_state`` as it is."""
        return proto_state

    def mix_hier_leaf(
        self, step_state, x_block: torch.Tensor, x_view: torch.Tensor, ops: SparseRoundOps,
        row0: int, local_steps: int, *, mode: str,
    ) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """"bridge": ``mix``'s ``consensus_mix`` launch on the (K, N) stack,
        the block's rows only; "segment": the slot form of ``segment_mix``."""
        if mode == "bridge":
            mixed, d_bias = cm_ops.consensus_mix_stacked(x_view, ops, local_steps,
                                                         rows=(row0, x_block.shape[0]))
        elif mode == "segment":
            mixed, d_bias = cm_segment.segment_mix_slots(x_block, x_view, ops, local_steps)
        else:
            raise ValueError(f"unknown mix_mode {mode!r}; 'bridge' or 'segment'")
        return step_state, mixed, d_bias


class PushSumProtocol(GossipProtocol):
    """Directed push-sum: column-stochastic weights and a mass correction.

    The parameters a step takes and returns are de-biased; the affinity d of
    every step comes from them, with Beta not scaled by mass (as in gossip).
    """

    name = "push_sum"
    stochasticity = "column"
    directed_capable = True

    def init_state(self, params, data_sizes: Sequence[int] | None = None) -> PushSumState:
        """The (K,) mass: proportional to ``data_sizes`` and normalised to sum
        K (the de-biased estimates then approach the data-weighted average),
        uniform without them."""
        k = params.shape[0]
        if data_sizes is None:
            mass = np.ones(k)
        else:
            n = np.asarray(data_sizes, dtype=np.float64)
            if n.shape != (k,) or (n <= 0).any():
                raise ValueError("data_sizes must be positive, one per peer")
            mass = k * n / n.sum()
        return PushSumState(mass=torch.as_tensor(mass.astype(np.float32), device=params.device))

    def mix(
        self, proto_state: PushSumState, flat: torch.Tensor, ops: SparseRoundOps,
        local_steps: int,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor]:
        """One step through the ``consensus_mix`` kernel's mass mode:
        (state with y', de-biased mixed, d_bias)."""
        mixed, d_bias, mass = cm_ops.consensus_mix_push_sum_stacked(
            flat, proto_state.mass, ops, local_steps)
        return PushSumState(mass=mass), mixed, d_bias

    def mix_compressed(
        self,
        proto_state: PushSumState,
        flat: torch.Tensor,
        payload: FlatPayload,
        ops: SparseRoundOps,
        leaf_offsets: tuple[int, ...],
        local_steps: int,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Convex estimate-push-sum, ``(diag(A) y x + A_off y x̂) / y'``, with
        x̂ the advanced estimates and the mass uncompressed, and d from
        estimate differences; one step through the ``dequant_mix`` kernel's
        mass mode.  Returns (state, mixed, d_bias, advanced estimates)."""
        mixed, d_bias, est, mass = cm_dequant.dequant_mix_push_sum_stacked(
            flat, payload.est, payload.q, payload.scale, proto_state.mass, ops, leaf_offsets,
            local_steps)
        return PushSumState(mass=mass), mixed, d_bias, est

    def mix_stale(
        self, proto_state: PushSumState, flat: torch.Tensor, published: torch.Tensor,
        ops: SparseRoundOps, local_steps: int,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor]:
        """One bounded-staleness push-sum step through the snapshot mode in
        its mass mode: ``(diag(A) y x + A_off y P) / y'``, the mass
        uncompressed and never stale, d as in gossip.  Returns (state with
        y', mixed, d_bias)."""
        mixed, d_bias, mass = cm_ops.consensus_mix_push_sum_snapshot_stacked(
            flat, published, proto_state.mass, ops, local_steps)
        return PushSumState(mass=mass), mixed, d_bias

    def mix_hier(
        self,
        proto_state: PushSumState,
        flat: torch.Tensor,
        ops_s: SparseRoundOps,
        round_idx: int,
        local_steps: int,
        *,
        mode: str,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor]:
        """The one-slice hierarchical step: "bridge" is ``mix`` on the round's
        operands (as in gossip), "segment" the ``segment_mix`` kernel's mass
        mode."""
        if mode == "segment":
            mixed, d_bias, mass = cm_segment.segment_mix_push_sum_schedule(
                flat, proto_state.mass, round_idx, ops_s, local_steps)
            return PushSumState(mass=mass), mixed, d_bias
        return super().mix_hier(proto_state, flat, ops_s, round_idx, local_steps, mode=mode)

    def mix_sharded_begin(self, proto_state: PushSumState, *, group, lanes) -> PushSumState:
        """The mass rides the parameters' lanes, once a step: the (K,) mass
        of the rank and its in-neighbors (zeros elsewhere, never read)."""
        return PushSumState(mass=group.exchange(proto_state.mass, lanes))

    def mix_sharded_leaf(
        self, proto_state: PushSumState, x_full: torch.Tensor, ops: SparseRoundOps, row: int,
        local_steps: int,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor]:
        """``mix``'s mass-mode launch, row ``row`` only: (the rank's y' (1,),
        mixed, d)."""
        mixed, d_bias, mass = cm_ops.consensus_mix_push_sum_stacked(
            x_full, proto_state.mass, ops, local_steps, rows=(row, 1))
        return PushSumState(mass=mass), mixed, d_bias

    def mix_stale_sharded(
        self, proto_state: PushSumState, x_full: torch.Tensor, pub_full: torch.Tensor,
        ops: SparseRoundOps, row: int, local_steps: int,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor]:
        """``mix_stale``'s mass-mode snapshot launch, row ``row`` only."""
        mixed, d_bias, mass = cm_ops.consensus_mix_push_sum_snapshot_stacked(
            x_full, pub_full, proto_state.mass, ops, local_steps, rows=(row, 1))
        return PushSumState(mass=mass), mixed, d_bias


    def mix_hier_begin(self, proto_state: PushSumState, *, group, mode: str,
                       nbr_idx: torch.Tensor) -> PushSumState | SlotMass:
        """The mass, once a step: "bridge" all-gathers the (K,) mass (the
        stacked matvec's operand); "segment" ring-gathers the (p, D) sender
        masses with the parameter slots' indices."""
        mass = proto_state.mass
        if mode == "bridge":
            return PushSumState(mass=group.all_gather(mass).reshape(-1))
        return SlotMass(mass, consensus_lib.ring_gather_slots(mass, nbr_idx, group))

    def mix_hier_leaf(
        self, step_state, x_block: torch.Tensor, x_view: torch.Tensor, ops: SparseRoundOps,
        row0: int, local_steps: int, *, mode: str,
    ) -> tuple[PushSumState, torch.Tensor, torch.Tensor]:
        """"bridge": ``mix``'s mass-mode launch on the (K, N) stack and the
        (K,) mass, the block's rows only (the reference's full matvec, then
        the slice); "segment": the slot form's mass mode.  Returns (the
        block's y' (p,), mixed, d)."""
        if mode == "bridge":
            mixed, d_bias, mass = cm_ops.consensus_mix_push_sum_stacked(
                x_view, step_state.mass, ops, local_steps, rows=(row0, x_block.shape[0]))
        elif mode == "segment":
            mixed, d_bias, mass = cm_segment.segment_mix_push_sum_slots(
                x_block, x_view, step_state.mass, step_state.slot_mass, ops, local_steps)
        else:
            raise ValueError(f"unknown mix_mode {mode!r}; 'bridge' or 'segment'")
        return PushSumState(mass=mass), mixed, d_bias


_REGISTRY: dict[str, ConsensusProtocol] = {}


def register_protocol(protocol: ConsensusProtocol) -> ConsensusProtocol:
    """Add a protocol instance to the registry (its name must be unique)."""
    if not protocol.name or protocol.name == "base":
        raise ValueError("protocol needs a distinct name")
    if protocol.name in _REGISTRY:
        raise ValueError(f"protocol {protocol.name!r} already registered")
    _REGISTRY[protocol.name] = protocol
    return protocol


def unregister_protocol(name: str) -> None:
    """Remove a registered protocol (the registry is the process's: a
    protocol registered for one check is taken out after it)."""
    _REGISTRY.pop(name, None)


def get_protocol(name: str) -> ConsensusProtocol:
    """Look up a registered protocol by name (ValueError on unknown)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown protocol {name!r}; one of {protocol_names()}") from None


def protocol_names() -> tuple[str, ...]:
    """Registered protocol names, in registration order."""
    return tuple(_REGISTRY)


register_protocol(GossipProtocol())
register_protocol(PushSumProtocol())

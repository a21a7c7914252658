"""The paper's algorithm family on stacked peers (the port's ``repro.core.p2p``,
vmap runtime).

P2PL with Affinity (Sec. IV-A) subsumes every baseline in the paper:

    algorithm          T      S    momentum  max-norm-sync  d bias  b bias
    -----------------  -----  ---  --------  -------------  ------  ------
    dsgd               1      1    optional  no             0       0
    local_dsgd         T > 1  1    optional  no             0       0
    p2pl               T > 1  S    yes       yes            0       0
    p2pl_affinity      T > 1  S    optional  yes            yes     optional
    isolated           T > 1  0    optional  no             0       0

Learning phase (Eq. 3):   w <- w - eta * grad F_k(w) + eta_d * d_k
Consensus phase (Eq. 4):  w_k <- sum_j alpha_kj w_j + eta_b * b_k
Affinity biases:          d_k <- (1/T) sum_j beta_kj (w_j - w_k)   (consensus)
                          b_k <- (1/S) w_k                         (local phase)

Layout.  Every state leaf is ONE (K, row) tensor on the device, of the
task's type (float32, or bfloat16 for a bf16 language model): the K
peers' parameters flattened into rows (``ParamLayout``; the leaves in the
task's order, each row zero-padded to 16 bytes, 4 float32 or 8 bf16
elements, so rows stay 16-byte aligned).  A bf16 model's float32 leaves
(rwkv6's decay base and bonus, Mamba2's dt bias, A_log and D, a MoE router)
sit in a second (K, row) float32 block of every such buffer
(``P2PState.wide``: params, momentum, d, b, and a compressed wire's estimates
and bounded staleness's snapshots where the round carries them), updated and
mixed like the first, each in its own type, one kernel launch a block a
consensus step; the round's protocol state (push-sum's mass), snapshot ages
and operands are shared by both blocks.  The local phase reads the leaves
as (K, ...) views of that
buffer and runs each layer as one batched matmul over the peers; one backward
of the summed per-peer losses gives every peer its own gradient, and the SGD
update is a few elementwise passes over the whole buffer.  The consensus
phase hands the same buffer to the fused ``consensus_mix`` kernel, which
writes the mixed parameters and the affinity bias d in one pass.  With a
compressed wire (``compressor`` = ``topk`` or ``qint8``) the round also
carries the public-estimate stack (``P2PState.compression``, one more
(K, row) buffer), and each consensus step goes through the fused
``dequant_mix`` kernel instead.

The one-slice hierarchical runtime (``make_hier_round_fn``, the reference's
``make_sharded_round_fn(..., peers_per_device=K)`` on a one-device mesh) runs
the same local phase and mixes through ``consensus_phase_hier``: "bridge"
(K <= 64 under "auto") is the vmap runtime's ``consensus_mix`` step, bit for
bit; "segment" (larger K) is the ``segment_mix`` kernel over the round's
slots of the degree-bounded schedule, which takes any degree bound and never
builds a (K, K) array.  This is how one GPU trains K = 4096 peers of the 2NN.

Push-sum (``protocol="push_sum"``) carries a (K,) mass in
``P2PState.protocol`` and mixes directed and churning schedules with
column-stochastic weights; each of its consensus steps goes through the same
kernels in their mass mode (``core.protocols.PushSumProtocol``).

Asynchronous rounds (the reference's straggler model): a compute profile
(``steps_profile``, ``compute_profile``) gives each peer a budget of local
steps, held by masking in the local phase, and a publication period; with
``staleness_bound > 0`` the round carries each sender's last published
snapshot and its age (``P2PState.staleness``), and each consensus step goes
through the ``consensus_mix`` kernel's snapshot mode on age-decayed weights
(``_consensus_phase_async``).

Adaptive partner selection (``schedule="adaptive"``) picks each round's
pairwise matching on the device from run state (``P2PState.adaptive``: the
peers' previous mean losses and a threefry key, ``core.prng``), before the
local phase, as the reference's step does (``run_adaptive_round``); the
round's dense W and Beta reach the same kernels through their dense
operands (``kernels.consensus_mix.ops.dense_operands``: every j != k a
slot).

Ported: gossip and push-sum over the static, the undirected and the directed
time-varying schedules and adaptive matchings, uncompressed or compressed,
synchronous or asynchronous rounds, every registered task (the 2NN and
``rwkv6_seqmnist``; a registry task is refused by the hierarchical runtime,
as in the reference) and a registry language model's task
(``task.from_model``, on the reference's batch tree: ``tokens``, ``labels``
and a vlm's ``patches`` or an encoder-decoder's ``frames``; in float32 or
bf16, with a bf16 model's float32 leaves in their float32 block, under every
protocol, wire, delivery rule and schedule above and through both round
drivers), the vmap and one-slice hierarchical runtimes, the sharded
runtime with one process per peer and the hierarchical runtime over several
processes.

The sharded runtime (``make_sharded_round_fn``, the reference's
``peer_axis="pod"`` with one peer a device) runs each peer in its own
process (``core.peer_group``: gloo on the CPU, CUDA IPC inboxes for K ranks
on one card): a rank holds its (1, row) block of the state, runs the local
phase on it, exchanges its row with its neighbors over the schedule's lanes
and launches the stacked step's kernel on its row alone (the kernels' row
range), so every row equals the vmap runtime's bit for bit; a compressed
wire all-gathers the payloads (allclose, as in the reference).  With
``peers_per_device`` = p > 1 the same function builds a rank's round of the
hierarchical runtime over K / p processes (the reference's
``_make_hier_round_step``): a rank holds a block of p peers (peer g on rank
g // p), runs the local phase over its p rows and mixes them in one of the
reference's two modes (``consensus_phase_hier_sharded``): "bridge" all-gathers
the (K, N) stack and launches the vmap runtime's kernel on the block's row
range (bit for bit), "segment" ring-gathers the block's neighbor slots and
launches the slot form of ``segment_mix`` (no (K, ...) tensor).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import capture as capture_lib
from repro_torch import compression as compression_lib
from repro_torch import pytree
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import features as features_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import prng
from repro_torch.core import protocols as protocols_lib
from repro_torch.core import task as task_lib
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.core.protocols import SparseRoundOps
from repro_torch.kernels.consensus_mix import ops as cm_ops
from repro_torch.kernels.consensus_mix.ops import (complete_candidates, dense_operands,
                                                    select_round, upload_schedule)

ALGORITHMS = ("dsgd", "local_dsgd", "p2pl", "p2pl_affinity", "isolated")
STEPS_PROFILES = ("uniform", "straggler", "linear")
ROW_ALIGN = 4  # floats: keeps every peer's row 16-byte aligned


def row_align(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in ROW_ALIGN floats (16 bytes): 4 float32, 8 bf16."""
    return ROW_ALIGN * 4 // dtype.itemsize


def resolve_loss_fn(task_or_loss) -> Callable:
    """A ``TrainTask`` or a bare per-peer loss -> the stacked loss
    ``(stacked params, batch) -> (K,)`` (the reference's ``resolve_loss_fn``,
    whose drivers vmap the per-peer loss themselves): a task's ``loss_fn``
    as it is, a bare per-peer loss ``(params, batch) -> scalar`` mapped over
    the peers by ``torch.func.vmap``."""
    loss_fn = getattr(task_or_loss, "loss_fn", None)
    return torch.func.vmap(task_or_loss) if loss_fn is None else loss_fn


def resolve_init_fn(task_or_init) -> Callable:
    """A ``TrainTask`` or a bare per-peer init ``generator -> params`` -> the
    per-peer init (the reference's ``resolve_init_fn``)."""
    init_fn = getattr(task_or_init, "init_params", None)
    return task_or_init if init_fn is None else init_fn


@dataclasses.dataclass(frozen=True)
class P2PConfig:
    """Hyperparameters of the P2PL-with-Affinity family.

    Field names and defaults equal ``repro.core.p2p.P2PConfig``'s.
    """

    algorithm: str = "p2pl_affinity"
    num_peers: int = 2
    local_steps: int = 1  # T
    consensus_steps: int = 1  # S
    lr: float = 0.01  # eta
    momentum: float = 0.0  # mu (PyTorch-default Polyak: buf = mu*buf + g; w -= lr*buf)
    eta_d: float = 1.0  # learning-phase bias step size
    eta_b: float = 0.0  # consensus-phase bias step size (paper's experiments: b = 0)
    topology: str = "complete"
    mixing: str = "data_weighted"
    consensus_step_size: float = 1.0  # epsilon_k
    max_norm_init: bool = False
    erdos_renyi_p: float = 0.3
    graph_seed: int = 0
    protocol: str = "gossip"
    # -- time-varying communication (item 8 and 8b) ---------------------------
    schedule: str = "static"
    schedule_rounds: int = 16
    link_survival_prob: float = 0.8
    peer_online_prob: float = 0.8
    schedule_seed: int = 0
    round_robin_topologies: tuple[str, ...] = ()
    # -- adaptive partner selection, schedule="adaptive" ----------------------
    partner_rule: str = "loss_proximity"
    adaptive_eps: float = 0.1
    adaptive_seed: int = 0
    # -- consensus-payload compression (item 11) -----------------------------
    compressor: str = "none"
    topk_frac: float = 0.01
    # -- asynchronous rounds (item 12) ---------------------------------------
    steps_profile: str = "uniform"
    staleness_bound: int = 0
    staleness_decay: float = 0.5
    straggler_frac: float = 0.25
    straggler_period: int = 4
    # -- training task: any registered name (core.task.task_names()) ---------
    model: str = "mnist_mlp"

    def __post_init__(self):
        """Validate the config; reject what this port does not run yet."""
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.algorithm == "dsgd" and (self.local_steps != 1 or self.consensus_steps != 1):
            raise ValueError("dsgd fixes T = S = 1")
        if self.algorithm == "isolated" and self.consensus_steps != 0:
            raise ValueError("isolated fixes S = 0")
        if self.local_steps < 1:
            raise ValueError("need at least one local step per round")
        protocols_lib.get_protocol(self.protocol)
        if self.schedule not in graph_lib.SCHEDULES + ("adaptive",):
            raise ValueError(
                f"unknown schedule {self.schedule!r}; one of "
                f"{graph_lib.SCHEDULES + ('adaptive',)}"
            )
        if self.schedule_rounds < 1:
            raise ValueError("schedule_rounds must be >= 1")
        if self.partner_rule not in graph_lib.ADAPTIVE_RULES:
            raise ValueError(
                f"unknown partner_rule {self.partner_rule!r}; one of "
                f"{graph_lib.ADAPTIVE_RULES}"
            )
        if not 0.0 <= self.adaptive_eps <= 1.0:
            raise ValueError("adaptive_eps must be in [0, 1]")
        if self.schedule == "adaptive" and self.num_peers < 2:
            raise ValueError("adaptive partner selection needs at least two peers")
        if self.topology not in graph_lib.TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.compressor not in compression_lib.compressor_names():
            raise ValueError(
                f"unknown compressor {self.compressor!r}; one of "
                f"{compression_lib.compressor_names()}"
            )
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError("topk_frac must be in (0, 1]")
        if self.steps_profile not in STEPS_PROFILES:
            raise ValueError(
                f"unknown steps_profile {self.steps_profile!r}; one of {STEPS_PROFILES}"
            )
        if self.staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0 (0 = synchronous)")
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError("staleness_decay must be in (0, 1]")
        if not 0.0 < self.straggler_frac <= 1.0:
            raise ValueError("straggler_frac must be in (0, 1]")
        if self.straggler_period < 1:
            raise ValueError("straggler_period must be >= 1")
        features_lib.check_config(self)
        task_lib.get_task(self.model)
        if self.schedule == "round_robin" and not self.round_robin_topologies:
            raise ValueError("round_robin schedule needs round_robin_topologies")
        object.__setattr__(self, "round_robin_topologies", tuple(self.round_robin_topologies))
        for topo in self.round_robin_topologies:
            if not isinstance(topo, str):
                raise ValueError(f"round_robin_topologies must be topology names, got {topo!r}")
            if topo not in graph_lib.TOPOLOGIES:
                raise ValueError(
                    f"unknown round_robin topology {topo!r}; one of {graph_lib.TOPOLOGIES}"
                )

    @property
    def use_affinity_d(self) -> bool:
        """Whether the learning-phase affinity bias d (Eq. 3) is active."""
        return self.algorithm == "p2pl_affinity" and self.eta_d != 0.0

    @property
    def use_affinity_b(self) -> bool:
        """Whether the consensus-phase affinity bias b (Eq. 4) is active."""
        return self.algorithm == "p2pl_affinity" and self.eta_b != 0.0

    @property
    def use_max_norm_init(self) -> bool:
        """Whether peers synchronize to the max-norm init (Sec. IV-A)."""
        return self.max_norm_init or self.algorithm in ("p2pl", "p2pl_affinity")

    @property
    def use_async(self) -> bool:
        """Whether any asynchronous-round machinery is active: snapshots
        mixed under a staleness bound, or per-peer step budgets.  False
        means the synchronous round runs as it was, bit for bit."""
        return self.staleness_bound > 0 or self.steps_profile != "uniform"


def compute_profile(cfg: P2PConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per-peer compute profile ``(steps_k, period_k)``, (K,) int32 each
    (the reference's ``compute_profile``): the local steps peer k completes
    a round (<= T; the local phase still runs T steps and holds a finished
    peer) and the rounds between its snapshot publications.  "uniform":
    (T, 1) for every peer; "straggler": the last ``straggler_frac`` of the
    peers take ``max(1, T // straggler_period)`` steps and publish every
    ``straggler_period`` rounds; "linear": speeds from 1 down to
    ``1 / straggler_period``, steps ``max(1, round(T * speed))``, period 1."""
    k, t = cfg.num_peers, cfg.local_steps
    steps = np.full((k,), t, np.int32)
    period = np.ones((k,), np.int32)
    if cfg.steps_profile == "straggler":
        n_slow = max(1, int(round(k * cfg.straggler_frac)))
        slow = np.arange(k) >= k - n_slow
        steps[slow] = max(1, t // cfg.straggler_period)
        period[slow] = cfg.straggler_period
    elif cfg.steps_profile == "linear":
        speed = np.linspace(1.0, 1.0 / cfg.straggler_period, k)
        steps = np.maximum(1, np.round(t * speed)).astype(np.int32)
    return steps, period


def publication_table(cfg: P2PConfig) -> np.ndarray:
    """(P, K) bool, P the least common multiple of the profile's periods:
    row ``r % P`` says which senders publish on their compute schedule in
    round r, ``r mod period_k == period_k - 1``."""
    _, periods = compute_profile(cfg)
    p = math.lcm(*(int(v) for v in periods))
    return np.arange(p)[:, None] % periods[None, :] == periods[None, :] - 1


def steps_budget(cfg: P2PConfig) -> np.ndarray | None:
    """The (K,) int32 step budgets, on the host (``compute_profile``), or
    None for the "uniform" profile, whose local phase stays the unmasked
    loop."""
    if cfg.steps_profile == "uniform":
        return None
    return compute_profile(cfg)[0]


def _held_rows(steps_k: np.ndarray, t: int) -> list[slice]:
    """The peers whose budget is spent by local step ``t``, as slices of
    consecutive rows (one for the "straggler" and "linear" profiles: their
    slow peers are the last ones)."""
    held = np.flatnonzero(steps_k <= t)
    if held.size == 0:
        return []
    cuts = np.flatnonzero(np.diff(held) > 1) + 1
    return [slice(int(run[0]), int(run[-1]) + 1) for run in np.split(held, cuts)]


@dataclasses.dataclass(frozen=True, eq=False)
class ParamLayout:
    """Where each named leaf lives in a peer's flat parameter row.

    A task whose leaves share its type has one block: every leaf in one
    (K, row) buffer of that type.  A task with float32 leaves beside leaves
    of another type (``TrainTask.param_dtypes``: a bf16 model's few float32
    leaves) has two: ``shapes`` .. ``dtype`` describe the block of the
    task's type, and ``wide`` the float32 block of the rest, each padded as
    its type wants; ``views`` and ``flatten_blocks`` take and give one
    buffer a block, the leaves in the task's order (``names``)."""

    shapes: dict[str, tuple[int, ...]]
    offsets: dict[str, int]
    size: int  # parameters per peer
    row: int  # row length: ``size`` padded to 16 bytes (``row_align``)
    dtype: torch.dtype = torch.float32  # the task's parameter type
    wide: "ParamLayout | None" = None  # the float32 block of a mixed task
    names: tuple[str, ...] = ()  # a mixed task's leaves, in the task's order

    @classmethod
    def block(cls, shapes: dict[str, tuple[int, ...]], dtype: torch.dtype) -> "ParamLayout":
        """One block of ``shapes``' leaves, in their order, of ``dtype``."""
        offsets, off = {}, 0
        for name, shape in shapes.items():
            offsets[name] = off
            off += int(np.prod(shape))
        align = row_align(dtype)
        row = -(-off // align) * align
        return cls(dict(shapes), offsets, off, row, dtype)

    @classmethod
    def of(cls, task: task_lib.TrainTask) -> "ParamLayout":
        """The layout of ``task``'s leaves, in ``task.param_shapes`` order."""
        types = task.param_dtypes or {}
        own = {n: s for n, s in task.param_shapes.items() if types.get(n, task.dtype) == task.dtype}
        if len(own) == len(task.param_shapes):
            return cls.block(task.param_shapes, task.dtype)
        rest = {n: s for n, s in task.param_shapes.items() if n not in own}
        if {types[n] for n in rest} != {torch.float32}:
            raise TypeError(f"a task of {task.dtype} leaves takes float32 ones beside them, got "
                            f"{sorted({str(types[n]) for n in rest})}")
        return dataclasses.replace(cls.block(own, task.dtype),
                                   wide=cls.block(rest, torch.float32),
                                   names=tuple(task.param_shapes))

    @property
    def leaf_offsets(self) -> tuple[int, ...]:
        """The L + 1 leaf boundaries of a row: each leaf's first column, then
        ``size`` (the columns from ``size`` to ``row`` are padding)."""
        return (*self.offsets.values(), self.size)

    @property
    def blocks(self) -> list["ParamLayout"]:
        """One single-block layout a buffer of the state (``views``' order):
        the layout itself for a task of one type, else the block of the
        task's type and the float32 block."""
        if self.wide is None:
            return [self]
        return [dataclasses.replace(self, wide=None, names=()), self.wide]

    def dtype_of(self, name: str) -> torch.dtype:
        """The type of leaf ``name``: its block's."""
        return self.wide.dtype if self.wide is not None and name in self.wide.shapes \
            else self.dtype

    def views(self, flat: torch.Tensor, wide: torch.Tensor | None = None
              ) -> dict[str, torch.Tensor]:
        """(K, ...) views of every leaf into a (K, row) buffer (no copies),
        and of a mixed task's float32 leaves into ``wide``, its (K, row)
        float32 block."""
        k = flat.shape[0]
        out = {
            name: flat[:, off : off + int(np.prod(shape))].view(k, *shape)
            for (name, shape), off in zip(self.shapes.items(), self.offsets.values())
        }
        if self.wide is None:
            return out
        if wide is None:
            raise ValueError("a layout of mixed types needs its float32 block too")
        out.update(self.wide.views(wide))
        return {name: out[name] for name in self.names}

    def flatten(self, leaves: dict[str, torch.Tensor]) -> torch.Tensor:
        """Named stacked (K, ...) leaves -> a fresh (K, row) buffer of the
        layout's type (of its own block's leaves)."""
        rows = [leaves[name].reshape(leaves[name].shape[0], -1).to(self.dtype)
                for name in self.shapes]
        pad = self.row - self.size
        if pad:
            rows.append(rows[0].new_zeros(rows[0].shape[0], pad))
        return torch.cat(rows, dim=1)

    def flatten_blocks(self, leaves: dict[str, torch.Tensor]) -> list[torch.Tensor]:
        """Named stacked leaves -> one fresh buffer a block (``views``' order)."""
        return [self.flatten(leaves)] + ([] if self.wide is None else
                                         [self.wide.flatten(leaves)])


class StalenessState(NamedTuple):
    """The bounded-staleness delivery buffer (``staleness_bound > 0``): one
    snapshot per sender, which every receiver of that sender mixes.

    ``published`` (K, row) of the parameters' type: each sender's last
    published parameters, the source of every off-diagonal consensus term
    (the self term reads the live parameters); a mixed task's float32
    block keeps its own in ``WideState.published``.  ``age`` (K,) int32:
    rounds since each snapshot was taken, never above ``staleness_bound``
    after a round.
    """

    published: torch.Tensor
    age: torch.Tensor


class AdaptiveState(NamedTuple):
    """Run state of adaptive partner selection (``schedule="adaptive"``).

    ``key`` (K, 2) int64 holding the reference's uint32 threefry key
    (``core.prng``), the same in every row, so every peer derives the same
    matching; one split is consumed per round.  ``last_losses`` (K,)
    float32: each peer's mean training loss of the previous round, the
    selection signal.
    """

    key: torch.Tensor
    last_losses: torch.Tensor


class AdaptiveRoundOps(NamedTuple):
    """The static operands of an adaptive round on the device: the round's
    W and Beta are computed inside the step, from the state."""

    nbr_idx: torch.Tensor  # (K, K-1) int32 — every j != k (``complete_candidates``)
    data_sizes: torch.Tensor  # (K,) float32 — n_k, ones without data sizes


class WideState(NamedTuple):
    """The float32 block of a mixed task's per-parameter buffers
    (``ParamLayout.wide``): each (K, row) float32, its float32 leaves.
    ``compression`` and ``published`` are the block's estimate stack of a
    compressed wire and its published snapshots under bounded staleness,
    ``()`` where the round carries none."""

    params: torch.Tensor
    momentum: torch.Tensor
    d_bias: torch.Tensor
    b_bias: torch.Tensor
    compression: torch.Tensor | tuple = ()
    published: torch.Tensor | tuple = ()


class P2PState(NamedTuple):
    """Stacked peer state: every tensor is (K, row), of the task's type (see
    ``ParamLayout``).

    ``wide`` is a mixed task's float32 block of ``params`` .. ``b_bias``
    (``WideState``), else ``()``.

    ``protocol`` holds the consensus protocol's own state: ``()`` for gossip,
    ``protocols.PushSumState`` ((K,) mass) for push-sum.
    ``adaptive`` is the ``AdaptiveState`` of ``schedule="adaptive"``, else
    ``()``.
    ``compression`` is the public-estimate stack of a compressed wire, (K, row)
    like the parameters, or ``()`` for ``compressor="none"``.
    ``round_idx`` counts completed consensus phases.
    ``staleness`` is the ``StalenessState`` of bounded-staleness consensus,
    ``()`` when ``staleness_bound == 0``.
    """

    params: torch.Tensor
    momentum: torch.Tensor
    d_bias: torch.Tensor  # affinity learning-phase bias (Eq. 3)
    b_bias: torch.Tensor  # affinity consensus-phase bias (Eq. 4)
    round_idx: int
    protocol: tuple = ()
    adaptive: AdaptiveState | tuple = ()
    compression: torch.Tensor | tuple = ()
    staleness: StalenessState | tuple = ()
    wide: WideState | tuple = ()


def blocks(state: P2PState, field: str) -> list:
    """``field``'s buffer of each parameter block: the state's own (for
    ``"published"``, its ``StalenessState``'s snapshots), then a mixed task's
    float32 block's (``WideState``).  With ``with_blocks``, the one place
    that knows where a block's buffers live."""
    first = state.staleness.published if field == "published" else getattr(state, field)
    return [first] + ([getattr(state.wide, field)] if state.wide else [])


def with_blocks(state: P2PState, **fields: list) -> P2PState:
    """``state`` with each keyword's per-block buffers (``blocks``' order)
    written back where ``blocks`` reads them."""
    wide = state.wide
    for field, (first, *rest) in fields.items():
        if wide:
            wide = wide._replace(**{field: rest[0]})
        if field == "published":
            state = state._replace(staleness=state.staleness._replace(published=first))
        else:
            state = state._replace(**{field: first})
    return state._replace(wide=wide)


def param_blocks(state: P2PState) -> list[torch.Tensor]:
    """The state's parameter buffers: ``params``, and a mixed task's float32
    block."""
    return blocks(state, "params")


@functools.cache
def layout_of(model: str) -> ParamLayout:
    """The flat-row layout of the named task's parameters."""
    return ParamLayout.of(task_lib.get_task(model))


def build_schedule(cfg: P2PConfig) -> graph_lib.GraphSchedule:
    """The config's communication-graph schedule (period 1 for "static")."""
    build = lambda topo: graph_lib.build_graph(  # noqa: E731
        topo, cfg.num_peers, p=cfg.erdos_renyi_p, seed=cfg.graph_seed
    )
    if cfg.schedule == "adaptive":
        raise ValueError(
            "schedule='adaptive' has no pretraced graph sequence: each "
            "round's topology is computed on device from run state "
            "(graph.adaptive_round_matrices inside the jitted round step); "
            "there is no GraphSchedule to build"
        )
    if cfg.schedule == "static":
        return graph_lib.static_schedule(build(cfg.topology))
    if cfg.schedule == "link_dropout":
        return graph_lib.link_dropout_schedule(
            build(cfg.topology), cfg.link_survival_prob, cfg.schedule_rounds,
            seed=cfg.schedule_seed,
        )
    if cfg.schedule == "random_matching":
        return graph_lib.random_matching_schedule(
            cfg.num_peers, cfg.schedule_rounds, seed=cfg.schedule_seed
        )
    if cfg.schedule == "one_way_matching":
        return graph_lib.one_way_matching_schedule(
            cfg.num_peers, cfg.schedule_rounds, seed=cfg.schedule_seed
        )
    if cfg.schedule == "peer_churn":
        return graph_lib.peer_churn_schedule(
            build(cfg.topology), cfg.peer_online_prob, cfg.schedule_rounds,
            seed=cfg.schedule_seed,
        )
    # round_robin (the config admits no other name)
    return graph_lib.round_robin_schedule([build(t) for t in cfg.round_robin_topologies])


def mixing_constants(
    cfg: P2PConfig, data_sizes: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, graph_lib.GraphSchedule]:
    """Stacked per-round row-stochastic (W, Beta, schedule) for a config:
    (R, K, K) float64 numpy stacks, R = 1 for the static schedule (the
    reference's pre-protocol entry point, the gossip protocol's
    ``constants``)."""
    sched = build_schedule(cfg)
    w, beta = graph_lib.schedule_matrices(
        sched, cfg.mixing, data_sizes=data_sizes, consensus_step_size=cfg.consensus_step_size)
    return w, beta, sched


def _protocol_schedule(cfg: P2PConfig):
    """The config's schedule and protocol, warning (as the reference does)
    when a protocol that is not directed-capable meets a directed schedule."""
    sched = build_schedule(cfg)
    proto = protocols_lib.get_protocol(cfg.protocol)
    if sched.directed and not proto.directed_capable:
        warnings.warn(
            f"protocol {cfg.protocol!r} on a directed schedule "
            f"({sched.name!r}): a row-stochastic consensus point is biased on "
            "asymmetric graphs — use protocol='push_sum' unless the bias is "
            "deliberate",
            stacklevel=3,
        )
    return sched, proto


def protocol_constants(
    cfg: P2PConfig, data_sizes: np.ndarray | None = None
) -> tuple[protocols_lib.ProtocolConstants, graph_lib.GraphSchedule]:
    """Stacked (R, K, K) float64 round constants of the config's protocol."""
    sched, proto = _protocol_schedule(cfg)
    consts = proto.constants(
        sched, cfg.mixing, data_sizes=data_sizes,
        consensus_step_size=cfg.consensus_step_size,
    )
    return consts, sched


def init_state(
    task: task_lib.TrainTask,
    cfg: P2PConfig,
    *,
    seed: int = 0,
    data_sizes: np.ndarray | None = None,
    device: torch.device | str | None = None,
    init_params: dict[str, torch.Tensor] | None = None,
) -> P2PState:
    """Independent per-peer init (PyTorch-style default), then optional max-norm sync.

    The draw runs on the CPU, or on ``device`` for a task with
    ``init_on_device`` (a registry language model); the buffers take the
    task's type (``ParamLayout.dtype``).
    ``init_params`` (stacked (K, ...) leaves, e.g. exported from the reference
    through ``repro_torch.interop``) replaces the draw from ``seed``; max-norm
    sync still applies to it, as in the reference.  A compressed wire's
    estimate stack, and the published snapshots of bounded-staleness
    consensus (age 0), start as copies of the parameters after the sync.
    ``data_sizes`` seeds the protocol state: push-sum's mass is proportional
    to them (uniform without them).  ``schedule="adaptive"`` starts every
    row of the selection key at ``PRNGKey(adaptive_seed)`` and the losses at
    0, so round 0's loss-proximity matching is the tie-break pairing
    (0, 1), (2, 3), ...
    """
    device = resolve_device(device)
    layout = ParamLayout.of(task)
    if init_params is None:
        gen = torch.Generator(device if task.init_on_device else "cpu").manual_seed(seed)
        init = resolve_init_fn(task)
        peers = [init(gen) for _ in range(cfg.num_peers)]
        stacked = {name: torch.stack([p[name] for p in peers]) for name in task.param_shapes}
        del peers
        # the layout's types (``TrainTask.param_dtypes``) are the init's: a
        # drawn leaf of another type is refused, never cast into a block
        other = {name: str(leaf.dtype) for name, leaf in stacked.items()
                 if leaf.dtype != layout.dtype_of(name)}
        if other:
            raise TypeError(f"{task.name}'s init drew {other}, which its layout holds as "
                            f"{ {name: str(layout.dtype_of(name)) for name in other} }")
    else:
        stacked = {
            name: torch.as_tensor(init_params[name], dtype=layout.dtype_of(name))
            for name in task.param_shapes
        }
        for name, shape in task.param_shapes.items():
            if tuple(stacked[name].shape) != (cfg.num_peers, *shape):
                raise ValueError(
                    f"init_params[{name!r}] must be {(cfg.num_peers, *shape)}, "
                    f"got {tuple(stacked[name].shape)}"
                )
    if cfg.use_max_norm_init:
        stacked = consensus_lib.max_norm_sync(stacked)
    params, *wide = (block.to(device) for block in layout.flatten_blocks(stacked))
    del stacked
    comp = compression_lib.from_config(cfg)
    if wide:
        (wide,) = wide
        # copies, not aliases: the scan driver adopts each leaf's buffer
        wide = WideState(wide, *(torch.zeros_like(wide) for _ in range(3)),
                         compression=comp.init_estimate(wide),
                         published=wide.clone() if cfg.staleness_bound > 0 else ())
    staleness = ()
    if cfg.staleness_bound > 0:
        staleness = StalenessState(
            published=params.clone(),
            age=torch.zeros(cfg.num_peers, dtype=torch.int32, device=device))
    adaptive = ()
    if cfg.schedule == "adaptive":
        adaptive = AdaptiveState(
            key=prng.prng_key(cfg.adaptive_seed, device).repeat(cfg.num_peers, 1),
            last_losses=torch.zeros(cfg.num_peers, dtype=torch.float32, device=device))
    return P2PState(
        params=params,
        momentum=torch.zeros_like(params),
        d_bias=torch.zeros_like(params),
        b_bias=torch.zeros_like(params),
        round_idx=0,
        protocol=protocols_lib.get_protocol(cfg.protocol).init_state(params, data_sizes),
        adaptive=adaptive,
        compression=comp.init_estimate(params),
        staleness=staleness,
        wide=wide or (),
    )


def step_batch(batches, t: int):
    """Local step ``t``'s batch of a round's batch tree: every (T, K, ...)
    leaf's row t, the tree's structure kept (``(x, y)`` or the registry's
    ``{"tokens", "labels", ...}``, leaves of any types)."""
    return pytree.tree_map(lambda leaf: leaf[t], batches)


def local_phase(
    state: P2PState,
    task: task_lib.TrainTask,
    batches,
    cfg: P2PConfig,
    *,
    steps_k: np.ndarray | None = None,
) -> tuple[P2PState, torch.Tensor]:
    """Run T local SGD steps on every peer (Eq. 3): ``local_phase_stats``
    with its (T, K) losses reduced to the per-step mean over peers, (T,)."""
    state, losses = local_phase_stats(state, task, batches, cfg, steps_k=steps_k)
    return state, losses.mean(dim=1)


def local_phase_stats(
    state: P2PState,
    task: task_lib.TrainTask,
    batches,
    cfg: P2PConfig,
    *,
    steps_k: np.ndarray | None = None,
) -> tuple[P2PState, torch.Tensor]:
    """Run T local SGD steps on every peer (Eq. 3), keeping every step's
    per-peer losses (the reference's ``_local_phase_stats``: adaptive
    selection reads each peer's mean).

    ``batches`` = (x (T, K, B, ...), y (T, K, B)), step-major then peer, or
    any tree of (T, K, ...) leaves (a language model's ``{"tokens",
    "labels"}``, with a vlm's float32 ``"patches"``): step t gets every
    leaf's row t (``step_batch``).
    ``steps_k`` ((K,) int32 on the host, ``steps_budget``) caps peer k at
    ``steps_k[k]`` updates: every step still runs for every peer, and from
    step ``steps_k[k]`` on peer k's parameters and momentum (its ``eta_d d``
    with them) are held, their rows copied back over the step's result (the
    reference's ``jnp.where`` on the step index; the rows are known on the
    host, so a captured round replays the same copies); a finished peer
    reports its frozen parameters' loss on each later step's batch.  None
    (the "uniform" profile) is the unmasked loop.
    Returns (new_state, losses (T, K)).

    Each step writes its results into buffers the phase owns (the first
    step's fresh products, then the same buffers in place; a held peer's
    rows are saved before the update and written back after it), and with
    momentum each leaf's gradient is added into its view of the momentum
    buffer as autograd returns it, with no flat copy: the arithmetic is the
    functional form's, operation for operation, and a step holds at most one
    (K, row) temporary beside the leaves' gradients, which lets the two
    peers of a 1.9 B-parameter model train on one 80 GB card.  A mixed
    task's float32 block (``P2PState.wide``) takes the same steps beside the
    first, each leaf's gradient into its own block's momentum.
    """
    layout = ParamLayout.of(task)
    params, mom, d_bias = (blocks(state, f) for f in ("params", "momentum", "d_bias"))
    step_losses = []
    for t in range(cfg.local_steps):
        views = layout.views(*(p.detach().requires_grad_(True) for p in params))
        losses = task.loss_fn(views, step_batch(batches, t))  # (K,)
        # the peers share no parameters, so the gradient of the summed loss
        # is every peer's own gradient, stacked; a leaf the loss does not
        # read (a vlm's projector on a text-only batch) gets zeros, as jax.grad
        grads = list(torch.autograd.grad(losses.sum(), list(views.values()),
                                         materialize_grads=True))
        held = [] if steps_k is None else [  # (rows, their parameters, their momentum)
            (rows, [p[rows].clone() for p in params],
             [m[rows].clone() for m in mom] if cfg.momentum else None)
            for rows in _held_rows(steps_k, t)]
        owned = t > 0  # from step 1 on params and mom are the phase's own buffers
        if cfg.momentum:
            # momentum * mom + grads, each leaf's gradient summed into its view
            # of the product's buffer and released
            new_mom = [m.mul_(cfg.momentum) if owned else cfg.momentum * m for m in mom]
            for i, view in enumerate(layout.views(*new_mom).values()):
                view.add_(grads[i])
                grads[i] = None
            update = new_mom
        else:
            new_mom, update = mom, layout.flatten_blocks(dict(zip(views, grads)))
        del grads
        new_params = []
        for p, u, d in zip(params, update, d_bias):
            if owned:  # params - lr * update, in place
                p = p.sub_(cfg.lr * u)
            else:
                p = p - cfg.lr * u
            if cfg.use_affinity_d:  # d fixed during the local phase; p is never an input
                p.add_(cfg.eta_d * d)
            new_params.append(p)
        for rows, held_params, held_mom in held:
            for p, kept in zip(new_params, held_params):
                p[rows] = kept
            if cfg.momentum:
                for m, kept in zip(new_mom, held_mom):
                    m[rows] = kept
        params, mom = new_params, new_mom
        step_losses.append(losses.detach())
    b_bias = blocks(state, "b_bias")
    if cfg.use_affinity_b:
        b_bias = [p / max(cfg.consensus_steps, 1) for p in params]
    state = with_blocks(state, params=params, momentum=mom, b_bias=b_bias)
    return state, torch.stack(step_losses)


def _consensus_steps(state: P2PState, cfg: P2PConfig, mix, begin=None) -> P2PState:
    """S consensus steps of ``mix(proto_state, params, i) -> (proto_state,
    mixed, d_step)`` on each parameter block i (``param_blocks``): d
    refreshed from each step's incoming neighbors (Eq. 3's bias, Sec.
    IV-A), ``eta_b * b`` added after each mix (Eq. 4).  A mixed task's
    float32 block takes each step after the first block, from the same
    protocol state: push-sum's mass is a peer's, so it advances once a step
    (the first block's y'; the float32 block's launch computes the same y'
    from the same mass and weights).  ``begin(proto_state)``, once a step
    where given, is the protocol state the step's mixes read (the sharded
    runtime's: push-sum's mass of every in-neighbor, exchanged once)."""
    params, d_bias, b_bias = (blocks(state, f) for f in ("params", "d_bias", "b_bias"))
    proto_state = state.protocol
    for _ in range(cfg.consensus_steps):
        step_state = proto_state if begin is None else begin(proto_state)
        for i, x in enumerate(params):
            new_state, mixed, d_step = mix(step_state, x, i)
            if i == 0:
                proto_state = new_state
            if cfg.use_affinity_d:
                d_bias[i] = d_step
            if cfg.use_affinity_b:
                mixed = mixed + cfg.eta_b * b_bias[i]
            params[i] = mixed
    state = state._replace(protocol=proto_state, round_idx=state.round_idx + 1)
    return with_blocks(state, params=params, d_bias=d_bias)


def check_layout(layout: ParamLayout, state: P2PState) -> None:
    """Raise ValueError unless ``layout``'s blocks are the state's parameter
    buffers, row for row and type for type: a compressed wire quantizes
    leaf by leaf, so another task's layout would quantize the wrong
    columns."""
    want = [(blk.row, blk.dtype) for blk in layout.blocks]
    got = [(b.shape[-1], b.dtype) for b in param_blocks(state)]
    if got != want:
        raise ValueError(f"the layout's blocks (row, type) {want} are not the state's {got}: "
                         "pass the task's layout (ParamLayout.of(task))")


def consensus_phase(
    state: P2PState, cfg: P2PConfig, ops: SparseRoundOps | protocols_lib.StaleRoundOps,
    *, layout: ParamLayout | None = None,
) -> P2PState:
    """Run S consensus steps through the fused kernel; refreshes d en route.

    ``ops`` are the round's operands (``round_operands``): sparse ones, or
    with ``staleness_bound > 0`` a ``protocols.StaleRoundOps``.  Each
    step's d comes from the *incoming* neighbor parameters of that step
    (Sec. IV-A); peers with an all-zero beta row keep d = 0.  A compressed
    wire takes ``_consensus_phase_compressed`` (its leaves from ``layout``,
    the task's; ``layout_of(cfg.model)`` when None; ``check_layout``
    refuses a layout that is not the state's), bounded staleness
    ``_consensus_phase_async``.  Each mode mixes every block of a mixed
    task, one launch a block a step (``_consensus_steps``).
    """
    if cfg.consensus_steps == 0:
        return state._replace(round_idx=state.round_idx + 1)
    proto = protocols_lib.get_protocol(cfg.protocol)
    comp = compression_lib.from_config(cfg)
    if not comp.identity:
        layout = layout or layout_of(cfg.model)
        check_layout(layout, state)
        return _consensus_phase_compressed(state, cfg, ops, proto, comp, layout)
    if cfg.staleness_bound > 0:
        return _consensus_phase_async(state, cfg, ops, proto)
    return _consensus_steps(
        state, cfg, lambda ps, x, _i: proto.mix(ps, x, ops, cfg.local_steps)
    )


def _consensus_phase_compressed(
    state: P2PState,
    cfg: P2PConfig,
    ops: SparseRoundOps,
    proto: protocols_lib.ConsensusProtocol,
    comp: compression_lib.Compressor,
    layout: ParamLayout,
) -> P2PState:
    """``consensus_phase`` when consensus messages cross a compressed wire.

    Each step, on each block: compress the parameter-to-estimate difference
    ``x - x̂`` leaf by leaf (the block's leaves: its (K, L) scale table);
    advance the estimate stack by the payload (``x̂ <- x̂ + D(payload)``);
    mix the convex form, self term on the true parameters and off-diagonal
    terms on the advanced estimates; and take d from estimate differences,
    ``d = (sum_j beta_kj x̂_j - x̂_k) / T`` (0 for a zero beta row).  qint8's
    advance happens inside the ``dequant_mix`` kernel that mixes; top-k's is a
    scatter before it.
    """
    leaves = layout.blocks
    ests = blocks(state, "compression")

    def mix(proto_state, x, i):
        payload = comp.ef_flat(x, ests[i], leaves[i])
        proto_state, mixed, d_step, ests[i] = proto.mix_compressed(
            proto_state, x, payload, ops, leaves[i].leaf_offsets, cfg.local_steps)
        return proto_state, mixed, d_step

    return with_blocks(_consensus_steps(state, cfg, mix), compression=ests)


def staleness_delivery(
    cfg: P2PConfig, scheduled: torch.Tensor, age: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One async round's delivery from the (K,) snapshot ages (the
    reference's ``_staleness_delivery``), on the device: sender k delivers
    when ``scheduled[k]`` (its compute schedule, a row of
    ``publication_table``) or when its snapshot would otherwise pass the
    bound, ``age + 1 > staleness_bound``.  Returns (delivered (K,) bool,
    new age (K,) int32, 0 where delivered, decay (K,) float32
    ``staleness_decay ** new_age``)."""
    delivered = scheduled | (age + 1 > cfg.staleness_bound)
    new_age = torch.where(delivered, torch.zeros_like(age), age + 1)
    base = torch.full_like(new_age, cfg.staleness_decay, dtype=torch.float32)
    return delivered, new_age, torch.pow(base, new_age.to(torch.float32))


def _consensus_phase_async(
    state: P2PState,
    cfg: P2PConfig,
    ops: protocols_lib.StaleRoundOps,
    proto: protocols_lib.ConsensusProtocol,
) -> P2PState:
    """``consensus_phase`` under bounded-staleness delivery (the reference's
    ``_consensus_phase_async``).

    Once a round: decide delivery (``staleness_delivery``), make the
    delivering senders' live post-local rows their published snapshots,
    and age-decay the round's operands (``protocols.age_decayed_operands``:
    gossip rows and push-sum columns stay stochastic, so push-sum's mass
    is conserved).  Then S steps through the ``consensus_mix`` kernel's
    snapshot mode: the self term and d's own term on the live parameters,
    every neighbor term on the published buffer, d from the decayed,
    renormalised beta.  A peer's support for d is its beta row: decay
    shrinks weights but disconnects no one (the kernel reads the decayed
    row, which is zero only where the raw one is, unless
    ``staleness_decay ** staleness_bound`` underflows float32).
    """
    st: StalenessState = state.staleness
    delivered, age, decay = staleness_delivery(cfg, ops.scheduled, st.age)
    # one delivery rule and one set of ages for both blocks of a mixed task
    published = [torch.where(delivered[:, None], x, p)
                 for x, p in zip(param_blocks(state), blocks(state, "published"))]
    a_ops = protocols_lib.age_decayed_operands(ops, decay, proto.stochasticity)
    state = _consensus_steps(state, cfg, lambda ps, x, i: proto.mix_stale(
        ps, x, published[i], a_ops, cfg.local_steps))
    state = state._replace(staleness=st._replace(age=age))
    return with_blocks(state, published=published)


def run_round(
    state: P2PState,
    task: task_lib.TrainTask,
    batches,
    cfg: P2PConfig,
    ops: SparseRoundOps | protocols_lib.StaleRoundOps | AdaptiveRoundOps,
    *,
    steps_k: np.ndarray | None = None,
) -> tuple[P2PState, P2PState, torch.Tensor]:
    """One full round: (state_after_local, state_after_consensus, losses (T,));
    ``batches`` a tree of (T, K, ...) leaves (``local_phase_stats``),
    ``steps_k`` the per-peer step budgets (``steps_budget``).  An adaptive
    schedule's round is ``run_adaptive_round``."""
    if cfg.schedule == "adaptive":
        return run_adaptive_round(state, task, batches, cfg, ops, steps_k=steps_k)
    after_local, losses = local_phase(state, task, batches, cfg, steps_k=steps_k)
    return after_local, consensus_phase(after_local, cfg, ops,
                                        layout=ParamLayout.of(task)), losses


def adaptive_operands(
    ad: AdaptiveState, cfg: P2PConfig, ops: AdaptiveRoundOps
) -> tuple[SparseRoundOps, torch.Tensor]:
    """(the round's dense operands, the next round's key) from the
    selection state (the reference's ``adaptive_consts``): split the key,
    match on the previous losses (``graph.adaptive_round_matrices``, row- or
    column-stochastic as the protocol mixes), gather the kernel's operands
    from W and Beta (``dense_operands``).  All on the device."""
    key_round, key_next = prng.split(ad.key[0])
    w, beta = graph_lib.adaptive_round_matrices(
        ad.last_losses, key_round, rule=cfg.partner_rule, eps=cfg.adaptive_eps,
        data_sizes=ops.data_sizes, consensus_step_size=cfg.consensus_step_size,
        stochasticity=protocols_lib.get_protocol(cfg.protocol).stochasticity)
    return dense_operands(w, beta, ops.nbr_idx), key_next


def run_adaptive_round(
    state: P2PState,
    task: task_lib.TrainTask,
    batches,
    cfg: P2PConfig,
    ops: AdaptiveRoundOps,
    *,
    steps_k: np.ndarray | None = None,
) -> tuple[P2PState, P2PState, torch.Tensor]:
    """One adaptive round, in the reference's order: this round's operands
    from the previous round's losses and the key (``adaptive_operands``),
    the local phase, then the selection state's update (this round's
    per-peer mean losses, the next key) in the after-local state, and the
    consensus phase over the round's dense operands.  Returns
    (state_after_local, state_after_consensus, losses (T,))."""
    dense, key_next = adaptive_operands(state.adaptive, cfg, ops)
    after_local, losses = local_phase_stats(state, task, batches, cfg, steps_k=steps_k)
    after_local = after_local._replace(adaptive=AdaptiveState(
        key=key_next.expand_as(state.adaptive.key).contiguous(),
        last_losses=losses.mean(dim=0)))
    return (after_local, consensus_phase(after_local, cfg, dense, layout=ParamLayout.of(task)),
            losses.mean(dim=1))


def schedule_operands(
    cfg: P2PConfig,
    data_sizes: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
) -> SparseRoundOps:
    """The sparse operands of the schedule's whole period, stacked (R, K) /
    (R, K, D), built from its graphs (the protocol's ``operands``: row- or
    column-stochastic) and uploaded to ``device`` once; round ``r`` of a run
    uses ``r % R``."""
    device = resolve_device(device)
    sched, proto = _protocol_schedule(cfg)
    return proto.operands(
        sched, cfg.mixing, data_sizes=data_sizes,
        consensus_step_size=cfg.consensus_step_size, device=device,
    )


def round_picker(
    cfg: P2PConfig,
    data_sizes: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
) -> tuple[Callable[[int], SparseRoundOps | protocols_lib.StaleRoundOps | AdaptiveRoundOps],
           int]:
    """``(pick, period)``: ``pick(r)`` is round r's operands as the round
    step takes them, views of one upload made here, and repeats every
    ``period`` rounds.  Synchronous: the schedule's sparse operands, period
    R.  ``staleness_bound > 0``: a ``protocols.StaleRoundOps`` with the
    round's column sums and its row of ``publication_table``, period the
    least common multiple of R and the table's P.  Adaptive: the static
    ``AdaptiveRoundOps`` (the round's W and Beta come from the state), period
    1."""
    device = resolve_device(device)
    if cfg.schedule == "adaptive":
        sizes = np.ones(cfg.num_peers) if data_sizes is None else np.asarray(data_sizes)
        ops = AdaptiveRoundOps(complete_candidates(cfg.num_peers, device),
                               torch.as_tensor(sizes, dtype=torch.float32, device=device))
        return lambda r: ops, 1
    if cfg.staleness_bound == 0:
        stacked = schedule_operands(cfg, data_sizes, device=device)
        return functools.partial(select_round, stacked), stacked.self_w.shape[0]
    sched, proto = _protocol_schedule(cfg)
    sparse = proto.sparse_schedule(sched, cfg.mixing, data_sizes=data_sizes,
                                   consensus_step_size=cfg.consensus_step_size)
    stacked = upload_schedule(sparse, device)
    col = torch.as_tensor(protocols_lib.column_sums(sparse), device=device)
    table = torch.as_tensor(publication_table(cfg), device=device)
    r_period, p_period = sparse.period, table.shape[0]

    def pick(r: int) -> protocols_lib.StaleRoundOps:
        return protocols_lib.StaleRoundOps(*select_round(stacked, r), col[r % r_period],
                                           table[r % p_period])

    return pick, math.lcm(r_period, p_period)


def round_operands(
    cfg: P2PConfig,
    data_sizes: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
) -> list[SparseRoundOps | protocols_lib.StaleRoundOps | AdaptiveRoundOps]:
    """Every period round's operands (``round_picker``), views of one
    upload; round ``r`` of a run uses entry ``r % period``."""
    pick, period = round_picker(cfg, data_sizes, device=device)
    return [pick(r) for r in range(period)]


def make_round_fn(
    task: task_lib.TrainTask,
    cfg: P2PConfig,
    data_sizes: np.ndarray | None = None,
    *,
    device: torch.device | str | None = None,
) -> Callable[[P2PState, tuple], tuple[P2PState, P2PState, torch.Tensor]]:
    """Round closure over the schedule: the operands of every round of the
    period, and the profile's step budgets, are built and uploaded once,
    here (``round_operands``, ``steps_budget``); round ``r`` uses those of
    ``r % period``."""
    ops = round_operands(cfg, data_sizes, device=device)
    period = len(ops)
    steps_k = steps_budget(cfg)

    def step(state: P2PState, batches):
        return run_round(state, task, batches, cfg, ops[state.round_idx % period],
                         steps_k=steps_k)

    return step


MIX_MODES = ("auto", "bridge", "segment")
_BRIDGE_MAX_PEERS = 64  # "auto" uses the bit-parity bridge mix up to here


def check_hierarchical_layout(num_peers: int, peers_per_device: int,
                              num_ranks: int | None = None) -> int:
    """Validate a hierarchical layout of ``num_peers`` peers, block-major over
    ``num_peers / peers_per_device`` slices (peer g on slice g // p): one
    device holding every peer, or one rank of a ``core.peer_group`` run a
    slice (``num_ranks``, where given, must be K / p; the reference's
    ``sharding.specs.hierarchical_layout``).  Returns the number of slices."""
    if peers_per_device < 2:
        raise ValueError(
            "peers_per_device must be >= 2 for the hierarchical runtime "
            "(peers_per_device=1 is the ordinary sharded runtime)"
        )
    if num_peers % peers_per_device:
        raise ValueError(
            f"peers_per_device={peers_per_device} does not divide num_peers={num_peers}"
        )
    if num_ranks is not None and num_peers != peers_per_device * num_ranks:
        raise ValueError(
            f"num_peers={num_peers} != peers_per_device={peers_per_device} "
            f"x mesh axis 'pod'={num_ranks}"
        )
    return num_peers // peers_per_device


def resolve_mix_mode(mix_mode: str, num_peers: int) -> str:
    """The hierarchical mix a run uses: "auto" is "bridge" iff K <= 64."""
    if mix_mode not in MIX_MODES:
        raise ValueError(f"unknown mix_mode {mix_mode!r}; one of {MIX_MODES}")
    if mix_mode == "auto":
        return "bridge" if num_peers <= _BRIDGE_MAX_PEERS else "segment"
    return mix_mode


def consensus_phase_hier(
    state: P2PState, cfg: P2PConfig, ops_s: SparseRoundOps, *, mix_mode: str
) -> P2PState:
    """``consensus_phase`` of the one-slice hierarchical runtime, over round
    ``state.round_idx % R`` of the stacked (R, K) / (R, K, D) operands.

    "bridge": the vmap runtime's ``consensus_mix`` step on the round's
    operands, bit for bit.  "segment": the ``segment_mix`` kernel, with
    ``d = where(has_nbrs, (sum_s beta x_nbr - x) / T, 0)`` and ``has_nbrs``
    from the raw beta row; its slot-ordered sums are allclose to the dense
    mix, not bit-identical.  Several slices, one process each, are
    ``consensus_phase_hier_sharded``.
    """
    if cfg.consensus_steps == 0:
        return state._replace(round_idx=state.round_idx + 1)
    proto = protocols_lib.get_protocol(cfg.protocol)
    return _consensus_steps(state, cfg, lambda ps, x, _i: proto.mix_hier(
        ps, x, ops_s, state.round_idx, cfg.local_steps, mode=mix_mode))


def make_hier_round_fn(
    task: task_lib.TrainTask,
    cfg: P2PConfig,
    data_sizes: np.ndarray | None = None,
    *,
    peers_per_device: int,
    mix_mode: str = "auto",
    device: torch.device | str | None = None,
) -> Callable[[P2PState, tuple], tuple[P2PState, P2PState, torch.Tensor]]:
    """Round closure of the one-slice hierarchical runtime: all K =
    ``peers_per_device`` peers on one device, the same local phase as the
    vmap runtime, consensus through ``consensus_phase_hier`` over the
    degree-bounded schedule (the counterpart of the reference's
    ``make_sharded_round_fn(..., peers_per_device=K, mix_mode=...)`` on a
    one-device mesh).  The stacked (R, K, D) operands are uploaded once,
    here; round ``r`` uses those of ``r % R``.  Fewer peers a device than K
    need a process a slice: a rank's round is ``make_sharded_round_fn(...,
    peers_per_device=p)``, and this raises ``ValueError``.
    """
    step = _hier_round_step(task, cfg, peers_per_device, mix_mode)
    ops_s = schedule_operands(cfg, data_sizes, device=device)
    return lambda state, batches: step(state, batches, ops_s)


def _hier_round_step(task: task_lib.TrainTask, cfg: P2PConfig, peers_per_device: int,
                     mix_mode: str):
    """The one-slice hierarchical round ``step(state, batches, ops_s)`` over
    stacked (R, K) / (R, K, D) operands, after validating the layout."""
    features_lib.check_config(cfg, peers_per_device=peers_per_device)
    mode = resolve_mix_mode(mix_mode, cfg.num_peers)
    if check_hierarchical_layout(cfg.num_peers, peers_per_device) > 1:
        raise ValueError(
            f"peers_per_device={peers_per_device} < num_peers={cfg.num_peers} needs a group "
            "(hierarchical runtime over several slices): run a rank's round, "
            "make_sharded_round_fn(task, cfg, group, peers_per_device=p), in each of the "
            "K / p ranks of core.peer_group.spawn_peers"
        )

    def step(state: P2PState, batches, ops_s: SparseRoundOps):
        after_local, losses = local_phase(state, task, batches, cfg)
        after_cons = consensus_phase_hier(after_local, cfg, ops_s, mix_mode=mode)
        return after_local, after_cons, losses

    return step


# ---------------------------------------------------------------------------
# The sharded runtime: one process per peer (peer_axis="pod", one peer a device)
# ---------------------------------------------------------------------------


def _map_per_peer(state: P2PState, fn) -> P2PState:
    """``state`` with ``fn`` applied to every per-peer tensor (params .. b,
    the protocol's, the adaptive key and losses, the published snapshots and
    their ages, a mixed task's float32 block); a compressed wire's estimate
    stacks, which every rank carries whole, are kept as they are."""
    wide = state.wide
    if wide:
        wide = WideState(*(fn(f) if isinstance(f, torch.Tensor) and name != "compression"
                           else f for name, f in zip(WideState._fields, wide)))
    return state._replace(
        params=fn(state.params), momentum=fn(state.momentum), d_bias=fn(state.d_bias),
        b_bias=fn(state.b_bias),
        protocol=type(state.protocol)(*map(fn, state.protocol)) if state.protocol else (),
        adaptive=AdaptiveState(*map(fn, state.adaptive)) if state.adaptive else (),
        staleness=StalenessState(*map(fn, state.staleness)) if state.staleness else (),
        wide=wide)


def shard_state(state: P2PState, rank: int, peers_per_device: int = 1) -> P2PState:
    """A rank's block of a stacked state: rows ``rank * p`` .. ``rank * p +
    p - 1`` (p = ``peers_per_device``) of every per-peer tensor, as (p, ...)
    copies (the compressed wire's estimate stacks stay whole: every rank
    carries the replicated (K, row) stack, as the reference's does).  Every
    rank draws the same stacked ``init_state`` and keeps its block, so a
    sharded run starts where a vmap run starts."""
    row0 = rank * peers_per_device
    return _map_per_peer(state, lambda t: t[row0:row0 + peers_per_device].clone())


def unshard_state(group, state: P2PState) -> P2PState:
    """The stacked state of a sharded run, on every rank: each per-peer
    tensor's blocks all-gathered in rank order (a collective: every rank
    calls it)."""
    return _map_per_peer(state, lambda t: group.all_gather(t).reshape(-1, *t.shape[1:]))


def inbox_bytes(task: task_lib.TrainTask, cfg: P2PConfig, *, peers_per_device: int = 1,
                mix_mode: str = "auto", whole_blocks: bool = False) -> int:
    """The largest tensor a rank of a sharded run all-gathers or exchanges:
    with one peer a rank a parameter row (the compressed wire's payloads and
    the scalars are smaller).  With a block of p peers a rank, the (T, p)
    losses and the (p,) masses, and in "bridge" mode, or where the caller
    gathers the state itself (``whole_blocks``, e.g. to evaluate it), the
    (p, row) parameter blocks; "segment" mode streams its blocks through the
    ring inboxes (``ring_bytes``)."""
    p = peers_per_device
    rows = [p * blk.row * blk.dtype.itemsize for blk in ParamLayout.of(task).blocks]
    scalars = 4 * p * max(cfg.local_steps, 1)
    if p > 1 and resolve_mix_mode(mix_mode, cfg.num_peers) == "segment" and not whole_blocks:
        return max(scalars, 64)
    return max(*rows, scalars, 64)


def ring_bytes(task: task_lib.TrainTask, cfg: P2PConfig, *, peers_per_device: int = 1,
               mix_mode: str = "auto") -> int:
    """The largest block a rank ring-shifts: the (p, row) parameter block in
    the hierarchical runtime's "segment" mode, else 0 (no ring)."""
    p = peers_per_device
    if p == 1 or resolve_mix_mode(mix_mode, cfg.num_peers) != "segment":
        return 0
    return max(p * blk.row * blk.dtype.itemsize for blk in ParamLayout.of(task).blocks)


def _row_of(proto_state, row: int):
    """A rank's protocol state from a mix over every row (push-sum's y')."""
    return type(proto_state)(*(t[row:row + 1] for t in proto_state)) if proto_state else ()


def _own_rows(x: torch.Tensor, k: int, row: int) -> torch.Tensor:
    """A (K, N) buffer holding the rank's (1, N) row at its index, zeros
    elsewhere (the kernels read the self term there and nothing else)."""
    full = x.new_zeros((k, x.shape[1]))
    full[row] = x[0]
    return full


def consensus_phase_sharded(
    state: P2PState, cfg: P2PConfig, ops: SparseRoundOps | protocols_lib.StaleRoundOps,
    *, group, lanes, layout: ParamLayout | None = None,
) -> P2PState:
    """``consensus_phase`` of one rank of the sharded runtime.

    Every per-peer tensor of ``state`` is the rank's (1, ...) block; ``ops``
    are the round's operands of all K peers (replicated: they are small next
    to the parameters).  Each consensus step exchanges each parameter block's
    row once over ``lanes`` (``group.exchange``: the reference's one
    ``ppermute`` a lane; the flat layout makes its leaf pipelining moot) and
    launches the stacked step's kernel on the (K, N) stack of the rank's row
    and its in-neighbors' rows, the rank's row as the launch's row range:
    the row equals the stacked step's bit for bit.  Push-sum's mass rides its
    own lane once a step (``mix_sharded_begin``).  A protocol that overrides
    only ``mix_sharded`` runs through it, d from the kernel.  A compressed
    wire takes ``_consensus_phase_sharded_compressed``, bounded staleness
    ``_consensus_phase_sharded_async``.
    """
    if cfg.consensus_steps == 0:
        return state._replace(round_idx=state.round_idx + 1)
    proto = protocols_lib.get_protocol(cfg.protocol)
    comp = compression_lib.from_config(cfg)
    if not comp.identity:
        layout = layout or layout_of(cfg.model)
        check_layout(layout, state)
        return _consensus_phase_sharded_compressed(state, cfg, ops, proto, comp, layout,
                                                   group=group, lanes=lanes)
    if cfg.staleness_bound > 0:
        return _consensus_phase_sharded_async(state, cfg, ops, proto, group=group, lanes=lanes)
    me, t = group.rank, cfg.local_steps
    if type(proto).mix_sharded_leaf is protocols_lib.ConsensusProtocol.mix_sharded_leaf:
        def legacy(ps, x, _i):  # the whole-block override; d from the kernel's launch
            x_full = group.exchange(x, lanes)
            _, d_step = cm_ops.consensus_mix_stacked(x_full, ops, t, rows=(me, 1))
            ps, mixed = proto.mix_sharded(ps, x, x_full, ops, group=group, lanes=lanes)
            return ps, mixed, d_step

        return _consensus_steps(state, cfg, legacy)
    return _consensus_steps(
        state, cfg,
        lambda ps, x, _i: proto.mix_sharded_leaf(ps, group.exchange(x, lanes), ops, me, t),
        begin=lambda ps: proto.mix_sharded_begin(ps, group=group, lanes=lanes))


def _consensus_phase_sharded_compressed(
    state: P2PState, cfg: P2PConfig, ops: SparseRoundOps, proto: protocols_lib.ConsensusProtocol,
    comp: compression_lib.Compressor, layout: ParamLayout, *, group, lanes,
) -> P2PState:
    """``consensus_phase_sharded`` over a compressed wire (the reference's
    ``_consensus_phase_sharded_compressed``): each step, each rank
    compresses its own row's difference to its public estimate
    (``comp.wire``), the payloads are all-gathered, and every rank advances
    the replicated (K, row) estimate stack by all of them (the reference's
    simulation: replicas stay equal because every rank advances every row
    from the same payloads), mixing through the stacked step's
    ``dequant_mix`` launch on a (K, row) buffer holding the rank's true row
    (the kernel reads the other rows' estimates, not their parameters) and
    keeping its row.  Push-sum's mass rides the lanes uncompressed."""
    leaves = layout.blocks
    ests = blocks(state, "compression")
    me, k = group.rank, cfg.num_peers

    def mix(ps_full, x, i):
        shipped = [group.all_gather(part[0]) for part in comp.wire(x, ests[i][me:me + 1],
                                                                   leaves[i])]
        payload = comp.receive(ests[i], shipped, leaves[i])
        ps, mixed, d_step, ests[i] = proto.mix_compressed(
            ps_full, _own_rows(x, k, me), payload, ops, leaves[i].leaf_offsets, cfg.local_steps)
        return _row_of(ps, me), mixed[me:me + 1].clone(), d_step[me:me + 1].clone()

    state = _consensus_steps(state, cfg, mix,
                             begin=lambda ps: proto.mix_sharded_begin(ps, group=group,
                                                                      lanes=lanes))
    return with_blocks(state, compression=ests)


def _consensus_phase_sharded_async(
    state: P2PState, cfg: P2PConfig, ops: protocols_lib.StaleRoundOps,
    proto: protocols_lib.ConsensusProtocol, *, group, lanes,
) -> P2PState:
    """``consensus_phase_sharded`` under bounded staleness (the reference's
    ``_consensus_phase_sharded_async``): the K snapshot ages are
    all-gathered, so every rank decides the same delivery and decays the
    same operands; the published rows travel over the lanes once a round
    (delivery is per round), and each step launches the snapshot mode on
    the rank's live row and the exchanged snapshots, its row only."""
    st: StalenessState = state.staleness
    me, k = group.rank, cfg.num_peers
    delivered, age, decay = staleness_delivery(cfg, ops.scheduled, group.all_gather(st.age[0]))
    published = [torch.where(delivered[me:me + 1, None], x, p)
                 for x, p in zip(param_blocks(state), blocks(state, "published"))]
    a_ops = protocols_lib.age_decayed_operands(ops, decay, proto.stochasticity)
    pub_full = [group.exchange(p, lanes) for p in published]
    state = _consensus_steps(
        state, cfg,
        lambda ps, x, i: proto.mix_stale_sharded(ps, _own_rows(x, k, me), pub_full[i], a_ops, me,
                                                 cfg.local_steps),
        begin=lambda ps: proto.mix_sharded_begin(ps, group=group, lanes=lanes))
    state = state._replace(staleness=st._replace(age=age[me:me + 1]))
    return with_blocks(state, published=published)


def _local_phase_at_width(state: P2PState, task: task_lib.TrainTask, batches, cfg: P2PConfig,
                          width: int, steps_k: np.ndarray | None
                          ) -> tuple[P2PState, torch.Tensor]:
    """A rank's local phase (``local_phase_stats`` on its (p, ...) block) run
    on ``width`` rows, copies of its block and its batches (a multiple of
    p), the first p kept: at the vmap runtime's width the card's libraries
    take the vmap runtime's kernels (cuBLAS picks a GEMM by its batch
    count), so the rows come out as the vmap runtime's bit for bit.  Returns
    (state, losses (T, p))."""
    p = state.params.shape[0]
    if width == p:
        return local_phase_stats(state, task, batches, cfg, steps_k=steps_k)
    if width % p:
        raise ValueError(f"local_width={width} is not a multiple of the rank's {p} peers")
    copies = width // p
    tile = lambda t: t.repeat(copies, *(1,) * (t.dim() - 1))  # noqa: E731
    fields = ("params", "momentum", "d_bias", "b_bias")
    wide = with_blocks(state, **{f: [tile(b) for b in blocks(state, f)] for f in fields})
    wide_batches = pytree.tree_map(
        lambda leaf: leaf.repeat(1, copies, *(1,) * (leaf.dim() - 2)), batches)
    out, losses = local_phase_stats(wide, task, wide_batches, cfg,
                                    steps_k=None if steps_k is None else np.tile(steps_k, copies))
    out = with_blocks(out, **{f: [b[:p].clone() for b in blocks(out, f)] for f in fields})
    return out, losses[:, :p]


def consensus_phase_hier_sharded(
    state: P2PState, cfg: P2PConfig, ops: SparseRoundOps, *, group, mode: str, row0: int,
) -> P2PState:
    """``consensus_phase`` of a rank of the hierarchical runtime over
    several ranks (the reference's ``consensus_phase_hier`` inside its
    shard_map block): every per-peer tensor of ``state`` is the rank's
    (p, ...) block, rows ``row0`` .. ``row0 + p - 1`` of the fleet.

    "bridge": ``ops`` are the round's operands of all K peers; each step
    all-gathers each parameter block into the (K, N) stack and launches the
    vmap runtime's step on it with the block's rows as the row range, so
    every row is the vmap runtime's bit for bit (push-sum all-gathers the
    (K,) mass once a step).  "segment": ``ops`` are the block's (p,) /
    (p, D) rows of the round; each step ring-gathers the block's (p, D, N)
    neighbor slots (``consensus.ring_gather_slots``) and launches the slot
    form of ``segment_mix`` (push-sum ring-gathers the (p, D) sender masses
    once a step): no (K, ...) tensor, slot-ordered sums.  d comes from the
    kernels, 0 for a peer whose raw beta row is 0.
    """
    if cfg.consensus_steps == 0:
        return state._replace(round_idx=state.round_idx + 1)
    proto = protocols_lib.get_protocol(cfg.protocol)
    if mode == "bridge":
        def view(x):
            return group.all_gather(x).reshape(-1, *x.shape[1:])
    elif mode == "segment":
        def view(x):
            return consensus_lib.ring_gather_slots(x, ops.nbr_idx, group)
    else:
        raise ValueError(f"unknown mix_mode {mode!r}; 'bridge' or 'segment'")
    t = cfg.local_steps
    return _consensus_steps(
        state, cfg,
        lambda ps, x, _i: proto.mix_hier_leaf(ps, x, view(x), ops, row0, t, mode=mode),
        begin=lambda ps: proto.mix_hier_begin(ps, group=group, mode=mode, nbr_idx=ops.nbr_idx))


def _make_hier_sharded_round_fn(task: task_lib.TrainTask, cfg: P2PConfig, group,
                                data_sizes: np.ndarray | None, peers_per_device: int,
                                mix_mode: str, local_width: int | None):
    """``make_sharded_round_fn`` with a block of p = ``peers_per_device``
    peers a rank (the reference's ``_make_hier_round_step``)."""
    features_lib.check_config(cfg, peers_per_device=peers_per_device)
    mode = resolve_mix_mode(mix_mode, cfg.num_peers)
    check_hierarchical_layout(cfg.num_peers, peers_per_device, group.size)
    p, k = peers_per_device, cfg.num_peers
    row0 = group.rank * p
    ops_s = schedule_operands(cfg, data_sizes, device=group.device)
    period = ops_s.self_w.shape[0]
    if mode == "segment":  # the block's rows of every round: (R, p) / (R, p, D)
        ops_s = SparseRoundOps(*(t[:, row0:row0 + p].contiguous() for t in ops_s))
    steps_k = steps_budget(cfg)
    my_steps = None if steps_k is None else steps_k[row0:row0 + p]
    width = p if local_width is None else local_width

    def step(state: P2PState, batches):
        ops = select_round(ops_s, state.round_idx % period)
        after_local, losses = _local_phase_at_width(state, task, batches, cfg, width, my_steps)
        # (ranks, T, p) -> the vmap layout (T, K), peers block-major
        losses = group.all_gather(losses).permute(1, 0, 2).reshape(-1, k)
        after_cons = consensus_phase_hier_sharded(after_local, cfg, ops, group=group, mode=mode,
                                                  row0=row0)
        return after_local, after_cons, losses.mean(dim=1)

    return step


def make_sharded_round_fn(
    task: task_lib.TrainTask,
    cfg: P2PConfig,
    group,
    data_sizes: np.ndarray | None = None,
    *,
    peers_per_device: int = 1,
    mix_mode: str = "auto",
    local_width: int | None = None,
) -> Callable[[P2PState, tuple], tuple[P2PState, P2PState, torch.Tensor]]:
    """A rank's round in the sharded runtime, one process per peer (the
    reference's ``make_sharded_round_fn`` with one peer a device): the same
    ``(state, batches) -> (after_local, after_consensus, losses (T,))``
    contract as ``make_round_fn``, on the rank's (1, ...) block of the state
    (``shard_state``) and its (T, 1, ...) block of the batches, with the
    per-step losses all-gathered to (T, K) and reduced as the vmap runtime
    reduces them.  ``group`` is the rank's ``core.peer_group.PeerGroup``
    (``group.size`` = K).

    The schedule's operands of every period round (replicated), the lanes of
    its union graph (``graph.schedule_lanes``; the complete graph's for an
    adaptive schedule, whose matching every rank computes alike from the
    all-gathered losses and the shared threefry key) and the profile's step
    budgets are built once, here.  ``local_width``: the local phase runs on
    that many rows, copies of the rank's block (``_local_phase_at_width``),
    its own rows by default.  A parity check on a card passes K: cuBLAS
    picks the 2NN's GEMM by its batch count, so only at the vmap runtime's
    width are a card's rows the vmap runtime's bit for bit (on the CPU the
    rank's own rows already give them).

    ``peers_per_device`` = p > 1: the hierarchical runtime over K / p ranks
    (``group.size`` must be K / p), a block of p peers a rank, its state
    ``shard_state(state, rank, p)`` and its batches (T, p, ...); ``mix_mode``
    "bridge", "segment" or "auto" (bridge iff K <= 64), see
    ``consensus_phase_hier_sharded``.  The schedule's (R, K, D) operands are
    uploaded once (a segment rank keeps its block's rows); compression,
    adaptive selection, async rounds and registry tasks are refused
    (``features.check_config``), as in the reference.
    """
    if peers_per_device != 1:
        return _make_hier_sharded_round_fn(task, cfg, group, data_sizes, peers_per_device,
                                           mix_mode, local_width)
    if local_width is None:
        local_width = 1
    k = cfg.num_peers
    if group.size != k:
        raise ValueError(f"the sharded runtime runs one peer a rank: num_peers={k} needs "
                         f"{k} ranks, the group has {group.size}")
    features_lib.check_config(cfg)
    device = group.device
    me = group.rank
    steps_k = steps_budget(cfg)
    my_steps = None if steps_k is None else steps_k[me:me + 1]
    pick, period = round_picker(cfg, data_sizes, device=device)
    adaptive = cfg.schedule == "adaptive"
    lanes = graph_lib.edge_color_lanes(~np.eye(k, dtype=bool)) if adaptive else \
        graph_lib.schedule_lanes(build_schedule(cfg))
    layout = ParamLayout.of(task)

    def step(state: P2PState, batches):
        ops = pick(state.round_idx % period)
        if adaptive:  # the matching from every peer's last losses, as the vmap round's
            ad = state.adaptive
            ops, key_next = adaptive_operands(
                AdaptiveState(ad.key, group.all_gather(ad.last_losses[0])), cfg, ops)
        after_local, losses = _local_phase_at_width(state, task, batches, cfg, local_width,
                                                    my_steps)
        losses = group.all_gather(losses[:, 0]).t().contiguous()  # (T, K), the vmap layout
        if adaptive:
            after_local = after_local._replace(adaptive=AdaptiveState(
                key=key_next.expand_as(ad.key).contiguous(),
                last_losses=losses.mean(dim=0)[me:me + 1]))
        after_cons = consensus_phase_sharded(after_local, cfg, ops, group=group, lanes=lanes,
                                             layout=layout)
        return after_local, after_cons, losses.mean(dim=1)

    return step


class PodScanDriver:
    """``make_scan_driver(..., group=)``: C rounds a call of a rank's sharded
    round (``make_sharded_round_fn``, one peer or a block of p peers a
    rank), driven eagerly: a rank's exchange waits on a host barrier between
    kernel launches, which a CUDA graph cannot hold, and the local phase
    alone is too short to gain from one.  The bits are the python loop's.
    ``drive(state, batches) -> (after_local, final_state, losses (C, T))``;
    ``batches`` a ``data.pipeline.ChunkBatches`` of the rank's rows ((C, T,
    p, B) indices) or a tree of (C, T, p, ...) tensors."""

    capture_seconds = 0.0  # nothing is captured

    def __init__(self, step):
        self.step = step

    def __call__(self, state: P2PState, batches) -> tuple[P2PState, P2PState, torch.Tensor]:
        if isinstance(batches, pipeline.ChunkBatches):
            x_all, y_all, idx = batches
            chunk, round_batches = idx.shape[0], lambda c: (x_all[idx[c]], y_all[idx[c]])
        else:
            chunk = pytree.leaves(batches)[0].shape[0]
            round_batches = lambda c: pytree.tree_map(lambda leaf: leaf[c], batches)  # noqa: E731
        losses = []
        for c in range(chunk):
            after_local, state, round_losses = self.step(state, round_batches(c))
            losses.append(round_losses)
        return after_local, state, torch.stack(losses)


def _tensors(*fields) -> list[torch.Tensor]:
    """The fields that are tensors (the others are ``()``: not carried)."""
    return [f for f in fields if isinstance(f, torch.Tensor)]


def state_leaves(state: P2PState) -> list[torch.Tensor]:
    """The state's tensors in a fixed order: params, momentum, d, b, the
    protocol's, the adaptive selection's (int64) key and last losses, the
    compressed wire's estimate, the staleness buffer's published snapshots
    and (int32) ages, then a mixed task's float32 block (``WideState``:
    params, momentum, d, b, and its estimate and snapshots where carried)."""
    wide = _tensors(*state.wide) if state.wide else []
    return [state.params, state.momentum, state.d_bias, state.b_bias, *state.protocol,
            *state.adaptive, *_tensors(state.compression), *state.staleness, *wide]


def with_leaves(like: P2PState, leaves: list[torch.Tensor], round_idx: int) -> P2PState:
    """``like`` with its tensors replaced by ``leaves`` (``state_leaves``'
    order) and its round index by ``round_idx``."""
    params, momentum, d_bias, b_bias, *rest = leaves
    n_proto = len(like.protocol)
    protocol = type(like.protocol)(*rest[:n_proto]) if n_proto else ()
    rest = rest[n_proto:]
    n_ad = len(like.adaptive)
    adaptive = AdaptiveState(*rest[:n_ad]) if n_ad else ()
    rest = rest[n_ad:]
    n_est = len(_tensors(like.compression))
    compression = rest[0] if n_est else ()
    rest = rest[n_est:]
    n_stale = len(like.staleness)
    staleness = StalenessState(*rest[:n_stale]) if n_stale else ()
    rest = iter(rest[n_stale:])
    wide = WideState(*(next(rest) if isinstance(f, torch.Tensor) else ()
                       for f in like.wide)) if like.wide else ()
    return P2PState(params, momentum, d_bias, b_bias, round_idx, protocol, adaptive,
                    compression, staleness, wide)


class ScanDriver:
    """C rounds a call, each a replay of one captured round (``make_scan_driver``).

    ``drive(state, batches) -> (after_local, final_state, losses (C, T))``;
    ``batches`` is a ``data.pipeline.ChunkBatches`` of C rounds, or, as the
    reference's ``drive`` takes them, any tree (tuple or dict) of (C, T, K,
    ...) tensors on the device, leaves of any types (a language model's
    ``{"tokens", "labels"}``, with a vlm's float32 ``"patches"``).  The body
    of a round is the python driver's round step, unchanged, over static
    buffers: the carried state (``state_leaves``: params, momentum, d, b,
    push-sum's mass, the adaptive selection's key and losses, the compressed
    wire's estimate, the published snapshots and their int32 ages, and a
    mixed task's float32 block of each), the round's operands
    ``(self_w, nbr_idx, nbr_w, beta)`` (with bounded staleness also the
    round's column sums and its row of the publication table:
    ``protocols.StaleRoundOps``, so the delivery rule runs on the device
    inside the graph; an adaptive round's static ``AdaptiveRoundOps``, its
    key split, matching and W / Beta inside the graph) and its (T, K, B)
    batch rows, with
    the gather ``x_all[rows]`` inside the body, or a static (T, K, ...)
    tensor for each leaf of a batch tree.  Between rounds, on the
    device: round ``r % period``'s operands are copied into the static ones
    (the hierarchical runtime's as a static R = 1 stack, read at round index
    0), round c's rows (or each leaf's ``batches[c]``) into the static ones,
    and after each round its (T,) losses into the driver's (C, T) buffer.
    Other data, or a batch tree of other leaves, shapes or types, is warmed
    up and captured anew.  At its end the body copies the round's state
    into the carried buffers.  The first round of the first call runs
    eagerly as the warm-up; the capture follows and every later round is a
    replay (``repro_torch.capture``).  ``round_idx`` stays a host int and
    advances by C.

    ``donate=True`` adopts the input state's buffers as the carried ones on
    the first call and returns them as the final state: the input is
    consumed, and the caller uses the returned state (passing it back costs
    no copy).  ``donate=False`` copies the input in and returns copies.
    ``after_local`` (the last round's state after its local phase) is always
    the driver's own copy.  ``capture_seconds`` is the warm-up round and the
    capture's wall time; ``captured`` the ``capture.Captured`` of the round.
    """

    def __init__(self, step, pick, period: int, *, donate: bool, device: torch.device):
        """``step(state, batches, ops)`` is the round; ``pick(r)`` round r's
        operands, as ``step`` takes them, of a period of ``period`` rounds."""
        self.step, self.pick, self.period = step, pick, period
        if device.type == "cuda" and device.index is None:  # as tensors name it
            device = torch.device("cuda", torch.cuda.current_device())
        self.donate, self.device = donate, device
        # period 1: the upload itself is static; else round r % period is copied in
        first = pick(0)
        self.static_ops = first if period == 1 else type(first)(*(t.clone() for t in first))
        self.carry: P2PState | None = None
        self.form: tuple | None = None  # what the static batch buffers stand for
        self.rows = None  # the static batch rows, or the static batch tree
        self.source: Callable[[], object] | None = None  # the round's batches from them
        self.captured: capture_lib.Captured | None = None
        self.capture_seconds = 0.0
        self._aliases: list[int] | None = None  # after-local leaves that are carried ones

    def _capture(self) -> capture_lib.Captured:
        """Warm up (one real round) and capture the round over the static buffers."""
        step, source = self.step, self.source
        carry, ops = self.carry, self.static_ops

        def body():  # holds the buffers, not the driver: no reference cycle to a graph
            after_local, after_cons, losses = step(carry, source(), ops)
            for dst, src in zip(state_leaves(carry), state_leaves(after_cons)):
                if src is not dst:
                    dst.copy_(src)
            return after_local, losses

        return capture_lib.capture(body, self.device)

    def _take(self, state: P2PState) -> None:
        """Make ``state`` the carried state: adopted (``donate``) or copied in."""
        leaves = state_leaves(state)
        if self.carry is None:
            owned: set[int] = set()
            carry = []
            for t in leaves:
                adopt = (self.donate and t.is_contiguous() and t.device == self.device
                         and t.data_ptr() not in owned)
                carry.append(t if adopt else t.detach().clone(
                    memory_format=torch.contiguous_format).to(self.device))
                owned.add(carry[-1].data_ptr())
            self.carry = with_leaves(state, carry, 0)
            return
        for dst, src in zip(state_leaves(self.carry), leaves):
            if src is not dst:
                dst.copy_(src)

    def _static(self, form: tuple, rows, source) -> None:
        """New static batch buffers (``rows``, read by ``source``): the next
        round warms up and captures anew."""
        self.form, self.rows, self.source = form, rows, source
        self.captured, self._aliases = None, None

    def _feed(self, batches) -> tuple[int, Callable[[int], object]]:
        """(C, load): the chunk length and ``load(c)``, which copies round
        c's batches into the static buffers, made anew where the batches
        change form."""
        if isinstance(batches, pipeline.ChunkBatches):
            x_all, y_all, idx = batches
            if idx.dim() != 4 or idx.shape[0] < 1:
                raise ValueError(f"batch rows must be (C, T, K, B) with C >= 1, got "
                                 f"{tuple(idx.shape)}")
            if self.form is None or self.form[0] != "rows" or self.form[1] is not x_all \
                    or self.form[2] is not y_all or tuple(self.rows.shape) != tuple(idx.shape[1:]):
                rows = torch.empty(idx.shape[1:], dtype=idx.dtype, device=self.device)
                self._static(("rows", x_all, y_all), rows, lambda: (x_all[rows], y_all[rows]))
            return idx.shape[0], lambda c: self.rows.copy_(idx[c])
        named = pytree.leaves_with_path(batches)
        if not named:
            raise ValueError("a batch tree needs at least one leaf")
        chunk = named[0][1].shape[0]
        for path, leaf in named:
            if not isinstance(leaf, torch.Tensor) or leaf.dim() < 3 or leaf.shape[0] != chunk \
                    or chunk < 1:
                raise ValueError(f"every batch leaf must be a (C, T, K, ...) tensor with C = "
                                 f"{chunk} >= 1; {'/'.join(path)} is "
                                 f"{getattr(leaf, 'shape', type(leaf))}")
        form = ("tree", tuple((path, tuple(leaf.shape[1:]), leaf.dtype) for path, leaf in named))
        if self.form != form:
            tree = pytree.tree_map(lambda leaf: torch.empty(
                leaf.shape[1:], dtype=leaf.dtype, device=self.device), batches)
            self._static(form, tree, lambda: tree)
        pairs = list(zip(pytree.leaves(self.rows), (leaf for _, leaf in named)))
        return chunk, lambda c: [dst.copy_(src[c]) for dst, src in pairs]

    def __call__(self, state: P2PState, batches) -> tuple[P2PState, P2PState, torch.Tensor]:
        chunk, load = self._feed(batches)
        self._take(state)
        carry = state_leaves(self.carry)
        losses_out = None
        for c in range(chunk):
            if self.period > 1:
                for dst, src in zip(self.static_ops, self.pick((state.round_idx + c)
                                                               % self.period)):
                    dst.copy_(src)
            load(c)
            if c == chunk - 1:  # the carried leaves the last after-local state reads
                keep = range(len(carry)) if self._aliases is None else self._aliases
                before = {i: carry[i].clone() for i in keep}
            if self.captured is None:
                self.captured = self._capture()
                self.capture_seconds = self.captured.seconds
                after_local, losses = self.captured.warmup_outputs
                self._aliases = [i for i, t in enumerate(state_leaves(after_local))
                                 if t is carry[i]]
            else:
                after_local, losses = self.captured.replay()
            if losses_out is None:
                losses_out = losses.new_empty((chunk, *losses.shape))
            losses_out[c].copy_(losses)
        local_leaves = [before[i] if t is carry[i] else t.clone()
                        for i, t in enumerate(state_leaves(after_local))]
        round_idx = state.round_idx + chunk
        final = carry if self.donate else [t.clone() for t in carry]
        return (with_leaves(state, local_leaves, round_idx - 1),
                with_leaves(state, final, round_idx), losses_out)


def make_scan_driver(
    task: task_lib.TrainTask,
    cfg: P2PConfig,
    data_sizes: np.ndarray | None = None,
    *,
    peers_per_device: int | None = None,
    mix_mode: str = "auto",
    donate: bool = True,
    device: torch.device | str | None = None,
    group=None,
) -> ScanDriver | PodScanDriver:
    """Fused multi-round driver (the reference's ``make_scan_driver``): C
    rounds a call, on the card each a replay of one CUDA graph of the round
    (``ScanDriver``), so the results equal C calls of ``make_round_fn`` (or
    ``make_hier_round_fn`` with ``peers_per_device`` = K) bit for bit.  The
    schedule's operands (``round_picker``) and the step budgets are uploaded
    once, here.  The chunk length C is read from the batches (a
    ``ChunkBatches`` or a tree of (C, T, K, ...) tensors); one capture
    serves every C.  With ``group`` (a rank's ``PeerGroup``) it drives the
    rank's sharded round (``PodScanDriver`` of ``make_sharded_round_fn``,
    with ``peers_per_device`` peers a rank: 1 by default, p > 1 the
    hierarchical runtime over K / p ranks) on the group's device.
    """
    if group is not None:
        return PodScanDriver(make_sharded_round_fn(
            task, cfg, group, data_sizes, peers_per_device=peers_per_device or 1,
            mix_mode=mix_mode))
    device = resolve_device(device)
    if peers_per_device is not None and peers_per_device > 1:
        step = _hier_round_step(task, cfg, peers_per_device, mix_mode)
        ops_s = schedule_operands(cfg, data_sizes, device=device)

        def pick(r):  # an R = 1 stack: the step reads its round index 0
            return SparseRoundOps(*(t[r:r + 1] for t in ops_s))
        period = ops_s.self_w.shape[0]
    else:
        steps_k = steps_budget(cfg)

        def step(state, batches, ops):
            return run_round(state, task, batches, cfg, ops, steps_k=steps_k)

        pick, period = round_picker(cfg, data_sizes, device=device)
    return ScanDriver(step, pick, period, donate=donate, device=device)


def param_views(state: P2PState, task: task_lib.TrainTask) -> dict[str, torch.Tensor]:
    """The state's parameters as named (K, ...) leaves (views, no copies)."""
    return ParamLayout.of(task).views(*param_blocks(state))


# ---------------------------------------------------------------------------
# Serving extraction (the trained fleet's artifacts)
# ---------------------------------------------------------------------------


def serving_params(state: P2PState, task: task_lib.TrainTask) -> dict[str, torch.Tensor]:
    """Extract the personalized serving artifact from a trained state.

    The stacked (K, ...) per-peer parameter leaves, detached from the
    optimizer/consensus buffers: P2PL's product is K *divergent* models, and
    this is the layout the stacked serving runtime consumes
    (``repro_torch.launch.serve.make_fleet_classify_fn`` /
    ``make_fleet_generate_fn``).  The reference returns ``state.params``, a
    tree; the port's parameters are one (K, row) buffer, so this returns the
    task's named leaves as views into it (``ParamLayout.views``, no copies).
    """
    return param_views(state, task)


def consensus_averaged_params(
    stacked_params: dict[str, torch.Tensor], data_sizes: np.ndarray | None = None
) -> dict[str, torch.Tensor]:
    """The ONE-model serving baseline: average the K peer rows, broadcast back.

    Collapses every stacked leaf to its (data-weighted, else uniform) float32
    average and broadcasts it to all K rows (``expand``: a view, no K
    copies), so the averaged baseline routes through the IDENTICAL stacked
    serving path as the personalized fleet.
    """
    k = next(iter(stacked_params.values())).shape[0]
    if data_sizes is None:
        w = torch.full((k,), 1.0 / k, dtype=torch.float32)
    else:
        sizes = torch.as_tensor(np.asarray(data_sizes), dtype=torch.float32)
        w = sizes / sizes.sum()

    def avg(p):
        mean = torch.tensordot(w.to(p.device), p.float(), dims=1)
        return mean.to(p.dtype).expand(p.shape)

    return {name: avg(p) for name, p in stacked_params.items()}


# ---------------------------------------------------------------------------
# Evaluation helpers (stratified accuracy — the paper's seen/unseen split)
# ---------------------------------------------------------------------------


@torch.no_grad()
def evaluate_stacked(apply_fn, params: dict, images: torch.Tensor, labels: torch.Tensor):
    """Per-peer test accuracy: (K,) from stacked params on a shared test set."""
    return (apply_fn(params, images).argmax(-1) == labels).float().mean(dim=-1)


@torch.no_grad()
def masked_predictions(apply_fn, params: dict, inputs: torch.Tensor,
                       classes: np.ndarray) -> torch.Tensor:
    """(K, N) every peer's argmax over its logits restricted to ``classes``."""
    logits = apply_fn(params, inputs)  # (K, N, C)
    mask = torch.full((logits.shape[-1],), -1e9, dtype=torch.float32, device=logits.device)
    mask[torch.as_tensor(classes, device=logits.device)] = 0.0
    return torch.argmax(logits + mask, dim=-1)


@torch.no_grad()
def stratified_accuracy(
    apply_fn,
    params: dict,
    images: torch.Tensor,
    labels: torch.Tensor,
    class_groups: dict[str, np.ndarray],
) -> dict[str, torch.Tensor]:
    """Accuracy per named class group (e.g. {"seen": [0,1], "unseen": [7,8]}).

    Predictions are restricted to the union of all group classes, matching the
    paper's K-class tasks (e.g. 4-class task over {0,1,7,8}).
    """
    all_classes = np.sort(np.concatenate(list(class_groups.values())))
    pred = masked_predictions(apply_fn, params, images, all_classes)  # (K, N)
    out = {}
    for name, classes in class_groups.items():
        sel = torch.isin(labels, torch.as_tensor(classes, device=labels.device))
        denom = max(int(sel.sum()), 1)
        out[name] = ((pred == labels[None, :]) & sel[None, :]).sum(dim=1).float() / denom
    return out


def oscillation_amplitude(after_local: np.ndarray, after_consensus: np.ndarray) -> np.ndarray:
    """Mean |acc_after_consensus - acc_after_local| per round — the paper's
    sawtooth size.  Inputs: (rounds,) or (rounds, K)."""
    a = np.asarray(after_local, np.float64)
    c = np.asarray(after_consensus, np.float64)
    return np.abs(c - a).mean(axis=-1) if a.ndim > 1 else np.abs(c - a)

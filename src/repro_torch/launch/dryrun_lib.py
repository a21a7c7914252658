"""Dry-run core: every (arch x input shape x layout) case's step, run once
on fake tensors (the counterpart of the reference's ``repro.launch.dryrun_lib``).

The reference lowers and compiles each case on ``ShapeDtypeStruct``
stand-ins.  The port has no compiler to ask, so it runs the step itself, op
by op, under ``FakeTensorMode`` (``torch._subclasses.fake_tensor``): every
tensor has its shape, type and device but no data, so nothing is allocated
and a case of any size runs on the CPU.  The step is the port's own
(``launch.steps``), at the architecture's published widths and depth, and
goes down the CUDA path of every kernel wrapper: given fake operands a
wrapper takes its fake route (``kernels.fake``), which records the call
instead of building or launching the kernel.  ``launch.op_cost.OpCost``
counts the step's ops, its kernels by their own work, and its peak of live
bytes; ``launch.roofline.build_report`` turns the counts into the
``Roofline`` record against the card's peaks (``launch.mesh.Card``), and
``CaseResult.fits`` says whether the peak fits the card's memory.

The stand-ins' device is ``cuda`` where the build has CUDA.  A build
without it (a CPU-only machine) has no CUDA device guard for fake CUDA
tensors, so it can neither index them nor run autograd over them; there the
stand-ins sit on the ``meta`` device, where the wrappers take the same
branch (the one that is not the CPU's plain version) and the same fake
route.  The report says which device it ran on (``extra["fake_device"]``).

Parameters come from the model's own ``init`` given a generator whose
device is ``meta`` (``ShapeGenerator``): every draw makes a meta tensor of
the leaf's shape and type and draws nothing (the counterpart of
``jax.eval_shape(model.init, ...)``); a real generator draws as before.  The
batch comes from ``model.batch_specs``, the cache from ``model.init_cache``.

Layouts (``launch.mesh``): one card holds one peer (``make_production_mesh()``,
the reference's single-pod case); with ``multi_pod`` two peers of one card
each run the multi-peer steps over the stacked state (the reference's
multi-pod case, pod = 2), and a training case adds the consensus step
(``steps.make_consensus_step``) with the bytes the sharded runtime's
exchange (``core.peer_group.PeerGroup.exchange``) sends a rank.  A
per-card figure is the total divided by the layout's cards.

Used by ``launch/dryrun.py`` and by ``chip_smoke.py``, which holds the dry
run's figures against a real step of the same code on the card.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import optim as optim_lib
from repro_torch.configs import INPUT_SHAPES, ShapeConfig, for_shape, get_config
from repro_torch.core import graph as graph_lib
from repro_torch.core import peer_group
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model

CONSENSUS_LOCAL_STEPS = 60  # T of the consensus case, as the reference's


class ShapeGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the model's ``init`` given
    it makes meta tensors of its leaves' shapes and types and draws nothing
    (a meta tensor ignores the generator)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def make_optimizer(name: str) -> optim_lib.Optimizer:
    if name == "sgdm":
        return optim_lib.sgd(0.01, momentum=0.9)  # the paper's local update rule
    if name == "adamw":
        return optim_lib.adamw(3e-4)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass
class CaseResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    report: Optional[roofline_lib.Roofline] = None
    consensus_report: Optional[roofline_lib.Roofline] = None
    error: str = ""
    fits: Optional[bool] = None  # the step's peak of live bytes within the card's memory
    kernel_calls: dict = dataclasses.field(default_factory=dict)  # hand kernel -> calls
    state_bytes: dict = dataclasses.field(default_factory=dict)  # part of the state -> bytes


def prepare_case(arch: str, shape: str | ShapeConfig, *, router_groups: int = 16):
    """(config, shape config) of a case; ``shape`` names an ``INPUT_SHAPES``
    entry or is a ``ShapeConfig`` of its own."""
    shape_cfg = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg = for_shape(get_config(arch), shape_cfg)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router_groups=router_groups))
    return cfg, shape_cfg


def per_peer_batch(shape_cfg: ShapeConfig, peers: int) -> int:
    return max(shape_cfg.global_batch // max(peers, 1), 1)


def make_state(model, shape_cfg: ShapeConfig, opt: optim_lib.Optimizer, *, peers: int,
               generator: torch.Generator, batch: dict) -> dict:
    """The inputs of a case's step on ``generator.device``: ``params``, and
    for ``train`` ``opt_state``, ``d_bias`` (float32, as the consensus step
    gives it) and ``batch``; for ``prefill`` ``batch`` and ``cache``; for
    ``decode`` ``cache``, ``token`` and ``pos`` ((B,) int64).  With
    ``peers`` > 1 every leaf is stacked on a leading peer axis."""
    dev = generator.device
    b = per_peer_batch(shape_cfg, peers)
    params = model.init(generator)
    state = {"params": params}
    if shape_cfg.kind == "train":
        state["opt_state"] = opt.init(params)
        state["d_bias"] = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                           for k, v in params.items()}
        state["batch"] = batch
    elif shape_cfg.kind == "prefill":
        state["batch"] = batch
        state["cache"] = model.init_cache(b, shape_cfg.seq_len, dev)
    else:
        state["cache"] = model.init_cache(b, shape_cfg.seq_len, dev)
        state["token"] = torch.zeros((b,), dtype=torch.int64, device=dev)
        state["pos"] = torch.zeros((b,), dtype=torch.int64, device=dev)
    if peers > 1:
        state = tree_map(lambda t: torch.stack([t] * peers), state)
    return state


def make_step(model, kind: str, opt: optim_lib.Optimizer, *, peers: int,
              eta_d: float) -> Callable[[dict], tuple]:
    """The port's step of a case's kind, called on ``make_state``'s dict:
    ``make_train_step`` (``make_multipod_train_step`` over several peers),
    ``make_prefill_step`` (under ``torch.func.vmap`` over several peers, as
    the reference's) or ``make_serve_step`` writing the cache in place, the
    step the port's scanned decode replays (``make_multipod_serve_step``,
    whose cache is functional)."""
    multi = peers > 1
    if kind == "train":
        make = steps_lib.make_multipod_train_step if multi else steps_lib.make_train_step
        fn = make(model, opt, eta_d=eta_d)
        return lambda s: fn(s["params"], s["opt_state"], s["d_bias"], s["batch"], 0)
    if kind == "prefill":
        fn = steps_lib.make_prefill_step(model)
        fn = torch.func.vmap(fn) if multi else fn
        return lambda s: fn(s["params"], s["batch"], s["cache"])
    fn = (steps_lib.make_multipod_serve_step(model) if multi
          else steps_lib.make_serve_step(model, inplace=True))
    return lambda s: fn(s["params"], s["cache"], s["token"], s["pos"])


def fake_device() -> str:
    """The stand-ins' device (see the module)."""
    return "cuda" if torch.cuda.is_available() else "meta"


def state_bytes(state: dict) -> dict[str, int]:
    """Bytes of each part of a step's state (``make_state``'s keys)."""
    return {k: sum(t.numel() * t.element_size() for t in tree_leaves(v))
            for k, v in state.items()}


def _stand_ins(tree, device: str):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def run_step(step: Callable[[dict], tuple], state: dict) -> op_cost.OpCost:
    """``step(state)`` once under ``op_cost.OpCost``, with ``state`` counted
    live from the start; returns the counts."""
    cost = op_cost.OpCost()
    with cost:
        cost.track(state)
        step(state)
    return cost


def exchange_bytes(graph, row_bytes: list[int]) -> dict:
    """What the sharded runtime's exchange sends a rank (the most of any)
    for blocks of ``row_bytes`` each: one send a lane that names the rank
    as a source (``peer_group.exchange_destinations``)."""
    lanes = graph_lib.edge_color_lanes(graph.adjacency)
    sends = max(len(peer_group.exchange_destinations(lanes, rank))
                for rank in range(graph.adjacency.shape[0]))
    return {"exchange": {"count": len(row_bytes), "wire_bytes": float(sends * sum(row_bytes))}}


def run_case(
    arch: str,
    shape: str | ShapeConfig,
    mesh: Optional[mesh_lib.Layout] = None,
    *,
    optimizer: str = "sgdm",
    algorithm: str = "p2pl_affinity",
    with_consensus: bool = True,
    card: Optional[mesh_lib.Card] = None,
) -> CaseResult:
    """One case's step on fake tensors (see the module), on ``mesh``
    (default: one card), reckoned against ``card`` (default: the H100
    SXM's peaks).  A case that cannot run is ``ok=False`` with its
    traceback."""
    t0 = time.time()
    mesh = mesh or mesh_lib.make_production_mesh()
    mesh_name = mesh.name
    shape_name = shape if isinstance(shape, str) else shape.name
    try:
        card = card or mesh_lib.Card.for_part()
        cfg, shape_cfg = prepare_case(arch, shape)
        model = build_model(cfg)
        chips, peers = mesh_lib.num_chips(mesh), mesh.peers
        eta_d = 1.0 if algorithm == "p2pl_affinity" else 0.0
        opt = make_optimizer(optimizer)
        kind = shape_cfg.kind
        device = fake_device()
        meta = make_state(model, shape_cfg, opt, peers=peers, generator=ShapeGenerator(),
                          batch=model.batch_specs(per_peer_batch(shape_cfg, peers),
                                                  shape_cfg.seq_len))
        sizes = state_bytes(meta)
        param_bytes_total = sizes["params"]
        with FakeTensorMode():
            state = _stand_ins(meta, device)
            cost = run_step(make_step(model, kind, opt, peers=peers, eta_d=eta_d), state)
            extra = {"algorithm": algorithm, "optimizer": optimizer, "fake_device": device,
                     "state_bytes": sizes, "state_bytes_held": cost.tracked_bytes}
            report = roofline_lib.build_report(
                arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips, step_kind=kind,
                cost=cost, card=card, state_bytes=sum(sizes.values()),
                peak_bytes=cost.peak_bytes,
                model_flops_total=roofline_lib.model_flops(cfg, shape_cfg, peers=peers),
                param_bytes_total=param_bytes_total, extra=extra)
            consensus_report = None
            if peers > 1 and with_consensus and kind == "train":
                consensus_report = _consensus_report(
                    arch, shape_name, mesh_name, chips, peers, state, eta_d, card,
                    param_bytes_total)
        return CaseResult(arch, shape_name, mesh_name, True, time.time() - t0, report=report,
                          consensus_report=consensus_report, fits=report.extra["fits"],
                          kernel_calls=dict(cost.kernel_calls), state_bytes=sizes)
    except Exception:  # noqa: BLE001 — record and continue the sweep
        return CaseResult(arch, shape_name, mesh_name, False, time.time() - t0,
                          error=traceback.format_exc(limit=20))


def _consensus_report(arch, shape_name, mesh_name, chips, peers, state, eta_d, card,
                      param_bytes_total) -> roofline_lib.Roofline:
    """The gossip step over the peers' stacked parameters (complete graph,
    K = peers), through ``consensus_mix``'s fake route, with the exchange's
    bytes as the collective term."""
    g = graph_lib.build_graph("complete", peers)
    w = graph_lib.mixing_matrix(g, "data_weighted", data_sizes=np.ones(peers))
    step = steps_lib.make_consensus_step(w, graph_lib.affinity_matrix(g),
                                         local_steps=CONSENSUS_LOCAL_STEPS,
                                         use_affinity=eta_d != 0.0)
    params, d = state["params"], state["d_bias"]
    cost = run_step(lambda s: step(s["params"], s["d_bias"]), {"params": params, "d_bias": d})
    rows: dict[torch.dtype, int] = {}  # one block a leaf type, as the step lays them out
    for t in params.values():
        rows[t.dtype] = rows.get(t.dtype, 0) + t[0].numel() * t.element_size()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves((params, d)))
    return roofline_lib.build_report(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips, step_kind="consensus",
        cost=cost, card=card, state_bytes=nbytes, peak_bytes=cost.peak_bytes,
        model_flops_total=0.0, param_bytes_total=param_bytes_total,
        coll_breakdown=exchange_bytes(g, list(rows.values())),
        extra={"note": f"amortize collective term by 1/T (T={CONSENSUS_LOCAL_STEPS} local "
                       "steps)", "impl": "consensus_mix"})

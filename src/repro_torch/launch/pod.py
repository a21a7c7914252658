"""The rank programs of the sharded runtime, one process per peer
(``core.peer_group.spawn_peers`` runs them; they live here, in the package,
so that a spawned rank can import them).

``experiment_rank`` is ``run_paper_experiment(peer_axis="pod")``'s rank: the
same data, batches, initial state and rounds as the vmap run, the rank's row
of each, and rank 0 evaluating both phases' gathered rows with the vmap
run's ``eval_fn``, so the ``RoundLog`` is the vmap run's.

``round_cases_rank`` runs a list of ``RoundCase``s (a config, rounds of
batches drawn from a seed) through ``make_sharded_round_fn`` and returns a
digest of the rank's state after each phase of each round (``RoundDigest``),
which ``vmap_rounds`` gives for the stacked runtime from the same seed: the
parity check of the tests and of ``chip_smoke.py``.  A case with
``peers_per_device`` = p > 1 runs the hierarchical runtime over K / p
ranks, a block of p peers a rank, in its ``mix_mode``.

``hier_round_rank`` runs one round of a large fleet (K = 4096 over 8 ranks:
the 2NN from a shared initial state, or ``TINY_TASK``) and records the shapes
its consensus phase makes; ``hier_consensus_rank`` runs a rank's consensus
phase alone from a shared post-local state and holds it to shared results
of the one-device runtime.
"""
from __future__ import annotations

import contextlib
import hashlib
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import consensus as consensus_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import p2p
from repro_torch.core import protocols as protocols_lib
from repro_torch.core import task as task_lib
from repro_torch.data import partition, pipeline
from torch.utils._python_dispatch import TorchDispatchMode


class RoundCase(NamedTuple):
    """``rounds`` rounds of ``cfg`` on the 2NN (or ``cfg.model``, or
    ``task``, a task of this module), batches of ``batch`` random examples a
    peer a step drawn from numpy's seed 0, from ``init_params`` (stacked
    (K, ...) leaves, e.g. the reference's) or the draw of seed 0; a case of
    ``peers_per_device`` > 1 runs the hierarchical runtime in ``mix_mode``."""

    name: str
    cfg: p2p.P2PConfig
    rounds: int
    data_sizes: tuple | None = None
    batch: int = 10
    init_params: dict | None = None
    peers_per_device: int = 1
    mix_mode: str = "auto"
    task: task_lib.TrainTask | None = None


def case_task(case: RoundCase) -> task_lib.TrainTask:
    """The case's task: its own, or the registry's ``cfg.model``."""
    return case.task or task_lib.get_task(case.cfg.model)


class WholeBlockGossip(protocols_lib.ConsensusProtocol):
    """Gossip written against the whole-block sharded interface alone
    (``mix_sharded``; no ``mix_sharded_begin`` / ``mix_sharded_leaf``), as a
    protocol of the reference's interface before that split is: the check
    of ``p2p.consensus_phase_sharded``'s path for such a protocol.  Its
    rank mix is this row of the dense mix (``consensus.mix_stacked``).
    ``register_whole_block`` adds it to the registry, ``whole_block_protocol``
    for the span of a ``with`` block."""

    name = "whole_block_gossip"

    def init_state(self, params, data_sizes=None):
        return ()

    def mix(self, proto_state, flat, ops, local_steps):
        return protocols_lib.get_protocol("gossip").mix(proto_state, flat, ops, local_steps)

    def mix_sharded(self, proto_state, x_block, x_full, ops, *, group, lanes):
        me = group.rank
        w_row = consensus_lib.scatter_rows(
            ops.nbr_idx[me:me + 1], ops.nbr_w[me:me + 1], group.size,
            row_ids=torch.tensor([me], device=x_full.device), self_w=ops.self_w[me:me + 1])
        return proto_state, consensus_lib.mix_stacked(w_row, x_full)


def register_whole_block() -> None:
    """Register ``WholeBlockGossip`` (once)."""
    if WholeBlockGossip.name not in protocols_lib.protocol_names():
        protocols_lib.register_protocol(WholeBlockGossip())


@contextlib.contextmanager
def whole_block_protocol():
    """``WholeBlockGossip`` registered for the span of the block, and taken
    out after it, so that nothing else in the process sees it."""
    register_whole_block()
    try:
        yield WholeBlockGossip.name
    finally:
        protocols_lib.unregister_protocol(WholeBlockGossip.name)


def case_batches(case: RoundCase, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Every round's (x (T, K, B, 784) pixel intensities in [0, 1), y (T, K,
    B) labels) of a case, the same on every rank and in the parent (numpy
    from seed 0); for ``TANH_MLP`` the reference test's draws, (x (T, K, B,
    6), y (T, K, B, 4)) standard normal."""
    rng = np.random.default_rng(0)
    k, t = case.cfg.num_peers, case.cfg.local_steps
    out = []
    for _ in range(case.rounds):
        if case.task is not None and case.task.name == TANH_MLP.name:
            x = rng.normal(size=(t, k, case.batch, 6)).astype(np.float32)
            y = rng.normal(size=(t, k, case.batch, 4)).astype(np.float32)
        else:
            x = rng.random(size=(t, k, case.batch, 784)).astype(np.float32)
            y = rng.integers(0, 10, size=(t, k, case.batch))
        out.append((torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)))
    return out


def case_state(case: RoundCase, device) -> p2p.P2PState:
    """The case's stacked initial state (seed 0, its data sizes)."""
    sizes = None if case.data_sizes is None else np.asarray(case.data_sizes)
    init = None if case.init_params is None else {
        name: torch.as_tensor(np.array(leaf)) for name, leaf in case.init_params.items()}
    return p2p.init_state(case_task(case), case.cfg, seed=0,
                          data_sizes=sizes, device=device, init_params=init)


def vmap_rounds(case: RoundCase, device) -> list[tuple[p2p.P2PState, p2p.P2PState, torch.Tensor]]:
    """The case on the vmap runtime: each round's (after_local,
    after_consensus, losses (T,))."""
    sizes = None if case.data_sizes is None else np.asarray(case.data_sizes)
    step = p2p.make_round_fn(case_task(case), case.cfg, sizes, device=device)
    state, out = case_state(case, device), []
    for batches in case_batches(case, device):
        after_local, state, losses = step(state, batches)
        out.append((after_local, state, losses))
    return out


def collectives_rank(group) -> dict:
    """A rank's results of the collective forms of ``core.consensus`` on
    (K, 5, 3) random rows drawn from numpy's seed 0 (the same on every rank): its
    block of ``gather_peer_rows`` over a ring's lanes, ``mix_psum``,
    ``mix_ring`` and ``mix_collective``."""
    k, me = group.size, group.rank
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(k, 5, 3)).astype(np.float32), device=group.device)
    w = torch.as_tensor(rng.dirichlet(np.ones(k), size=k).astype(np.float32),
                        device=group.device)
    lanes = graph_lib.schedule_lanes(graph_lib.static_schedule(graph_lib.build_graph("ring", k)))
    block = {"x": x[me:me + 1]}
    return {
        "gather": consensus_lib.gather_peer_rows(block, group, lanes)["x"],
        "psum": consensus_lib.mix_psum(block, group, self_weight=0.5,
                                       peer_weight=0.5 / (k - 1))["x"],
        "ring": consensus_lib.mix_ring(block, group, self_weight=0.5, left_weight=0.3,
                                       right_weight=0.2)["x"],
        "collective": consensus_lib.mix_collective(block, group, w[me])["x"],
    }


def _launch_counts() -> dict[str, int]:
    """The consensus kernels' launch counts in this process."""
    from repro_torch.kernels.consensus_mix import dequant, ops, segment  # noqa: PLC0415

    return {"consensus_mix": ops.launches.count, "dequant_mix": dequant.launches.count,
            "segment_mix": segment.launches.count}


def state_digest(state: p2p.P2PState) -> tuple:
    """The round index and a SHA-256 of every tensor of a state
    (``p2p.state_leaves``): equal digests are equal bits."""
    return (state.round_idx, *(hashlib.sha256(t.detach().cpu().contiguous().view(-1)
                                              .view(torch.uint8).numpy()).hexdigest()
                               for t in p2p.state_leaves(state)))


class RoundDigest(NamedTuple):
    """A round of a rank in ``round_cases_rank``: the digests
    of its states after each phase, its losses and protocol state, and, in
    the last round, its params and d after consensus (None before)."""

    local: tuple
    consensus: tuple
    losses: torch.Tensor
    protocol: tuple
    params: torch.Tensor | None
    d_bias: torch.Tensor | None


def _digest_rounds(rounds: list) -> list[RoundDigest]:
    out = []
    for i, (after_local, after_cons, losses) in enumerate(rounds):
        last = i == len(rounds) - 1
        out.append(RoundDigest(state_digest(after_local), state_digest(after_cons), losses,
                               after_cons.protocol, after_cons.params if last else None,
                               after_cons.d_bias if last else None))
    return out


def round_cases_rank(group, cases: list[RoundCase], local_width: int = 1,
                     driver: str = "python") -> dict:
    """A rank's run of every case through the sharded runtime (its local
    phase at ``local_width``, ``make_sharded_round_fn``'s: 1 the rank's own
    rows, its block of a hierarchical case's, any other value the case's K,
    the vmap runtime's width): {case name: a
    ``RoundDigest`` a round (a case's states of K = 8 2NN rows hold some 6
    MB a round and rank)}, and the group's exchange statistics, each case's
    seconds a round and launches under "stats".  ``driver="scan"`` runs all
    rounds as one chunk of the pod scan driver (one entry: the last round's
    after-local state, the final state and the (C, T) losses)."""
    out, stats = {}, {}
    device, me = group.device, group.rank
    if any(case.cfg.protocol == WholeBlockGossip.name for case in cases):
        register_whole_block()
    for case in cases:
        sizes = None if case.data_sizes is None else np.asarray(case.data_sizes)
        task = case_task(case)
        p = case.peers_per_device
        state = p2p.shard_state(case_state(case, device), me, p)
        batches = [tuple(b[:, me * p:(me + 1) * p] for b in rb)
                   for rb in case_batches(case, device)]
        group.barrier()
        before = dict(group.stats)
        counts = _launch_counts()
        start = time.perf_counter()
        step = p2p.make_sharded_round_fn(task, case.cfg, group, sizes, peers_per_device=p,
                                         mix_mode=case.mix_mode,
                                         local_width=None if local_width == 1
                                         else case.cfg.num_peers)
        if driver == "scan":
            drive = p2p.PodScanDriver(step)
            chunk = tuple(torch.stack([b[i] for b in batches]) for i in range(2))
            after_local, state, losses = drive(state, chunk)
            rounds = [(after_local, state, losses)]
        else:
            rounds = []
            for rb in batches:
                after_local, state, losses = step(state, rb)
                rounds.append((after_local, state, losses))
        group.barrier()
        seconds = time.perf_counter() - start
        out[case.name] = _digest_rounds(rounds)
        stats[case.name] = {
            "seconds_per_round": seconds / case.rounds,
            "launches": {key: n - counts[key] for key, n in _launch_counts().items()},
            **{key: group.stats[key] - before[key] for key in group.stats}}
    out["stats"] = stats
    if device.type == "cuda":
        out["stats"]["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def grid_rank(group, cases: list[RoundCase], scan_cases: list[RoundCase] = (),
              width_cases: list[RoundCase] = (), local_width: int = 1) -> dict:
    """One spawn's whole parity grid, as ``RoundDigest``s: ``round_cases_rank``
    of ``cases`` and ``width_cases`` at ``local_width`` (K for the bits of
    the vmap runtime on a card), the scan driver's chunk of each of
    ``scan_cases`` under "scan", ``width_cases`` again at the other width
    (1 where ``local_width`` is K, else K) under "width", and
    ``collectives_rank``'s results under "collectives"."""
    out = round_cases_rank(group, [*cases, *width_cases], local_width)
    out["collectives"] = collectives_rank(group)
    scan = round_cases_rank(group, list(scan_cases), local_width, driver="scan")
    out["scan"] = {case.name: scan[case.name][0] for case in scan_cases}
    out["stats"] |= {f"scan {name}": v for name, v in scan["stats"].items()
                     if name in {case.name for case in scan_cases}}
    other = group.size if local_width == 1 else 1
    width = round_cases_rank(group, list(width_cases), other)
    out["width"] = width
    out["stats"] |= {f"width {name}": v for name, v in width["stats"].items()
                     if name in {case.name for case in width_cases}}
    return out


def experiment_rank(group, exp, rounds: int, data, eval_every: int, seed: int, verbose: bool,
                    driver: str, return_state: bool, eval_threads: int = 1,
                    peers_per_device: int = 1, mix_mode: str = "auto") -> dict:
    """``run_paper_experiment(peer_axis="pod")``'s rank (``data`` as CPU
    tensors), one peer or (``peers_per_device`` = p > 1, the hierarchical
    runtime in ``mix_mode``) a block of p peers a rank: returns {"log":
    the RoundLog (rank 0's; the others' are empty), "state": the final
    stacked state (rank 0, with ``return_state``)}.  Rank 0 evaluates with
    ``eval_threads`` CPU threads (the launching process's: a CPU matmul's
    bits depend on its thread count, and the drift metric is one)."""
    from repro_torch.launch.train import make_eval_fn, mnist_parts  # noqa: PLC0415 (cycle)

    device, me, cfg, p = group.device, group.rank, exp.p2p, peers_per_device
    rows = slice(me * p, (me + 1) * p)
    task = task_lib.get_task(cfg.model)
    x_tr, y_tr, x_te, y_te = (t.numpy() for t in data)
    parts = mnist_parts(exp, x_tr, y_tr)
    sizes = partition.data_sizes(parts)
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=seed)
    state = p2p.shard_state(p2p.init_state(task, cfg, seed=seed, data_sizes=sizes,
                                           device=device), me, p)
    hier = dict(peers_per_device=p, mix_mode=mix_mode)
    if driver == "scan":
        drive_fn = p2p.make_scan_driver(task, cfg, sizes, group=group, **hier)
    else:
        round_fn = p2p.make_sharded_round_fn(task, cfg, group, sizes, **hier)
    eval_fn = make_eval_fn(exp, task, x_te, y_te, seed=seed, device=device) if me == 0 else None
    log = metrics_lib.RoundLog()
    r = 0
    while r < rounds:
        n = min(eval_every, rounds - r)
        start = time.perf_counter()
        if driver == "scan":
            x_all, y_all, idx = batcher.chunk_batches_on(cfg.local_steps, n, device)
            after_local, state, losses = drive_fn(
                state, pipeline.ChunkBatches(x_all, y_all, idx[:, :, rows]))
            losses = losses[-1]
        else:
            for _ in range(n):
                x, y = batcher.round_batches_on(cfg.local_steps, device)
                after_local, state, losses = round_fn(state, (x[:, rows], y[:, rows]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = (time.perf_counter() - start) / n
        r += n
        full_local, full_cons = p2p.unshard_state(group, after_local), \
            p2p.unshard_state(group, state)
        if me == 0:
            torch.set_num_threads(eval_threads)
            acc_l, acc_c = eval_fn(full_local), eval_fn(full_cons)
            loss = float(losses.mean())
            log.record(local_acc=acc_l, consensus_acc=acc_c,
                       drift=float(consensus_lib.pairwise_drift(full_local.params)),
                       consensus_error=float(consensus_lib.consensus_error(full_cons.params)),
                       train_loss=loss, seconds=seconds)
            torch.set_num_threads(1)
            if verbose:
                print(f"round {r - 1:3d} loss={loss:.4f} "
                      f"acc(after local)={acc_l['all'].mean():.3f} "
                      f"acc(after consensus)={acc_c['all'].mean():.3f} "
                      f"({seconds:.4f} s/round, {group.size} ranks)", flush=True)
    final = p2p.unshard_state(group, state) if return_state else None
    return {"log": log, "state": final if me == 0 else None,
            "exchange": dict(group.stats), "launches": _launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0}


def lm_round_rank(group, arch: str, layers: int | None, batch: int, seq: int, steps: int,
                  ref_rows: torch.Tensor) -> dict:
    """A rank's round of ``run_p2p_lm``'s P2P configuration on ``arch`` at
    published widths (depth cut to ``layers`` where given), one peer a
    rank, its local phase on its own row, from the same initial state and token
    draws (numpy seed 0) as the vmap round that gave ``ref_rows`` (3, K, N):
    that round's params after local, params after consensus and d after
    consensus.  Returns the rank's round against the vmap round's rows (max
    |difference| and whether equal, after each phase), whether the sharded
    consensus from the vmap round's post-local row gives its rows bit for
    bit, whether each phase's rows are within bf16's 5e-2 (atol = rtol) of
    the vmap round's, the seconds, the exchange statistics, the launches and the
    peak memory."""
    from repro_torch.configs import get_config  # noqa: PLC0415
    from repro_torch.kernels.consensus_mix import ops as cm_ops  # noqa: PLC0415
    from repro_torch.launch.train import lm_config, lm_token_batches  # noqa: PLC0415 (cycle)
    from repro_torch.models.registry import build_model  # noqa: PLC0415

    device, me, k = group.device, group.rank, group.size
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    task = task_lib.from_model(build_model(cfg))
    pcfg = lm_config(num_peers=k, local_steps=steps, algorithm="p2pl_affinity", lr=1e-2,
                     momentum=0.5, eta_d=0.25)
    state = p2p.shard_state(p2p.init_state(task, pcfg, seed=0, device=device), me)
    tokens, labels = lm_token_batches(np.random.default_rng(0), cfg.vocab_size, num_peers=k,
                                      local_steps=steps, batch=batch, seq=seq)
    batches = tuple(torch.as_tensor(a[:, me:me + 1], dtype=torch.int64, device=device)
                    for a in (tokens, labels))
    step = p2p.make_sharded_round_fn(task, pcfg, group)
    cm_ops.launches.reset()
    group.barrier()
    start = time.perf_counter()
    after_local, after_cons, losses = step(state, batches)
    group.barrier()
    seconds = time.perf_counter() - start
    launches = cm_ops.launches.count
    want_local, want_cons, want_d = (ref_rows[i, me:me + 1] for i in range(3))
    # the sharded consensus alone, from the vmap round's post-local row
    pick, _ = p2p.round_picker(pcfg, device=device)
    lanes = graph_lib.schedule_lanes(p2p.build_schedule(pcfg))
    from_vmap = p2p.consensus_phase_sharded(
        after_local._replace(params=want_local.clone()), pcfg, pick(0), group=group,
        lanes=lanes, layout=p2p.ParamLayout.of(task))

    def diff(got, want):
        return float((got.float() - want.float()).abs().max())

    def close(got, want):
        return bool(torch.allclose(got.float(), want.float(), atol=5e-2, rtol=5e-2))

    return {
        "local_allclose": close(after_local.params, want_local),
        "consensus_allclose": close(after_cons.params, want_cons),
        "d_allclose": close(after_cons.d_bias, want_d),
        "local_max_abs_diff": diff(after_local.params, want_local),
        "local_equal": bool(torch.equal(after_local.params, want_local)),
        "consensus_max_abs_diff": diff(after_cons.params, want_cons),
        "consensus_equal": bool(torch.equal(after_cons.params, want_cons)),
        "d_max_abs_diff": diff(after_cons.d_bias, want_d),
        "consensus_from_vmap_equal": bool(torch.equal(from_vmap.params, want_cons)
                                          and torch.equal(from_vmap.d_bias, want_d)),
        "losses": losses, "seconds": seconds, "launches": launches, "stats": dict(group.stats),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
    }


def state_to(state: p2p.P2PState, device) -> p2p.P2PState:
    """A state's tensors moved to ``device`` (a rank's result comes back on
    the CPU)."""
    return p2p.with_leaves(state, [t.to(device) for t in p2p.state_leaves(state)],
                           state.round_idx)


# ---------------------------------------------------------------------------
# The hierarchical runtime over several ranks: a block of p peers a rank
# ---------------------------------------------------------------------------


def _tiny_init(gen: torch.Generator) -> dict[str, torch.Tensor]:
    return {"w": torch.randn((3, 2), generator=gen) * 0.1}


def _tiny_loss(params: dict, batch) -> torch.Tensor:
    x, y = batch  # (K, B, 3), (K, B, 2)
    return torch.mean(torch.square(torch.einsum("kbi,kij->kbj", x, params["w"]) - y),
                      dim=(1, 2))


def _tiny_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("kbi,kij->kbj", x, params["w"])


def _identity(x):
    return x


# The reference's K = 4096 test model (tests/test_hier_runtime.py: a (3, 2)
# linear map under a squared loss), for rounds of a large fleet that cost
# nothing but their communication.
TINY_TASK = task_lib.TrainTask(
    name="tiny_linear", param_shapes={"w": (3, 2)}, init_params=_tiny_init,
    loss_fn=_tiny_loss, apply_fn=_tiny_apply, make_peer_batches=pipeline.PeerBatcher,
    prepare_eval=_identity, description="a (3, 2) linear map, the reference's large-K test model")


def _tanh_init(gen: torch.Generator) -> dict[str, torch.Tensor]:
    return {"w1": torch.randn((6, 16), generator=gen), "b1": torch.zeros(16),
            "w2": torch.randn((16, 4), generator=gen)}


def _tanh_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(torch.einsum("kbi,kij->kbj", x, params["w1"]) + params["b1"][:, None, :])
    return torch.einsum("kbi,kij->kbj", h, params["w2"])


def _tanh_loss(params: dict, batch) -> torch.Tensor:
    x, y = batch  # (K, B, 6), (K, B, 4)
    return torch.mean(torch.sum(torch.square(_tanh_apply(params, x) - y), dim=-1), dim=-1)


# The reference's hierarchical-runtime test model (tests/test_hier_runtime.py:
# a 6-16-4 tanh MLP under a squared loss): its parity grid's rounds.
TANH_MLP = task_lib.TrainTask(
    name="tanh_mlp", param_shapes={"w1": (6, 16), "b1": (16,), "w2": (16, 4)},
    init_params=_tanh_init, loss_fn=_tanh_loss, apply_fn=_tanh_apply,
    make_peer_batches=pipeline.PeerBatcher, prepare_eval=_identity,
    description="a 6-16-4 tanh MLP, the reference's hierarchical test model")


class _ShapeRecorder(TorchDispatchMode):
    """Every tensor shape an operation produces while the mode is on."""

    def __init__(self, shapes: list):
        super().__init__()
        self.shapes = shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


@contextlib.contextmanager
def watch_consensus(record_shapes: bool = False):
    """While the block runs, every ``p2p.consensus_phase_hier_sharded`` call
    (a hierarchical rank's consensus phase) is watched: yields a dict whose
    "shapes" lists the shapes its operations made (with
    ``record_shapes``), "added_peak_bytes" the most memory the last call
    held on a card beyond what was allocated when it began, and
    "peak_bytes" the process's peak over the block, that call included."""
    real = p2p.consensus_phase_hier_sharded
    seen = {"shapes": [], "added_peak_bytes": 0, "peak_bytes": 0}

    def watched(state, *args, **kwargs):
        dev = state.params.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            seen["peak_bytes"] = max(seen["peak_bytes"], torch.cuda.max_memory_allocated(dev))
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with _ShapeRecorder(seen["shapes"]) if record_shapes else contextlib.nullcontext():
            out = real(state, *args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            seen["added_peak_bytes"] = peak - base
            seen["peak_bytes"] = max(seen["peak_bytes"], peak)
        return out

    p2p.consensus_phase_hier_sharded = watched
    try:
        yield seen
    finally:
        p2p.consensus_phase_hier_sharded = real
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            seen["peak_bytes"] = max(seen["peak_bytes"], torch.cuda.max_memory_allocated())


def kk_shapes(shapes: list, k: int) -> list:
    """The recorded shapes with two dimensions equal to ``k`` or a leading
    dimension of ``k``: what a rank's consensus phase must never make."""
    return [(op, s) for op, s in shapes
            if sum(d == k for d in s) >= 2 or (s and s[0] == k)]


def vmap_consensus_rank(group, cases: list[RoundCase]) -> dict:
    """A rank's consensus phase (``p2p.consensus_phase_hier_sharded``) from
    its block of each round's post-local state of the vmap runtime
    (``vmap_rounds``, run in the rank), against its block of that round's
    consensus: {case name: [equal digests, a round]}."""
    out = {}
    device, me = group.device, group.rank
    for case in cases:
        p = case.peers_per_device
        sizes = None if case.data_sizes is None else np.asarray(case.data_sizes)
        mode = p2p.resolve_mix_mode(case.mix_mode, case.cfg.num_peers)
        ops_s = p2p.schedule_operands(case.cfg, sizes, device=device)
        if mode == "segment":
            ops_s = protocols_lib.SparseRoundOps(*(t[:, me * p:(me + 1) * p].contiguous()
                                                   for t in ops_s))
        equal = []
        for after_local, after_cons, _ in vmap_rounds(case, device):
            ops = p2p.select_round(ops_s, after_local.round_idx % ops_s.self_w.shape[0])
            got = p2p.consensus_phase_hier_sharded(p2p.shard_state(after_local, me, p), case.cfg,
                                                   ops, group=group, mode=mode, row0=me * p)
            equal.append(state_digest(got) == state_digest(p2p.shard_state(after_cons, me, p)))
        out[case.name] = equal
    return out


def tiny_round_rank(group, cfgs: list[p2p.P2PConfig]) -> dict:
    """One round of each config (a large fleet, e.g. K = 4096 over 8 ranks)
    on ``TINY_TASK`` through ``make_sharded_round_fn``, from the stacked
    draw of seed 0 and batches from numpy's seed 0 (the reference test's);
    returns, a config, the losses, whether the rank's params and d are
    finite, its round index, the shapes its consensus phase made that have
    two dimensions or the leading one equal to K, and how many it made."""
    device, me, out = group.device, group.rank, []
    for cfg in cfgs:
        k, p = cfg.num_peers, cfg.num_peers // group.size
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.normal(size=(1, k, 2, 3)).astype(np.float32), device=device)
        y = torch.as_tensor(rng.normal(size=(1, k, 2, 2)).astype(np.float32), device=device)
        state = p2p.shard_state(p2p.init_state(TINY_TASK, cfg, seed=0, device=device), me, p)
        step = p2p.make_sharded_round_fn(TINY_TASK, cfg, group, peers_per_device=p,
                                         mix_mode="segment")
        rows = slice(me * p, (me + 1) * p)
        with watch_consensus(record_shapes=True) as seen:
            _, after, losses = step(state, (x[:, rows], y[:, rows]))
        out.append({"losses": losses, "round_idx": after.round_idx,
                    "finite": bool(torch.isfinite(after.params).all()
                                   and torch.isfinite(after.d_bias).all()),
                    "kk_shapes": kk_shapes(seen["shapes"], k), "shapes": len(seen["shapes"])})
    return out


def block_state(cfg: p2p.P2PConfig, params: torch.Tensor, rank: int, p: int,
                data_sizes: np.ndarray | None = None) -> p2p.P2PState:
    """A rank's initial block state of a synchronous, uncompressed config
    from the stacked (K, row) initial ``params`` (e.g. shared by the
    launcher: no rank draws the whole fleet): its p rows, zero momentum, d
    and b, and its rows of the protocol's initial state; the block of
    ``p2p.init_state``'s state."""
    blk = params[rank * p:(rank + 1) * p].clone()
    full = protocols_lib.get_protocol(cfg.protocol).init_state(
        torch.empty((cfg.num_peers, 0)), data_sizes)
    protocol = type(full)(*(t[rank * p:(rank + 1) * p].to(blk.device) for t in full)) \
        if full else ()
    return p2p.P2PState(blk, torch.zeros_like(blk), torch.zeros_like(blk), torch.zeros_like(blk),
                        round_idx=0, protocol=protocol)


def large_k_rank(group, cfgs: list[p2p.P2PConfig], init_params: torch.Tensor, batches,
                 data_sizes: np.ndarray | None) -> list[dict]:
    """One round of each config (the 2NN, a large K over the group's ranks)
    through ``make_sharded_round_fn``, each from the stacked initial
    ``init_params`` (shared by the launcher: no rank draws the fleet) and
    one round of ``batches`` = (x_all, y_all, idx (1, T, K, B)), a
    ``pipeline.ChunkBatches`` of the launcher's batcher on the CPU, the
    rank's rows of it: returns, a config, the losses, whether the rank's
    state is finite, its round index, the seconds, the launches, the rank's
    peak memory and what its consensus phase added to it."""
    device, me, out = group.device, group.rank, []
    x_all, y_all, idx = (t.to(device) for t in batches)
    for cfg in cfgs:
        p = cfg.num_peers // group.size
        rows = slice(me * p, (me + 1) * p)
        round_batches = (x_all[idx[0][:, rows]], y_all[idx[0][:, rows]])
        task = task_lib.get_task(cfg.model)
        state = block_state(cfg, init_params, me, p, data_sizes)
        step = p2p.make_sharded_round_fn(task, cfg, group, data_sizes, peers_per_device=p,
                                         mix_mode="segment")
        counts, before = _launch_counts(), dict(group.stats)
        group.barrier()
        start = time.perf_counter()
        with watch_consensus() as seen:
            _, after, losses = step(state, round_batches)
        group.barrier()
        seconds = time.perf_counter() - start
        finite = all(bool(torch.isfinite(t).all()) for t in
                     (after.params, after.momentum, after.d_bias, after.b_bias, losses))
        out.append({"protocol": cfg.protocol, "losses": losses, "finite": finite,
                    "round_idx": after.round_idx, "seconds": seconds,
                    "launches": {key: n - counts[key] for key, n in _launch_counts().items()},
                    "peak_bytes": seen["peak_bytes"],
                    "consensus_added_peak_bytes": seen["added_peak_bytes"],
                    "stats": {key: v - before[key] for key, v in group.stats.items()}})
        del state, after, round_batches
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return out


def hier_consensus_rank(group, checks: list[dict]) -> list[dict]:
    """A rank's "segment" consensus phase alone from a shared post-local
    state, against the one-device runtime's results on it.  Each check holds
    ``cfg``, ``data_sizes``, the ``round`` (0 if absent), the stacked
    post-local ``params`` and (push-sum) ``mass``, and the one-device
    consensus's ``want_params``, ``want_d``
    and (push-sum) ``want_mass``; returns, a check, whether the rank's
    rows equal them bit for bit, their largest differences, the rank's
    consensus launches, its peak memory and what the phase added to it."""
    from repro_torch.kernels.consensus_mix import segment  # noqa: PLC0415

    device, me, out = group.device, group.rank, []
    for chk in checks:
        cfg = chk["cfg"]
        p = cfg.num_peers // group.size
        rows = slice(me * p, (me + 1) * p)
        ops_s = p2p.schedule_operands(cfg, chk["data_sizes"], device=device)
        ops = p2p.select_round(protocols_lib.SparseRoundOps(
            *(t[:, rows].contiguous() for t in ops_s)), chk.get("round", 0))
        blk = chk["params"][rows].clone()
        protocol = () if chk.get("mass") is None else \
            protocols_lib.PushSumState(chk["mass"][rows].clone())
        state = p2p.P2PState(blk, torch.zeros_like(blk), torch.zeros_like(blk),
                             torch.zeros_like(blk), round_idx=chk.get("round", 0),
                             protocol=protocol)
        group.barrier()
        launches = segment.launches.count
        with watch_consensus() as seen:
            got = p2p.consensus_phase_hier_sharded(state, cfg, ops, group=group, mode="segment",
                                                   row0=me * p)
        want_p, want_d = chk["want_params"][rows], chk["want_d"][rows]
        res = {"protocol": cfg.protocol,
               "params_equal": bool(torch.equal(got.params, want_p)),
               "d_equal": bool(torch.equal(got.d_bias, want_d)),
               "params_max_abs_diff": float((got.params - want_p).abs().max()),
               "d_max_abs_diff": float((got.d_bias - want_d).abs().max()),
               "launches": segment.launches.count - launches,
               "peak_bytes": seen["peak_bytes"],
               "consensus_added_peak_bytes": seen["added_peak_bytes"]}
        if chk.get("mass") is not None:
            want_m = chk["want_mass"][rows]
            res["mass_equal"] = bool(torch.equal(got.protocol.mass, want_m))
            res["mass_max_abs_diff"] = float((got.protocol.mass - want_m).abs().max())
        out.append(res)
        del state, got, blk, want_p, want_d
    return out


def ring_gather_rank(group, gathers: list[tuple[torch.Tensor, torch.Tensor]]) -> list:
    """``consensus.ring_gather_slots`` of the rank's block of each stacked
    (K, ...) tensor and its block's rows of the (K, D) global indices."""
    out = []
    for x, nbr_idx in gathers:
        p = x.shape[0] // group.size
        rows = slice(group.rank * p, (group.rank + 1) * p)
        out.append(consensus_lib.ring_gather_slots(x[rows].to(group.device).contiguous(),
                                                   nbr_idx[rows].to(group.device), group))
    return out


def hier_rank(group, cases: list[RoundCase] = (), vmap_width: bool = False,
              from_vmap: list[RoundCase] = (), tiny: list[p2p.P2PConfig] = (),
              checks: list[dict] = (), large: tuple | None = None,
              gathers: list[tuple] = ()) -> dict:
    """One spawn's work of the hierarchical runtime over several ranks, in
    the order: ``ring_gather_rank`` of ``gathers``, ``round_cases_rank`` of
    ``cases`` at the rank's own width (and, with ``vmap_width``, at the vmap
    runtime's under "vmap_width"), ``vmap_consensus_rank`` of
    ``from_vmap``, ``hier_consensus_rank`` of ``checks``,
    ``tiny_round_rank`` of ``tiny`` and ``large_k_rank(*large)``."""
    out = {}
    if gathers:
        out["gathers"] = ring_gather_rank(group, list(gathers))
    if cases:
        out["cases"] = round_cases_rank(group, list(cases), 1)
        if vmap_width:
            out["vmap_width"] = round_cases_rank(group, list(cases), group.size)
    if from_vmap:
        out["from_vmap"] = vmap_consensus_rank(group, list(from_vmap))
    if checks:
        out["checks"] = hier_consensus_rank(group, list(checks))
    if tiny:
        out["tiny"] = tiny_round_rank(group, list(tiny))
    if large is not None:
        out["large"] = large_k_rank(group, *large)
    out["stats"] = dict(group.stats)
    return out

"""Training driver of the port (``repro.launch.train``'s ``run_paper_experiment``
on the stacked layout, with both of its round drivers).

``run_paper_experiment`` — K peers train the experiment's task
(``core/task.py``: the paper's 2NN by default, ``--model rwkv6_seqmnist``
for RWKV6 on sequential MNIST) on (synthetic-)MNIST shards under the
P2PL-with-Affinity family, measuring test accuracy after BOTH phases of the
last round of every eval period (the paper's instrument).  ``driver="scan"``
(the default, as in the reference) runs each eval period as one chunk of
``core.p2p.make_scan_driver``: on the card, one replay of a captured CUDA
graph of the round per round;
``driver="python"`` calls the round function once per round.  The two give
the same bits.  Runs on the GPU unless ``device="cpu"``.

``run_p2p_lm`` — the same algorithm family on a (reduced) language model of
the registry, as the reference's: K peers train on disjoint token spans, T
local steps then gossip, the vmap runtime and the python round loop.  On
the card every attention of the loss runs the ``flash_attention`` kernel
forward and backward, and a bf16 model's consensus the ``consensus_mix``
kernel's bf16 mode.

CLI:  python -m repro_torch.launch.train --experiment noniid_affinity --rounds 40
      python -m repro_torch.launch.train --experiment iid_k100 --eval-every 10
      python -m repro_torch.launch.train --experiment noniid_affinity --driver python
      python -m repro_torch.launch.train --experiment timevarying_k8 \
          --schedule round_robin --compressor qint8
      python -m repro_torch.launch.train --experiment timevarying_k8 \
          --peer-axis pod --peers-per-device 8 --mix-mode segment
      python -m repro_torch.launch.train --experiment sharded_k8 --peer-axis pod \
          (one process per peer)
      python -m repro_torch.launch.train --experiment directed_k8 \
          --schedule one_way_matching   (push-sum on one-way links)
      python -m repro_torch.launch.train --experiment straggler_k8 \
          --schedule round_robin --protocol push_sum   (bounded staleness)
      python -m repro_torch.launch.train --experiment iid_k100 \
          --steps-profile straggler --staleness-bound 3
      python -m repro_torch.launch.train --experiment timevarying_k8 \
          --schedule adaptive --partner-rule eps_greedy   (matchings chosen on the device)
      python -m repro_torch.launch.train --experiment seqmnist_k8 --rounds 4 \
          --protocol push_sum   (RWKV6 on sequential MNIST; --model picks the task)
      python -m repro_torch.launch.train --experiment p2p_lm --arch smollm-135m --rounds 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.compression import compressor_names
from repro_torch.configs import ARCHITECTURES, get_config, reduced
from repro_torch.configs.p2pl_mnist import (
    PaperExperiment,
    directed_k8,
    iid_k100,
    noniid_k2,
    seqmnist_k8,
    sharded_k8,
    straggler_k8,
    timevarying_k2,
    timevarying_k8,
)
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import features as features_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import p2p
from repro_torch.core import peer_group
from repro_torch.core import protocols as protocols_lib
from repro_torch.core import task as task_lib
from repro_torch.data import partition, synthetic
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model


def mnist_parts(exp: PaperExperiment, x, y):
    if exp.peer_classes:
        return partition.pathological_partition(
            x, y, list(exp.peer_classes), samples_per_class=exp.samples_per_class
        )
    return partition.iid_partition(x, y, exp.p2p.num_peers)


def chunked_accuracy(apply_fn, params: dict, x_eval: torch.Tensor, y_eval: np.ndarray,
                     groups: dict[str, np.ndarray], batch: int) -> dict[str, np.ndarray]:
    """``p2p.stratified_accuracy`` over ``batch``-sized chunks of the eval
    set (the reference's chunked eval): each chunk's predictions over the
    union of the groups' classes, then each group's (K,) accuracy from the
    concatenated (K, N) predictions, on the host."""
    classes = np.sort(np.concatenate(list(groups.values())))
    pred = torch.cat([p2p.masked_predictions(apply_fn, params, x_eval[i:i + batch], classes)
                      for i in range(0, x_eval.shape[0], batch)], dim=1).cpu().numpy()
    out = {}
    for name, group in groups.items():
        sel = np.isin(y_eval, group)
        denom = max(int(sel.sum()), 1)
        out[name] = ((pred == y_eval[None, :]) & sel[None, :]).sum(axis=1) / denom
    return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_eval_fn(exp: PaperExperiment, task: task_lib.TrainTask, x_te: np.ndarray,
                 y_te: np.ndarray, *, seed: int, device: torch.device
                 ) -> Callable[[p2p.P2PState], dict[str, np.ndarray]]:
    """``eval_fn(state) -> {group: (K,) accuracy}``, the reference's evaluation:
    one "peer{k}_seen" group per peer's classes and "all" their union (the
    test set restricted to it), or "all" ten classes for IID runs; the task's
    seeded, sorted subsample of ``eval_set_size`` examples, in its input
    format, once on ``device``; every peer's predictions over the union's
    classes, in one apply or in ``eval_batch_size`` chunks
    (``chunked_accuracy``)."""
    if exp.peer_classes:
        all_classes = sorted({c for cls in exp.peer_classes for c in cls})
        groups = {f"peer{k}_seen": np.asarray(cls) for k, cls in enumerate(exp.peer_classes)}
        groups["all"] = np.asarray(all_classes)
        sel = np.isin(y_te, all_classes)
        x_eval, y_eval = x_te[sel], y_te[sel]
    else:
        groups = {"all": np.arange(10)}
        x_eval, y_eval = x_te, y_te
    if task.eval_set_size is not None and len(x_eval) > task.eval_set_size:
        idx = np.random.default_rng(seed).permutation(len(x_eval))
        idx = np.sort(idx[: task.eval_set_size])
        x_eval, y_eval = x_eval[idx], y_eval[idx]
    x_eval_t = torch.as_tensor(np.asarray(task.prepare_eval(x_eval)), device=device)
    y_eval_t = torch.as_tensor(y_eval, dtype=torch.int64, device=device)

    def eval_fn(st: p2p.P2PState) -> dict[str, np.ndarray]:
        params = p2p.param_views(st, task)
        if task.eval_batch_size is not None:
            return chunked_accuracy(task.apply_fn, params, x_eval_t, y_eval, groups,
                                    task.eval_batch_size)
        acc = p2p.stratified_accuracy(task.apply_fn, params, x_eval_t, y_eval_t, groups)
        return {k: v.cpu().numpy() for k, v in acc.items()}

    return eval_fn


def run_paper_experiment(
    exp: PaperExperiment,
    *,
    rounds: Optional[int] = None,
    data=None,
    eval_every: int = 1,
    seed: int = 0,
    verbose: bool = False,
    device: torch.device | str | None = None,
    peer_axis: str = "vmap",
    driver: str = "scan",
    peers_per_device: int = 1,
    mix_mode: str = "auto",
    return_state: bool = False,
    on_round: Optional[Callable[[int, p2p.P2PState], None]] = None,
):
    """Train ``exp`` for ``rounds`` rounds, evaluating after both phases of
    rounds ``eval_every``, ``2 * eval_every``, ... and the last; returns the
    ``RoundLog``, one record per eval period.

    ``driver``: "scan" (the default) runs each eval period as ONE chunk of
    ``p2p.make_scan_driver`` (the input state donated: on the card each
    round a replay of one captured CUDA graph, the first round of the run
    its warm-up, and nothing read back to the host within a period);
    "python" calls the round function once per round (the parity baseline:
    the two are float32 bit-identical).  Both evaluate at the same rounds.

    ``peer_axis="vmap"`` stacks the K peers on one device.  ``"pod"`` with
    one peer per device (``peers_per_device=1``) is the sharded runtime: K
    processes, one peer each (``launch.pod.experiment_rank`` under
    ``core.peer_group.spawn_peers``: gloo ranks on the CPU, CUDA IPC ranks
    on one card), the same data, batches and initial state as the vmap run;
    rank 0 evaluates both phases' gathered rows with the same ``eval_fn``,
    so the log's accuracies are the vmap run's.  ``on_round`` is not called there (the
    state lives in the ranks).  ``"pod"`` with ``peers_per_device == K`` is
    the reference's hierarchical runtime on a one-slice mesh: the same
    stacked peers, consensus over the degree-bounded sparse schedule,
    ``mix_mode`` "bridge" (the vmap runtime's mix, bit for bit), "segment"
    (the ``segment_mix`` kernel, the large-K form) or "auto" (bridge iff K
    <= 64).  ``"pod"`` with 1 < ``peers_per_device`` = p < K is the
    hierarchical runtime over several slices: K / p ranks, a block of p
    peers each (``launch.pod.experiment_rank`` with p), mixed in
    ``mix_mode`` across the ranks (``p2p.make_sharded_round_fn``); rank 0
    evaluates the gathered blocks as above.

    Evaluation follows the task (``make_eval_fn``): the whole
    class-filtered test set in one apply, or, where the task sets them, a
    seeded subsample of ``eval_set_size`` examples in chunks of
    ``eval_batch_size``, as the reference evaluates ``rwkv6_seqmnist``.

    The log's ``seconds`` hold each eval period's wall time from its first
    batch draw to the end of its last consensus, device work included and
    evaluation excluded, divided by its rounds; the scan driver's first
    period includes its warm-up round and capture, whose time is also in
    ``log.capture_seconds``.  ``return_state=True`` returns ``(log,
    final_state)``; ``on_round(r, state)``, if given, is called at the end
    of each eval period (round ``r``) with the state after its consensus
    (e.g. to watch push-sum's mass).
    """
    if peer_axis not in ("vmap", "pod"):
        raise ValueError(f"peer_axis must be 'vmap' or 'pod', got {peer_axis!r}")
    if driver not in ("scan", "python"):
        raise ValueError(f"driver must be 'scan' or 'python', got {driver!r}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if peers_per_device < 1:
        raise ValueError(f"peers_per_device must be >= 1, got {peers_per_device}")
    if peers_per_device > 1 and peer_axis != "pod":
        raise ValueError(
            "peers_per_device > 1 is the hierarchical sharded runtime — "
            "it needs peer_axis='pod' (the vmap runtime already holds every "
            "peer on one device)"
        )
    features_lib.check_config(exp.p2p, peers_per_device=peers_per_device)
    slices = 1
    if peer_axis == "pod" and peers_per_device > 1:
        slices = p2p.check_hierarchical_layout(exp.p2p.num_peers, peers_per_device)
        p2p.resolve_mix_mode(mix_mode, exp.p2p.num_peers)
    device = resolve_device(device)
    rounds = rounds or exp.rounds
    if peer_axis == "pod" and (peers_per_device == 1 or slices > 1):
        if on_round is not None:
            raise ValueError("on_round is not called by the sharded runtime "
                             f"(peers_per_device={peers_per_device}): its state lives in the "
                             "ranks; use return_state")
        from repro_torch.launch import pod  # noqa: PLC0415 (pod imports this module)

        # drawn once, here; tensors reach the ranks in shared memory, arrays by pickle
        data = tuple(torch.as_tensor(np.ascontiguousarray(a))
                     for a in (synthetic.mnist_like() if data is None else data))
        task = task_lib.get_task(exp.p2p.model)
        hier = dict(peers_per_device=peers_per_device, mix_mode=mix_mode)
        results = peer_group.spawn_peers(
            pod.experiment_rank, exp.p2p.num_peers // peers_per_device, device,
            args=(exp, rounds, data, eval_every, seed, verbose, driver, return_state,
                  torch.get_num_threads(), peers_per_device, mix_mode),
            inbox_bytes=p2p.inbox_bytes(task, exp.p2p, whole_blocks=True, **hier),
            ring_bytes=p2p.ring_bytes(task, exp.p2p, **hier))
        log = results[0]["log"]
        log.ranks = [{key: r[key] for key in ("exchange", "launches", "peak_bytes")}
                     for r in results]
        return (log, pod.state_to(results[0]["state"], device)) if return_state else log
    task = task_lib.get_task(exp.p2p.model)
    cfg = exp.p2p
    if data is None:
        data = synthetic.mnist_like()
    x_tr, y_tr, x_te, y_te = data
    parts = mnist_parts(exp, x_tr, y_tr)
    sizes = partition.data_sizes(parts)

    batcher = task.make_peer_batches(parts, exp.batch_size, seed=seed)
    state = p2p.init_state(task, cfg, seed=seed, data_sizes=sizes, device=device)
    hier = (dict(peers_per_device=peers_per_device, mix_mode=mix_mode)
            if peer_axis == "pod" else {})
    if driver == "scan":
        drive_fn = p2p.make_scan_driver(task, cfg, sizes, device=device, **hier)
    elif peer_axis == "pod":
        round_fn = p2p.make_hier_round_fn(task, cfg, sizes, device=device, **hier)
    else:
        round_fn = p2p.make_round_fn(task, cfg, data_sizes=sizes, device=device)

    eval_fn = make_eval_fn(exp, task, x_te, y_te, seed=seed, device=device)

    log = metrics_lib.RoundLog()
    r = 0
    while r < rounds:
        n = min(eval_every, rounds - r)
        start = time.perf_counter()
        if driver == "scan":
            chunk = batcher.chunk_batches_on(cfg.local_steps, n, device)
            # the input state is donated: use only the returns
            after_local, state, losses = drive_fn(state, chunk)
            losses = losses[-1]  # the period's last round, (T,)
        else:
            for _ in range(n):
                batches = batcher.round_batches_on(cfg.local_steps, device)
                after_local, state, losses = round_fn(state, batches)
        _synchronize(device)
        seconds = (time.perf_counter() - start) / n
        r += n
        acc_l, acc_c = eval_fn(after_local), eval_fn(state)
        loss = float(losses.mean())
        log.record(
            local_acc=acc_l,
            consensus_acc=acc_c,
            drift=float(consensus_lib.pairwise_drift(after_local.params)),
            consensus_error=float(consensus_lib.consensus_error(state.params)),
            train_loss=loss,
            seconds=seconds,
        )
        if on_round is not None:
            on_round(r - 1, state)
        if verbose:
            print(
                f"round {r - 1:3d} loss={loss:.4f} "
                f"acc(after local)={acc_l['all'].mean():.3f} "
                f"acc(after consensus)={acc_c['all'].mean():.3f} "
                f"({seconds:.4f} s/round)",
                flush=True,
            )
    if driver == "scan":
        log.capture_seconds = drive_fn.capture_seconds
    if return_state:
        return log, state
    return log


def lm_token_batches(rng: np.random.Generator, vocab_size: int, *, num_peers: int,
                     local_steps: int, batch: int, seq: int) -> tuple[np.ndarray, np.ndarray]:
    """One round's (tokens, labels), (T, K, B, S) int32 each, drawn as the
    reference's ``run_p2p_lm`` draws them: peer k's tokens from its own span
    of the vocabulary (non-IID token distributions), labels the next token."""
    tokens = np.empty((local_steps, num_peers, batch, seq), np.int32)
    labels = np.empty_like(tokens)
    span = vocab_size // num_peers
    for t in range(local_steps):
        for k in range(num_peers):
            toks = rng.integers(k * span, (k + 1) * span, size=(batch, seq + 1))
            tokens[t, k] = toks[:, :-1]
            labels[t, k] = toks[:, 1:]
    return tokens, labels


def lm_config(*, num_peers: int, local_steps: int, algorithm: str, lr: float,
              momentum: float, eta_d: float) -> p2p.P2PConfig:
    """The reference ``run_p2p_lm``'s P2P configuration: S = 1, complete graph."""
    return p2p.P2PConfig(algorithm=algorithm, num_peers=num_peers, local_steps=local_steps,
                         consensus_steps=1, lr=lr, momentum=momentum, eta_d=eta_d,
                         topology="complete")


def run_p2p_lm(
    arch: str = "smollm-135m",
    *,
    num_peers: int = 2,
    local_steps: int = 4,
    rounds: int = 8,
    batch: int = 4,
    seq: int = 32,
    algorithm: str = "p2pl_affinity",
    lr: float = 1e-2,
    momentum: float = 0.5,
    eta_d: float = 0.25,
    seed: int = 0,
    verbose: bool = False,
    device: torch.device | str | None = None,
    init_params: dict[str, torch.Tensor] | None = None,
) -> dict:
    """K peers, disjoint token shards, local-DSGD / P2PL rounds on
    ``reduced(get_config(arch))`` (the reference's ``run_p2p_lm``, its
    defaults; eta_d 0.25, as the reference explains: with K = 2 and a fully
    averaging consensus eta_d = 1 re-injects the whole pre-consensus drift).
    The model becomes a task (``core.task.from_model``) on the vmap runtime;
    ``init_params`` (stacked (K, ...) leaves, e.g. the reference's exported
    initial state) replaces the draw from ``seed``.  Returns {"losses": each
    round's mean local loss, "final_drift": ``pairwise_drift`` of the final
    parameters}."""
    device = resolve_device(device)
    cfg = reduced(get_config(arch))
    task = task_lib.from_model(build_model(cfg))
    p2p_cfg = lm_config(num_peers=num_peers, local_steps=local_steps,
                        algorithm=algorithm, lr=lr, momentum=momentum, eta_d=eta_d)
    state = p2p.init_state(task, p2p_cfg, seed=seed, device=device, init_params=init_params)
    round_fn = p2p.make_round_fn(task, p2p_cfg, device=device)
    rng = np.random.default_rng(seed)
    losses = []
    for r in range(rounds):
        tokens, labels = lm_token_batches(rng, cfg.vocab_size, num_peers=num_peers,
                                          local_steps=local_steps, batch=batch, seq=seq)
        batches = tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                        for a in (tokens, labels))
        _, state, step_losses = round_fn(state, batches)
        losses.append(float(step_losses.mean()))
        if verbose:
            print(f"round {r}: loss {losses[-1]:.4f}", flush=True)
    drift = float(consensus_lib.pairwise_drift(*p2p.param_blocks(state)))
    return {"losses": losses, "final_drift": drift}


def _timevarying(builder):
    def build(args) -> PaperExperiment:
        return builder(
            schedule=args.schedule or "link_dropout",
            algorithm=args.algorithm,
            local_steps=args.local_steps or 10,
            schedule_rounds=args.schedule_rounds,
            link_survival_prob=args.link_survival_prob,
            peer_online_prob=args.peer_online_prob,
            round_robin_topologies=tuple(t for t in args.round_robin_topologies.split(",") if t),
            partner_rule=args.partner_rule,
            adaptive_eps=args.adaptive_eps,
            adaptive_seed=args.adaptive_seed,
        )

    return build


DIRECTED_SCHEDULES = ("static", "link_dropout", "one_way_matching", "adaptive")


def _directed(args) -> PaperExperiment:
    schedule = args.schedule or "static"
    if schedule not in DIRECTED_SCHEDULES:
        raise ValueError(f"directed_k8 supports --schedule {'|'.join(DIRECTED_SCHEDULES)}, "
                         f"got {schedule!r}")
    return directed_k8(
        schedule=schedule,
        protocol=args.protocol or "push_sum",
        algorithm=args.algorithm,
        local_steps=args.local_steps or 10,
        schedule_rounds=args.schedule_rounds,
        link_survival_prob=args.link_survival_prob,
        partner_rule=args.partner_rule,
        adaptive_eps=args.adaptive_eps,
        adaptive_seed=args.adaptive_seed,
    )


STRAGGLER_SCHEDULES = ("static", "round_robin")


def _straggler(args) -> PaperExperiment:
    schedule = args.schedule or "static"
    if schedule not in STRAGGLER_SCHEDULES:
        raise ValueError(f"straggler_k8 supports --schedule {'|'.join(STRAGGLER_SCHEDULES)}, "
                         f"got {schedule!r}")
    return straggler_k8(
        schedule=schedule,
        protocol=args.protocol or "gossip",
        algorithm=args.algorithm,
        local_steps=args.local_steps or 8,
        steps_profile=args.steps_profile or "straggler",
        staleness_bound=3 if args.staleness_bound is None else args.staleness_bound,
        staleness_decay=0.5 if args.staleness_decay is None else args.staleness_decay,
        schedule_rounds=args.schedule_rounds,
        round_robin_topologies=tuple(t for t in args.round_robin_topologies.split(",") if t),
    )


def _seqmnist(args) -> PaperExperiment:
    return seqmnist_k8(
        schedule=args.schedule or "static",
        protocol=args.protocol or "gossip",
        local_steps=args.local_steps or 4,
        schedule_rounds=args.schedule_rounds,
        round_robin_topologies=tuple(t for t in args.round_robin_topologies.split(",") if t),
    )


def _sharded(args) -> PaperExperiment:
    return sharded_k8(
        schedule=args.schedule or "static",
        protocol=args.protocol or "gossip",
        algorithm=args.algorithm,
        local_steps=args.local_steps or 10,
        schedule_rounds=args.schedule_rounds,
        link_survival_prob=args.link_survival_prob,
        round_robin_topologies=tuple(t for t in args.round_robin_topologies.split(",") if t),
        partner_rule=args.partner_rule,
        adaptive_eps=args.adaptive_eps,
        adaptive_seed=args.adaptive_seed,
    )


# experiment name -> builder from the parsed CLI arguments (the reference
# CLI's, src/repro/launch/train.py, for the experiments the port runs)
EXPERIMENTS = {
    "iid_k100": lambda a: iid_k100(topology=a.topology),
    "noniid_local_dsgd": lambda a: noniid_k2(algorithm="local_dsgd",
                                             local_steps=a.local_steps or 10),
    "noniid_dsgd": lambda a: noniid_k2(algorithm="dsgd", local_steps=1),
    "noniid_affinity": lambda a: noniid_k2(algorithm="p2pl_affinity",
                                           local_steps=a.local_steps or 10),
    "timevarying_k2": _timevarying(timevarying_k2),
    "timevarying_k8": _timevarying(timevarying_k8),
    "directed_k8": _directed,
    "straggler_k8": _straggler,
    "seqmnist_k8": _seqmnist,
    "sharded_k8": _sharded,
}
# every pretraced schedule, and the adaptive matchings chosen on the device
SCHEDULE_CHOICES = ["static", "link_dropout", "random_matching", "peer_churn", "round_robin",
                    "one_way_matching", "adaptive"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment", default="noniid_affinity",
                    choices=sorted([*EXPERIMENTS, "p2p_lm"]))
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHITECTURES),
                    help="with --experiment p2p_lm: the architecture whose reduced config "
                         "the peers train")
    ap.add_argument("--model", default=None, choices=sorted(task_lib.task_names()),
                    help="the TrainTask the peers train (core/task.py): 'mnist_mlp', the "
                         "paper's 2NN on flat images; 'rwkv6_seqmnist', RWKV6 run as an RNN "
                         "over the 196-token pixel stream of sequential MNIST.  Default: the "
                         "experiment's own (mnist_mlp everywhere but seqmnist_k8)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: the experiment's own (40-100)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda; cpu runs each kernel's plain PyTorch version")
    ap.add_argument("--topology", default="complete", help="graph of iid_k100")
    ap.add_argument("--local-steps", type=int, default=None,
                    help="T local SGD steps per round (default: the experiment's own: 10 "
                         "everywhere but straggler_k8's 8 and seqmnist_k8's 4)")
    ap.add_argument("--algorithm", default="p2pl_affinity",
                    help="algorithm for timevarying_*, directed_k8 and straggler_k8 "
                         "experiments")
    ap.add_argument("--schedule", default=None, choices=SCHEDULE_CHOICES,
                    help="communication-graph schedule for timevarying_*, directed_k8 and "
                         "straggler_k8 experiments (default: link_dropout for "
                         "timevarying_*, static for directed_k8, which takes "
                         "static|link_dropout|one_way_matching|adaptive, and for "
                         "straggler_k8, which takes static|round_robin).  'adaptive' selects "
                         "gossip partners on the device each round from the peers' own "
                         "training losses (see --partner-rule)")
    ap.add_argument("--partner-rule", default="loss_proximity",
                    choices=sorted(graph_lib.ADAPTIVE_RULES),
                    help="how --schedule adaptive scores candidate partners: "
                         "loss_proximity pairs peers with the closest recent training loss, "
                         "random is the matched-communication baseline, eps_greedy explores "
                         "a random matching with probability --adaptive-eps")
    ap.add_argument("--adaptive-eps", type=float, default=0.1,
                    help="exploration probability for --partner-rule eps_greedy (in [0, 1])")
    ap.add_argument("--adaptive-seed", type=int, default=0,
                    help="seeds the threefry key threaded through the adaptive selection "
                         "state")
    ap.add_argument("--protocol", default=None, choices=list(protocols_lib.protocol_names()),
                    help="consensus protocol, for any experiment (default: the "
                         "experiment's own: gossip everywhere but directed_k8's push_sum)")
    ap.add_argument("--schedule-rounds", type=int, default=16,
                    help="period of the stochastic schedule (cycled)")
    ap.add_argument("--link-survival-prob", type=float, default=0.7)
    ap.add_argument("--peer-online-prob", type=float, default=0.8)
    ap.add_argument("--round-robin-topologies", default="ring,star",
                    help="comma-separated topology names cycled by --schedule round_robin")
    ap.add_argument("--compressor", default=None, choices=sorted(compressor_names()),
                    help="consensus-payload compression, for any experiment: 'none' "
                         "ships raw float32, 'topk' keeps the --topk-frac largest-|h| "
                         "entries per leaf, 'qint8' ships int8 + one float32 scale per "
                         "leaf; both with error feedback")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="fraction of entries the 'topk' compressor keeps per leaf, in (0, 1]")
    ap.add_argument("--steps-profile", default=None, choices=sorted(p2p.STEPS_PROFILES),
                    help="per-peer compute profile, for any experiment (core/p2p.py "
                         "compute_profile): 'uniform', every peer runs all T local steps "
                         "(the synchronous round, bit-identical); 'straggler', the last "
                         "straggler_frac of the peers run T/straggler_period steps and "
                         "publish every straggler_period-th round; 'linear', per-peer "
                         "speeds ramp from 1 down to 1/straggler_period")
    ap.add_argument("--staleness-bound", type=int, default=None,
                    help="bounded-staleness gossip, for any experiment: peers mix each "
                         "sender's last published snapshot, at most this many rounds old "
                         "(delivery forced at the bound); 0 (default) mixes synchronously, "
                         "> 0 takes the consensus_mix kernel's snapshot mode with "
                         "age-decayed, renormalised weights")
    ap.add_argument("--staleness-decay", type=float, default=None,
                    help="per-round decay of a stale snapshot's mixing weight (weight *= "
                         "decay^age, the diagonal renormalised per the protocol's "
                         "stochasticity); in (0, 1], default 0.5")
    ap.add_argument("--peer-axis", default="vmap", choices=["vmap", "pod"],
                    help="how the K peer axis executes: 'vmap' (stacked runtime) or 'pod' "
                         "(one process per peer with --peers-per-device 1, K processes on "
                         "the one card or on the CPU; the one-slice hierarchical runtime "
                         "with --peers-per-device = K)")
    ap.add_argument("--peers-per-device", type=int, default=1,
                    help="with --peer-axis pod: peers per device; 1 runs the sharded runtime "
                         "(a process a peer), K the one-slice hierarchical runtime, "
                         "consensus over the degree-bounded sparse schedule")
    ap.add_argument("--mix-mode", default="auto", choices=sorted(p2p.MIX_MODES),
                    help="hierarchical consensus form (only with --peers-per-device > 1): "
                         "'bridge' is the vmap runtime's mix (bit-identical, K <= 64), "
                         "'segment' the degree-bounded segment_mix kernel (allclose), "
                         "'auto' picks bridge iff K <= 64")
    ap.add_argument("--driver", default="scan", choices=["scan", "python"],
                    help="round driver: 'scan' runs each eval period as one chunk of "
                         "replays of a captured CUDA graph of the round (donated state, "
                         "one host transfer per period); 'python' runs one eager round "
                         "per loop iteration (debug/parity baseline)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="evaluate every N rounds (the end of each period); with "
                         "--driver scan this is also the fused chunk size — N rounds per "
                         "call, so N > 1 is where the scan driver's amortization engages")
    args = ap.parse_args(argv)
    if not 0.0 <= args.adaptive_eps <= 1.0:
        ap.error(f"--adaptive-eps must be in [0, 1], got {args.adaptive_eps}")
    if args.eval_every < 1:
        ap.error(f"--eval-every must be >= 1, got {args.eval_every}")
    if not 0.0 < args.topk_frac <= 1.0:
        ap.error(f"--topk-frac must be in (0, 1], got {args.topk_frac}")

    if args.experiment == "p2p_lm":
        if args.peer_axis != "vmap":
            ap.error("p2p_lm runs the vmap runtime only (--peer-axis vmap)")
        out = run_p2p_lm(args.arch, rounds=args.rounds or 8, verbose=True, device=args.device)
        print(json.dumps(out))
        return
    try:
        exp = EXPERIMENTS[args.experiment](args)
    except ValueError as e:
        ap.error(str(e))
    if args.model and args.model != exp.model:
        try:
            exp = dataclasses.replace(exp, model=args.model,
                                      p2p=dataclasses.replace(exp.p2p, model=args.model))
        except ValueError as e:
            ap.error(str(e))
    if args.protocol and exp.p2p.protocol != args.protocol:
        exp = dataclasses.replace(exp, p2p=dataclasses.replace(exp.p2p, protocol=args.protocol))
    if args.compressor and (exp.p2p.compressor != args.compressor
                            or exp.p2p.topk_frac != args.topk_frac):
        try:
            exp = dataclasses.replace(exp, p2p=dataclasses.replace(
                exp.p2p, compressor=args.compressor, topk_frac=args.topk_frac))
        except ValueError as e:
            ap.error(str(e))
    async_overrides = {
        k: v for k, v in (
            ("steps_profile", args.steps_profile),
            ("staleness_bound", args.staleness_bound),
            ("staleness_decay", args.staleness_decay),
        ) if v is not None and getattr(exp.p2p, k) != v
    }
    if async_overrides:
        try:
            exp = dataclasses.replace(exp, p2p=dataclasses.replace(exp.p2p, **async_overrides))
        except ValueError as e:
            ap.error(str(e))
    if args.peers_per_device < 1:
        ap.error(f"--peers-per-device must be >= 1, got {args.peers_per_device}")
    if args.peers_per_device > 1 and args.peer_axis != "pod":
        ap.error("--peers-per-device > 1 needs --peer-axis pod "
                 "(the hierarchical sharded runtime)")
    try:
        features_lib.check_config(exp.p2p, peers_per_device=args.peers_per_device)
    except ValueError as e:
        ap.error(str(e))
    if args.peer_axis == "pod" and exp.p2p.num_peers % args.peers_per_device:
        ap.error(
            f"--peers-per-device {args.peers_per_device} does not divide "
            f"num_peers={exp.p2p.num_peers} of experiment {exp.name!r}"
        )
    t0 = time.time()
    log = run_paper_experiment(exp, rounds=args.rounds, eval_every=args.eval_every,
                               verbose=True, device=args.device, peer_axis=args.peer_axis,
                               driver=args.driver, peers_per_device=args.peers_per_device,
                               mix_mode=args.mix_mode)
    if args.driver == "scan":
        print(f"warm-up round and capture: {log.capture_seconds:.3f}s")
    print(f"done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()

"""Training driver of the port (``repro.launch.train``'s python-loop driver on
the stacked layout).

``run_paper_experiment`` — K peers train the experiment's task on
(synthetic-)MNIST shards under the P2PL-with-Affinity family, measuring test
accuracy after BOTH phases of every evaluated round (the paper's
instrument).  Runs on the GPU unless ``device="cpu"``.

CLI:  python -m repro_torch.launch.train --experiment noniid_affinity --rounds 40
      python -m repro_torch.launch.train --experiment timevarying_k8 \
          --schedule round_robin --compressor qint8
      python -m repro_torch.launch.train --experiment timevarying_k8 \
          --peer-axis pod --peers-per-device 8 --mix-mode segment
      python -m repro_torch.launch.train --experiment directed_k8 \
          --schedule one_way_matching   (push-sum on one-way links)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.compression import compressor_names
from repro_torch.configs.p2pl_mnist import (
    PaperExperiment,
    directed_k8,
    iid_k100,
    noniid_k2,
    timevarying_k2,
    timevarying_k8,
)
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import features as features_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import p2p
from repro_torch.core import protocols as protocols_lib
from repro_torch.core import task as task_lib
from repro_torch.data import partition, synthetic
from repro_torch.device import resolve_device


def mnist_parts(exp: PaperExperiment, x, y):
    if exp.peer_classes:
        return partition.pathological_partition(
            x, y, list(exp.peer_classes), samples_per_class=exp.samples_per_class
        )
    return partition.iid_partition(x, y, exp.p2p.num_peers)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_paper_experiment(
    exp: PaperExperiment,
    *,
    rounds: Optional[int] = None,
    data=None,
    seed: int = 0,
    verbose: bool = False,
    device: torch.device | str | None = None,
    peer_axis: str = "vmap",
    peers_per_device: int = 1,
    mix_mode: str = "auto",
    return_state: bool = False,
    on_round: Optional[Callable[[int, p2p.P2PState], None]] = None,
):
    """Train ``exp`` for ``rounds`` rounds, evaluating after both phases of
    every round; returns the ``RoundLog``.

    ``peer_axis="vmap"`` stacks the K peers on one device.  ``"pod"`` with
    ``peers_per_device == K`` is the reference's hierarchical runtime on a
    one-slice mesh: the same stacked peers, consensus over the
    degree-bounded sparse schedule, ``mix_mode`` "bridge" (the vmap
    runtime's mix, bit for bit), "segment" (the ``segment_mix`` kernel, the
    large-K form) or "auto" (bridge iff K <= 64).  Other pod layouts need
    several devices (ROADMAP.md queue 1 item 15).

    The log's ``seconds`` hold each round's wall time from batch gather to
    the end of consensus, device work included (evaluation excluded).
    ``return_state=True`` returns ``(log, final_state)``; ``on_round(r,
    state)``, if given, is called after round ``r`` with the state after its
    consensus (e.g. to watch push-sum's mass).
    """
    if peer_axis not in ("vmap", "pod"):
        raise ValueError(f"peer_axis must be 'vmap' or 'pod', got {peer_axis!r}")
    if peers_per_device < 1:
        raise ValueError(f"peers_per_device must be >= 1, got {peers_per_device}")
    if peers_per_device > 1 and peer_axis != "pod":
        raise ValueError(
            "peers_per_device > 1 is the hierarchical sharded runtime — "
            "it needs peer_axis='pod' (the vmap runtime already holds every "
            "peer on one device)"
        )
    features_lib.check_config(exp.p2p, peers_per_device=peers_per_device)
    if peer_axis == "pod":
        if peers_per_device == 1:
            raise NotImplementedError(
                "peer_axis='pod' with one peer per device (the sharded runtime) is not "
                "ported yet: ROADMAP.md queue 1 item 15"
            )
        p2p.check_hierarchical_layout(exp.p2p.num_peers, peers_per_device)
    device = resolve_device(device)
    rounds = rounds or exp.rounds
    task = task_lib.get_task(exp.p2p.model)
    cfg = exp.p2p
    if data is None:
        data = synthetic.mnist_like()
    x_tr, y_tr, x_te, y_te = data
    parts = mnist_parts(exp, x_tr, y_tr)
    sizes = partition.data_sizes(parts)

    batcher = task.make_peer_batches(parts, exp.batch_size, seed=seed)
    state = p2p.init_state(task, cfg, seed=seed, data_sizes=sizes, device=device)
    if peer_axis == "pod":
        round_fn = p2p.make_hier_round_fn(task, cfg, sizes, peers_per_device=peers_per_device,
                                          mix_mode=mix_mode, device=device)
    else:
        round_fn = p2p.make_round_fn(task, cfg, data_sizes=sizes, device=device)

    # stratified eval groups: seen/unseen per the union of peer classes
    if exp.peer_classes:
        all_classes = sorted({c for cls in exp.peer_classes for c in cls})
        groups = {f"peer{k}_seen": np.asarray(cls) for k, cls in enumerate(exp.peer_classes)}
        groups["all"] = np.asarray(all_classes)
        sel = np.isin(y_te, all_classes)
        x_eval, y_eval = x_te[sel], y_te[sel]
    else:
        groups = {"all": np.arange(10)}
        x_eval, y_eval = x_te, y_te
    x_eval_t = torch.as_tensor(np.asarray(task.prepare_eval(x_eval)), device=device)
    y_eval_t = torch.as_tensor(y_eval, dtype=torch.int64, device=device)

    def eval_fn(st: p2p.P2PState):
        acc = p2p.stratified_accuracy(
            task.apply_fn, p2p.param_views(st, task), x_eval_t, y_eval_t, groups
        )
        return {k: v.cpu().numpy() for k, v in acc.items()}

    log = metrics_lib.RoundLog()
    for r in range(rounds):
        start = time.perf_counter()
        batches = batcher.round_batches_on(cfg.local_steps, device)
        after_local, after_cons, losses = round_fn(state, batches)
        _synchronize(device)
        seconds = time.perf_counter() - start
        state = after_cons
        acc_l, acc_c = eval_fn(after_local), eval_fn(after_cons)
        loss = float(losses.mean())
        log.record(
            local_acc=acc_l,
            consensus_acc=acc_c,
            drift=float(consensus_lib.pairwise_drift(after_local.params)),
            consensus_error=float(consensus_lib.consensus_error(after_cons.params)),
            train_loss=loss,
            seconds=seconds,
        )
        if on_round is not None:
            on_round(r, state)
        if verbose:
            print(
                f"round {r:3d} loss={loss:.4f} "
                f"acc(after local)={acc_l['all'].mean():.3f} "
                f"acc(after consensus)={acc_c['all'].mean():.3f} "
                f"({seconds:.4f} s)",
                flush=True,
            )
    if return_state:
        return log, state
    return log


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
        )

    return build


DIRECTED_SCHEDULES = ("static", "link_dropout", "one_way_matching")


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
}
# every pretraced schedule; adaptive is queue 1 item 13
SCHEDULE_CHOICES = ["static", "link_dropout", "random_matching", "peer_churn", "round_robin",
                    "one_way_matching"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment", default="noniid_affinity", choices=sorted(EXPERIMENTS))
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: the experiment's own (40-100)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda; cpu runs each kernel's plain PyTorch version")
    ap.add_argument("--topology", default="complete", help="graph of iid_k100")
    ap.add_argument("--local-steps", type=int, default=None,
                    help="T local SGD steps per round (default: the experiment's own, 10)")
    ap.add_argument("--algorithm", default="p2pl_affinity",
                    help="algorithm for timevarying_* and directed_k8 experiments")
    ap.add_argument("--schedule", default=None, choices=SCHEDULE_CHOICES,
                    help="communication-graph schedule for timevarying_* and directed_k8 "
                         "experiments (default: link_dropout for timevarying_*, static for "
                         "directed_k8, which takes static|link_dropout|one_way_matching)")
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
    ap.add_argument("--peer-axis", default="vmap", choices=["vmap", "pod"],
                    help="how the K peer axis executes: 'vmap' (stacked runtime) or 'pod' "
                         "(the hierarchical runtime; the port runs it on one slice, "
                         "--peers-per-device = K)")
    ap.add_argument("--peers-per-device", type=int, default=1,
                    help="with --peer-axis pod: peers per device; K runs the one-slice "
                         "hierarchical runtime, consensus over the degree-bounded sparse "
                         "schedule")
    ap.add_argument("--mix-mode", default="auto", choices=sorted(p2p.MIX_MODES),
                    help="hierarchical consensus form (only with --peers-per-device > 1): "
                         "'bridge' is the vmap runtime's mix (bit-identical, K <= 64), "
                         "'segment' the degree-bounded segment_mix kernel (allclose), "
                         "'auto' picks bridge iff K <= 64")
    args = ap.parse_args(argv)
    if not 0.0 < args.topk_frac <= 1.0:
        ap.error(f"--topk-frac must be in (0, 1], got {args.topk_frac}")

    try:
        exp = EXPERIMENTS[args.experiment](args)
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
    run_paper_experiment(exp, rounds=args.rounds, verbose=True, device=args.device,
                         peer_axis=args.peer_axis, peers_per_device=args.peers_per_device,
                         mix_mode=args.mix_mode)
    print(f"done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()

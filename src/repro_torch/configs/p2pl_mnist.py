"""The paper's own workload: 2NN MLP on (synthetic-)MNIST under P2PL (the
port's ``repro.configs.p2pl_mnist``: the paper's two experiments, the two
time-varying ones, the directed push-sum one, the sharded runtime's one,
the straggler one and the first real model, RWKV6 on sequential MNIST).

Sec. V hyperparameters: B=10, eta=0.01, mu=0.5 (IID) / 0 (non-IID),
T=60 gradient steps per round (IID, n_k=600) — one epoch per round,
data-size-weighted row-stochastic mixing, epsilon_k = 1.
"""
import dataclasses

from repro_torch.core.p2p import P2PConfig


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    name: str
    p2p: P2PConfig
    batch_size: int = 10
    samples_per_class: int = 50
    rounds: int = 40
    peer_classes: tuple = ()  # tuple of per-peer class tuples (non-IID)
    model: str = "mnist_mlp"  # one of core.task.task_names()

    def __post_init__(self):
        """The model is named twice (here, for the launcher and the data
        pipeline; in ``p2p``, for the feature table): a non-default on either
        side is taken by both, and two different non-defaults raise."""
        if self.model != self.p2p.model:
            if self.model != "mnist_mlp" and self.p2p.model != "mnist_mlp":
                raise ValueError(
                    f"experiment model {self.model!r} conflicts with "
                    f"p2p.model {self.p2p.model!r}"
                )
            chosen = self.model if self.model != "mnist_mlp" else self.p2p.model
            object.__setattr__(self, "model", chosen)
            object.__setattr__(self, "p2p", dataclasses.replace(self.p2p, model=chosen))


def iid_k100(*, topology: str = "complete") -> PaperExperiment:
    """Fig. 2: K=100, IID, 600 samples each, T=60, momentum 0.5."""
    return PaperExperiment(
        name=f"iid_k100_{topology}",
        p2p=P2PConfig(
            algorithm="p2pl",
            num_peers=100,
            local_steps=60,
            consensus_steps=1,
            lr=0.01,
            momentum=0.5,
            topology=topology,
            mixing="data_weighted",
        ),
        batch_size=10,
        rounds=100,
    )


def noniid_k2(*, algorithm: str = "local_dsgd", local_steps: int = 10) -> PaperExperiment:
    """Fig. 3cd/6: K=2, pathological non-IID (A: {0,1}, B: {7,8})."""
    return PaperExperiment(
        name=f"noniid_k2_{algorithm}_T{local_steps}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=2,
            local_steps=local_steps,
            consensus_steps=0 if algorithm == "isolated" else 1,
            lr=0.01,
            momentum=0.0,
            topology="disconnected" if algorithm == "isolated" else "complete",
            mixing="identity" if algorithm == "isolated" else "data_weighted",
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=60,
        peer_classes=((0, 1), (7, 8)),
    )


def timevarying_k2(
    *,
    schedule: str = "link_dropout",
    algorithm: str = "p2pl_affinity",
    local_steps: int = 10,
    schedule_rounds: int = 16,
    link_survival_prob: float = 0.7,
    peer_online_prob: float = 0.8,
    schedule_seed: int = 0,
    protocol: str = "gossip",
    round_robin_topologies: tuple = ("complete", "disconnected"),
    partner_rule: str = "loss_proximity",
    adaptive_eps: float = 0.1,
    adaptive_seed: int = 0,
) -> PaperExperiment:
    """Beyond-paper: the K=2 non-IID workload over a churning link.

    With ``link_dropout`` the single A-B edge vanishes on ~(1-q) of rounds;
    those rounds behave like isolated training.  eta_d=0.5 for the affinity
    variant (1.0 is marginally stable at K=2 full averaging).
    """
    return PaperExperiment(
        name=f"timevarying_k2_{schedule}_{algorithm}_T{local_steps}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=2,
            local_steps=local_steps,
            consensus_steps=1,
            lr=0.01,
            momentum=0.0,
            eta_d=0.5,
            topology="complete",
            mixing="data_weighted",
            schedule=schedule,
            schedule_rounds=schedule_rounds,
            link_survival_prob=link_survival_prob,
            peer_online_prob=peer_online_prob,
            schedule_seed=schedule_seed,
            protocol=protocol,
            round_robin_topologies=round_robin_topologies,
            partner_rule=partner_rule,
            adaptive_eps=adaptive_eps,
            adaptive_seed=adaptive_seed,
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=60,
        peer_classes=((0, 1), (7, 8)),
    )


def timevarying_k8(
    *,
    schedule: str = "random_matching",
    algorithm: str = "p2pl_affinity",
    local_steps: int = 10,
    schedule_rounds: int = 16,
    link_survival_prob: float = 0.7,
    peer_online_prob: float = 0.8,
    schedule_seed: int = 0,
    protocol: str = "gossip",
    round_robin_topologies: tuple = ("ring", "star"),
    partner_rule: str = "loss_proximity",
    adaptive_eps: float = 0.1,
    adaptive_seed: int = 0,
    compressor: str = "none",
    topk_frac: float = 0.01,
) -> PaperExperiment:
    """Beyond-paper: 8 peers, 2 classes each, gossiping over a time-varying
    graph (pairwise random matchings, dropped links, peer churn on a ring, a
    round robin of topologies, or ``schedule="adaptive"``: pairwise matchings
    selected on the device each round from the peers' own training losses),
    optionally over a compressed wire."""
    peer_classes = tuple(((2 * k) % 10, (2 * k + 1) % 10) for k in range(8))
    return PaperExperiment(
        name=f"timevarying_k8_{schedule}_{algorithm}_T{local_steps}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=8,
            local_steps=local_steps,
            consensus_steps=1,
            lr=0.01,
            momentum=0.0,
            eta_d=0.5,
            topology="ring",
            mixing="data_weighted",
            schedule=schedule,
            schedule_rounds=schedule_rounds,
            link_survival_prob=link_survival_prob,
            peer_online_prob=peer_online_prob,
            schedule_seed=schedule_seed,
            protocol=protocol,
            round_robin_topologies=round_robin_topologies,
            partner_rule=partner_rule,
            adaptive_eps=adaptive_eps,
            adaptive_seed=adaptive_seed,
            compressor=compressor,
            topk_frac=topk_frac,
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=60,
        peer_classes=peer_classes,
    )


def directed_k8(
    *,
    schedule: str = "static",
    protocol: str = "push_sum",
    algorithm: str = "p2pl_affinity",
    local_steps: int = 10,
    schedule_rounds: int = 16,
    link_survival_prob: float = 0.7,
    schedule_seed: int = 0,
    partner_rule: str = "loss_proximity",
    adaptive_eps: float = 0.1,
    adaptive_seed: int = 0,
) -> PaperExperiment:
    """Beyond-paper: 8 non-IID peers on a directed ring, each pushing forward
    only (one-way links).

    Row-stochastic gossip is biased here; the default ``push_sum`` carries a
    mass per peer whose ratio de-biases the estimates, so consensus lands on
    the data-weighted average.  Schedules: ``static`` (the directed ring),
    ``link_dropout`` (each one-way link drops on its own),
    ``one_way_matching`` (random sender -> receiver pairs each round) or
    ``adaptive`` (pairwise matchings chosen on the device from the losses,
    mixed column-stochastically).

    The shards are unequal on purpose (peers 0-3 hold a third class, 150
    samples feeding 100-sample peers): with equal sizes on a degree-regular
    directed ring the data-weighted row matrix is unbiased and push-sum
    would give gossip's numbers.
    """
    peer_classes = tuple(
        ((2 * k) % 10, (2 * k + 1) % 10, (2 * k + 2) % 10) if k < 4
        else ((2 * k) % 10, (2 * k + 1) % 10)
        for k in range(8)
    )
    return PaperExperiment(
        name=f"directed_k8_{schedule}_{protocol}_{algorithm}_T{local_steps}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=8,
            local_steps=local_steps,
            consensus_steps=1,
            lr=0.01,
            momentum=0.0,
            eta_d=0.5,
            topology="directed_ring",
            mixing="data_weighted",
            schedule=schedule,
            schedule_rounds=schedule_rounds,
            link_survival_prob=link_survival_prob,
            schedule_seed=schedule_seed,
            protocol=protocol,
            partner_rule=partner_rule,
            adaptive_eps=adaptive_eps,
            adaptive_seed=adaptive_seed,
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=60,
        peer_classes=peer_classes,
    )


def sharded_k8(
    *,
    schedule: str = "static",
    protocol: str = "gossip",
    algorithm: str = "p2pl_affinity",
    local_steps: int = 10,
    topology: str = "ring",
    schedule_rounds: int = 16,
    link_survival_prob: float = 0.7,
    schedule_seed: int = 0,
    round_robin_topologies: tuple = ("ring", "star"),
    partner_rule: str = "loss_proximity",
    adaptive_eps: float = 0.1,
    adaptive_seed: int = 0,
) -> PaperExperiment:
    """The sharded runtime's workload: 8 non-IID peers, one process each
    (``--peer-axis pod``).

    ``timevarying_k8``'s learning problem (2 classes per peer on a ring),
    parameterized over protocol and schedule so that each parity axis of the
    sharded runtime (gossip / push-sum x static / link dropout / round robin /
    one-way matching / adaptive) has a named entry point:

        python -m repro_torch.launch.train --experiment sharded_k8 --peer-axis pod
    """
    peer_classes = tuple(((2 * k) % 10, (2 * k + 1) % 10) for k in range(8))
    return PaperExperiment(
        name=f"sharded_k8_{schedule}_{protocol}_{algorithm}_T{local_steps}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=8,
            local_steps=local_steps,
            consensus_steps=1,
            lr=0.01,
            momentum=0.0,
            eta_d=0.5,
            topology=topology,
            mixing="data_weighted",
            schedule=schedule,
            schedule_rounds=schedule_rounds,
            link_survival_prob=link_survival_prob,
            schedule_seed=schedule_seed,
            protocol=protocol,
            round_robin_topologies=round_robin_topologies,
            partner_rule=partner_rule,
            adaptive_eps=adaptive_eps,
            adaptive_seed=adaptive_seed,
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=60,
        peer_classes=peer_classes,
    )


def straggler_k8(
    *,
    schedule: str = "static",
    protocol: str = "gossip",
    algorithm: str = "p2pl_affinity",
    local_steps: int = 8,
    steps_profile: str = "straggler",
    staleness_bound: int = 3,
    staleness_decay: float = 0.5,
    straggler_frac: float = 0.25,
    straggler_period: int = 4,
    eta_d: float = 0.25,
    topology: str = "ring",
    schedule_rounds: int = 16,
    round_robin_topologies: tuple = ("ring", "star"),
) -> PaperExperiment:
    """Beyond-paper: 8 non-IID peers with heterogeneous compute (stragglers).

    ``timevarying_k8``'s learning problem (2 classes per peer on a ring), but
    the last quarter of the fleet is 4x slower: under the ``straggler``
    profile those peers complete T/4 local steps a round and publish every
    4th round.  With ``staleness_bound=3`` their neighbors mix the last
    published snapshot (age-decayed, renormalised per the protocol) instead
    of waiting: the bounded-staleness round of ``core/p2p.py``.  eta_d is
    0.25, half the synchronous experiments' 0.5: snapshot delay eats the
    affinity feedback's gain margin (the reference diverges at 0.5).
    """
    peer_classes = tuple(((2 * k) % 10, (2 * k + 1) % 10) for k in range(8))
    return PaperExperiment(
        name=f"straggler_k8_{schedule}_{protocol}_{steps_profile}_b{staleness_bound}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=8,
            local_steps=local_steps,
            consensus_steps=1,
            lr=0.01,
            momentum=0.0,
            eta_d=eta_d,
            topology=topology,
            mixing="data_weighted",
            schedule=schedule,
            schedule_rounds=schedule_rounds,
            round_robin_topologies=round_robin_topologies,
            protocol=protocol,
            steps_profile=steps_profile,
            staleness_bound=staleness_bound,
            staleness_decay=staleness_decay,
            straggler_frac=straggler_frac,
            straggler_period=straggler_period,
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=60,
        peer_classes=peer_classes,
    )


def seqmnist_k8(
    *,
    schedule: str = "static",
    protocol: str = "gossip",
    algorithm: str = "p2pl",
    local_steps: int = 4,
    lr: float = 0.05,
    topology: str = "ring",
    rounds: int = 20,
    schedule_rounds: int = 16,
    round_robin_topologies: tuple = ("ring", "star"),
) -> PaperExperiment:
    """The first real-model workload: RWKV6 on sequential MNIST, 8 peers.

    The non-IID shape of ``timevarying_k8`` (2 classes per peer on a ring)
    with the ``rwkv6_seqmnist`` task: each image becomes a 196-token pixel
    stream and every peer trains the reduced RWKV6 of
    ``core.task.seqmnist_model_config`` (31 leaves, 100,234 parameters), so
    gossip and push-sum mix a real multi-layer parameter set.  T = 4 and
    lr = 0.05, the reference's: the recurrent trunk costs far more a step
    than the 2NN, and plain SGD on the max-norm-synced init moves the cross
    entropy at 0.05 where 0.01 is slow over 20 rounds.
    """
    peer_classes = tuple(((2 * k) % 10, (2 * k + 1) % 10) for k in range(8))
    return PaperExperiment(
        name=f"seqmnist_k8_{schedule}_{protocol}_{algorithm}_T{local_steps}",
        p2p=P2PConfig(
            algorithm=algorithm,
            num_peers=8,
            local_steps=local_steps,
            consensus_steps=1,
            lr=lr,
            momentum=0.0,
            topology=topology,
            mixing="data_weighted",
            schedule=schedule,
            schedule_rounds=schedule_rounds,
            round_robin_topologies=round_robin_topologies,
            protocol=protocol,
            model="rwkv6_seqmnist",
        ),
        batch_size=10,
        samples_per_class=50,
        rounds=rounds,
        peer_classes=peer_classes,
        model="rwkv6_seqmnist",
    )

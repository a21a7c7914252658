"""The paper's own workload: 2NN MLP on (synthetic-)MNIST under P2PL (the
port's ``repro.configs.p2pl_mnist``, the two experiments it runs).

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

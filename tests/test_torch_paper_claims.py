"""The paper's headline claim, re-run on the port: with the configuration of
tests/test_paper_claims.py::test_affinity_damps_oscillation_below_local_dsgd
(Fig. 6's 5-vs-5 class split, K=2, 12 rounds on mnist_small), P2PL with
Affinity damps the consensus sawtooth below local DSGD.  Runs the port's
trainer on the CPU through its plain PyTorch path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.p2pl_mnist import noniid_k2  # noqa: E402
from repro_torch.core import p2p  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
ROUNDS = 12


def _run(exp, data):
    return train.run_paper_experiment(exp, rounds=ROUNDS, data=data, seed=0, device="cpu")


def test_affinity_damps_oscillation_below_local_dsgd(mnist_small):
    def fig6_exp(algo, eta_d):
        exp = noniid_k2(algorithm=algo, local_steps=10)
        return dataclasses.replace(
            exp,
            peer_classes=((0, 1, 2, 3, 4), (5, 6, 7, 8, 9)),
            samples_per_class=100,
            p2p=dataclasses.replace(exp.p2p, eta_d=eta_d),
        )

    log_plain = _run(fig6_exp("local_dsgd", 0.0), mnist_small)
    log_aff = _run(fig6_exp("p2pl_affinity", 0.5), mnist_small)

    # device A's accuracy on its unseen classes, both phase boundaries
    def osc(log):
        a = np.stack(log.after_local["peer1_seen"])[:, 0]
        c = np.stack(log.after_consensus["peer1_seen"])[:, 0]
        return float(p2p.oscillation_amplitude(a, c).mean())

    assert osc(log_aff) < osc(log_plain), (
        f"affinity oscillation {osc(log_aff):.4f} must be strictly below "
        f"local DSGD {osc(log_plain):.4f}"
    )
    assert osc(log_plain) > 0.02


def test_run_records_both_phases_every_round(mnist_small):
    log = _run(noniid_k2(algorithm="p2pl_affinity", local_steps=10), mnist_small)
    assert len(log.after_consensus["all"]) == ROUNDS == len(log.seconds)
    assert all(np.isfinite(log.train_loss))
    assert set(log.after_local) == {"peer0_seen", "peer1_seen", "all"}


def test_cli_runs_on_cpu(capsys):
    train.main(["--experiment", "noniid_dsgd", "--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round   1" in out and "acc(after consensus)" in out

"""The paper's headline claim, re-run on the port: with the configuration of
tests/test_paper_claims.py::test_affinity_damps_oscillation_below_local_dsgd
(Fig. 6's 5-vs-5 class split, K=2, 12 rounds on mnist_small), P2PL with
Affinity damps the consensus sawtooth below local DSGD.  Also the reference's
time-varying claim test, and compressed gossip over a time-varying schedule
still pulling non-IID peers together, as tests/test_compression.py checks it
for the reference.  Runs the port's trainer on the CPU through its plain
PyTorch path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.p2pl_mnist import noniid_k2, timevarying_k2, timevarying_k8  # noqa: E402
from repro_torch.core import consensus  # noqa: E402
from repro_torch.core import p2p  # noqa: E402
from repro_torch.core import task as task_lib  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
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


def test_timevarying_run_completes_and_measures(mnist_small):
    """A link_dropout schedule runs end to end through run_paper_experiment
    and still produces the paper's instruments (as the reference's test)."""
    exp = timevarying_k2(schedule="link_dropout", algorithm="local_dsgd", local_steps=10,
                         schedule_rounds=8, link_survival_prob=0.6)
    log = _run(exp, mnist_small)
    assert len(log.after_consensus["all"]) == ROUNDS
    assert np.isfinite(log.train_loss).all()
    assert 0.0 <= log.final_accuracy("all") <= 1.0
    assert log.oscillation("peer1_seen").shape == (ROUNDS,)


@pytest.mark.parametrize("compressor,frac", [("topk", 0.5), ("qint8", 0.01)])
def test_compressed_consensus_error_contracts(compressor, frac, mnist_small):
    """Compressed gossip over timevarying_k8's ring/star round robin pulls
    spread-out peers together: with the local phase switched off (lr = 0),
    four rounds of four compressed steps at least halve the consensus error,
    and everything stays finite."""
    exp = timevarying_k8(schedule="round_robin", algorithm="local_dsgd",
                         compressor=compressor, topk_frac=frac)
    cfg = dataclasses.replace(exp.p2p, lr=0.0, consensus_steps=4)
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, mnist_small[0], mnist_small[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    # local_dsgd skips max-norm sync: the peers start apart, and the estimate
    # stack is warm-started on those spread values
    state = p2p.init_state(task, cfg, seed=2, data_sizes=sizes, device="cpu")
    assert torch.equal(state.compression, state.params)
    err0 = float(consensus.consensus_error(state.params))
    assert err0 > 0.0
    round_fn = p2p.make_round_fn(task, cfg, data_sizes=sizes, device="cpu")
    batcher = pipeline.PeerBatcher(parts, exp.batch_size, seed=0)
    for _ in range(4):
        _, state, losses = round_fn(state, batcher.round_batches_on(cfg.local_steps,
                                                                    torch.device("cpu")))
        assert torch.isfinite(losses).all() and torch.isfinite(state.params).all()
    assert not torch.equal(state.compression, state.params)  # the estimates lag
    assert float(consensus.consensus_error(state.params)) < 0.5 * err0


def test_compressed_cli_runs_on_cpu(capsys):
    train.main(["--experiment", "timevarying_k8", "--schedule", "round_robin",
                "--compressor", "qint8", "--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round   1" in out and "acc(after consensus)" in out

"""The port's scanned multi-round driver (``repro_torch.core.p2p.make_scan_driver``),
the counterpart of tests/test_scan_driver.py, on the CPU.

* Parity with the port's python driver: two chunks that cross the schedule
  period, ``torch.equal`` on every leaf of the final state and of the last
  after-local state, and on the (C, T) losses: gossip and push-sum over a
  static and a round-robin schedule, qint8 and top-k wires, the one-slice
  hierarchical runtime's bridge and segment modes, and a period R = 4 that
  the chunk C = 3 does not divide.  On the CPU the driver runs its round
  body eagerly over its static buffers; on the card each round is a replay
  of a captured CUDA graph, which ``chip_smoke.py`` holds to the python
  driver bit for bit.
* Donation: ``donate=False`` leaves the input state as it was;
  ``donate=True`` returns the buffers it was given.
* Against the reference's ``make_scan_driver`` (level 3): from the same
  exported parameters and the same batches, allclose at float32 atol 5e-5 /
  rtol 1e-4 after two chunks of rounds.
* ``run_paper_experiment(driver=..., eval_every=E)``: the reference's eval
  rounds and record count, the two port drivers' logs equal, the CLI's
  ``--driver`` / ``--eval-every``, and the reference's ``ValueError``.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.data import partition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
CPU = torch.device("cpu")
T = 2
CHUNK = 3


def _tv(schedule="static", **rep):
    exp = tconfigs.timevarying_k8(schedule=schedule, local_steps=T, schedule_rounds=4)
    return dataclasses.replace(exp, p2p=dataclasses.replace(exp.p2p, **rep))


CASES = {
    "gossip_static": (lambda: _tv("static"), {}),
    "gossip_round_robin": (lambda: _tv("round_robin"), {}),
    "push_sum_static": (lambda: _tv("static", protocol="push_sum"), {}),
    "push_sum_round_robin": (lambda: _tv("round_robin", protocol="push_sum"), {}),
    "qint8_round_robin": (lambda: _tv("round_robin", compressor="qint8"), {}),
    "topk_round_robin": (lambda: _tv("round_robin", compressor="topk", topk_frac=0.05), {}),
    # R = 4 does not divide C = 3: every chunk starts at another round of the period
    "link_dropout_r4": (lambda: _tv("link_dropout", momentum=0.5, eta_b=0.1), {}),
    "hier_bridge": (lambda: _tv("round_robin"), dict(peers_per_device=8, mix_mode="bridge")),
    "hier_segment": (lambda: _tv("link_dropout"),
                     dict(peers_per_device=8, mix_mode="segment")),
    "hier_segment_push_sum": (lambda: tconfigs.directed_k8(schedule="one_way_matching",
                                                           local_steps=T, schedule_rounds=4),
                              dict(peers_per_device=8, mix_mode="segment")),
}


def _setup(exp, data):
    cfg = exp.p2p
    task = ttask.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = partition.data_sizes(parts)
    return cfg, task, parts, sizes


def _python_rounds(exp, data, rounds, hier):
    cfg, task, parts, sizes = _setup(exp, data)
    state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    if hier:
        round_fn = tp2p.make_hier_round_fn(task, cfg, sizes, device="cpu", **hier)
    else:
        round_fn = tp2p.make_round_fn(task, cfg, sizes, device="cpu")
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    losses = []
    for _ in range(rounds):
        after_local, state, loss = round_fn(state, batcher.round_batches_on(cfg.local_steps, CPU))
        losses.append(loss)
    return after_local, state, torch.stack(losses)


def _scan_chunks(exp, data, chunks, hier, donate=True):
    cfg, task, parts, sizes = _setup(exp, data)
    state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
    drive = tp2p.make_scan_driver(task, cfg, sizes, device="cpu", donate=donate, **hier)
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    losses = []
    for c in range(chunks):
        after_local, state, loss = drive(state, batcher.chunk_batches_on(cfg.local_steps, CHUNK,
                                                                         CPU))
        assert loss.shape == (CHUNK, cfg.local_steps)
        assert state.round_idx == (c + 1) * CHUNK and after_local.round_idx == state.round_idx - 1
        losses.append(loss)
    return after_local, state, torch.cat(losses)


def _assert_states_equal(got, want, what):
    assert got.round_idx == want.round_idx, what
    got_leaves, want_leaves = tp2p.state_leaves(got), tp2p.state_leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert torch.equal(g, w), f"{what} leaf {i}: max |diff| {(g - w).abs().max():.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_driver_bit_identical_to_python_driver(case, mnist_small):
    """Two chunks of C = 3 rounds == 6 python-driver rounds, bit for bit on
    every leaf, the last after-local state and the losses included."""
    build, hier = CASES[case]
    exp = build()
    want_local, want, want_losses = _python_rounds(exp, mnist_small, 2 * CHUNK, hier)
    got_local, got, got_losses = _scan_chunks(exp, mnist_small, 2, hier)
    _assert_states_equal(got, want, "final state")
    _assert_states_equal(got_local, want_local, "after local")
    assert torch.equal(got_losses, want_losses)


def test_donation(mnist_small):
    """``donate=False`` leaves the input untouched and returns other buffers;
    ``donate=True`` consumes the input: its buffers are the returned state's."""
    exp = _tv("round_robin", compressor="qint8", protocol="push_sum")
    cfg, task, parts, sizes = _setup(exp, mnist_small)
    for donate in (False, True):
        state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
        before = [t.clone() for t in tp2p.state_leaves(state)]
        drive = tp2p.make_scan_driver(task, cfg, sizes, device="cpu", donate=donate)
        chunk = task.make_peer_batches(parts, exp.batch_size, seed=0).chunk_batches_on(
            cfg.local_steps, 2, CPU)
        _, final, _ = drive(state, chunk)
        same = [a is b for a, b in zip(tp2p.state_leaves(state), tp2p.state_leaves(final))]
        if donate:
            assert all(same)
        else:
            assert not any(same)
            for t, b in zip(tp2p.state_leaves(state), before):
                assert torch.equal(t, b)
        assert final.round_idx == 2 and not torch.equal(final.params, before[0])


def test_scan_driver_matches_reference_scan_driver(mnist_small):
    """Level 3: the reference's ``make_scan_driver`` and the port's, from the
    same exported parameters on the same batches (``round_batches(T * C)``
    reshaped to (C, T, ...)), two chunks of 2 rounds of ``noniid_k2``'s
    affinity algorithm at T = 10."""
    jcfg = jconfigs.noniid_k2(algorithm="p2pl_affinity", local_steps=10).p2p
    exp = tconfigs.noniid_k2(algorithm="p2pl_affinity", local_steps=10)
    tcfg = exp.p2p
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, [(0, 1), (7, 8)], samples_per_class=50)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(0)
    exported = jax.tree.map(
        np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, jcfg.num_peers)))
    task = ttask.get_task("mnist_mlp")
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jcfg, data_sizes=sizes)
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    jdrive = jp2p.make_scan_driver(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    tdrive = tp2p.make_scan_driver(task, tcfg, sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    tbatch = task.make_peer_batches(parts, 10, seed=0)
    chunk, t = 2, tcfg.local_steps
    for c in range(2):
        bx, by = jbatch.round_batches(t * chunk)
        tchunk = tbatch.chunk_batches_on(t, chunk, CPU)
        np.testing.assert_array_equal(tchunk.x_all[tchunk.idx].numpy(),
                                      bx.reshape(chunk, t, *bx.shape[1:]))
        jl, jstate, jloss = jdrive(jstate, (jnp.asarray(bx.reshape(chunk, t, *bx.shape[1:])),
                                            jnp.asarray(by.reshape(chunk, t, *by.shape[1:]))))
        tl, tstate, tloss = tdrive(tstate, tchunk)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        for tst, jst, what in ((tl, jl, "after local"), (tstate, jstate, "final")):
            assert tst.round_idx == int(jst.round_idx), what
            for field in ("params", "momentum", "d_bias", "b_bias"):
                got = tp2p.ParamLayout.of(task).views(getattr(tst, field))
                for layer in ("fc1", "fc2", "out"):
                    for leaf in ("w", "b"):
                        np.testing.assert_allclose(
                            got[f"{layer}.{leaf}"].numpy(),
                            np.asarray(getattr(jst, field)[layer][leaf]), **TOL,
                            err_msg=f"chunk {c} {what} {field} {layer}.{leaf}")


def _verbose_rounds(run) -> list[int]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        log = run()
    return [int(m) for m in re.findall(r"^round\s+(\d+) ", out.getvalue(), re.M)], log


ROUNDS, EVERY = 5, 2


@pytest.mark.parametrize("driver", ["scan", "python"])
def test_eval_cadence_matches_reference(driver, mnist_small):
    """Rounds 1, 3 and 4 of 5 at ``eval_every=2``: the rounds the reference
    evaluates (its python driver, whose cadence its scan driver shares), one
    record each, each period's seconds per round recorded."""
    jexp = jconfigs.noniid_k2(algorithm="p2pl_affinity", local_steps=2)
    texp = tconfigs.noniid_k2(algorithm="p2pl_affinity", local_steps=2)
    want, jlog = _verbose_rounds(lambda: jtrain.run_paper_experiment(
        jexp, rounds=ROUNDS, data=mnist_small, eval_every=EVERY, verbose=True,
        driver="python"))
    got, tlog = _verbose_rounds(lambda: train.run_paper_experiment(
        texp, rounds=ROUNDS, data=mnist_small, eval_every=EVERY, verbose=True, driver=driver,
        device="cpu"))
    assert want == got == [1, 3, 4]
    assert len(tlog.train_loss) == len(jlog.train_loss) == len(tlog.seconds) == 3
    assert len(tlog.series("all")) == len(jlog.series("all"))
    assert (tlog.capture_seconds > 0) == (driver == "scan")


@pytest.mark.parametrize("exp,kw", [
    (lambda: tconfigs.directed_k8(schedule="link_dropout", local_steps=2, schedule_rounds=4),
     {}),
    (lambda: tconfigs.timevarying_k8(schedule="round_robin", compressor="qint8", local_steps=2),
     {}),
    (lambda: tconfigs.timevarying_k8(schedule="round_robin", local_steps=2),
     dict(peer_axis="pod", peers_per_device=8, mix_mode="segment")),
])
def test_both_drivers_log_the_same(exp, kw, mnist_small):
    """``run_paper_experiment``'s two drivers: every logged number equal,
    the final state equal, ``on_round`` called at the same rounds."""
    logs, states, seen = {}, {}, {}
    for driver in ("scan", "python"):
        seen[driver] = []
        logs[driver], states[driver] = train.run_paper_experiment(
            exp(), rounds=ROUNDS, data=mnist_small, eval_every=EVERY, driver=driver,
            device="cpu", return_state=True, on_round=lambda r, st, d=driver: seen[d].append(r),
            **kw)
    scan, python = logs["scan"], logs["python"]
    for group in python.after_local:
        assert np.array_equal(scan.series(group, "local"), python.series(group, "local"))
        assert np.array_equal(scan.series(group), python.series(group))
    for field in ("drift", "consensus_error", "train_loss"):
        assert getattr(scan, field) == getattr(python, field), field
    _assert_states_equal(states["scan"], states["python"], "final state")
    assert seen["scan"] == seen["python"] == [1, 3, 4]


@pytest.mark.parametrize("driver", ["scan", "python"])
def test_cli_driver_and_eval_every(driver, monkeypatch, mnist_small, capsys):
    real = train.run_paper_experiment
    calls = []

    def run(exp, **kw):
        calls.append(kw)
        return real(exp, **{**kw, "data": mnist_small})

    monkeypatch.setattr(train, "run_paper_experiment", run)
    train.main(["--device", "cpu", "--experiment", "noniid_affinity", "--local-steps", "2",
                "--rounds", "3", "--driver", driver, "--eval-every", "2"])
    out = capsys.readouterr().out
    assert calls[0]["driver"] == driver and calls[0]["eval_every"] == 2
    assert re.findall(r"^round\s+(\d+) ", out, re.M) == ["1", "2"]
    assert ("warm-up round and capture" in out) == (driver == "scan")
    assert "done in" in out


def test_cli_defaults_match_reference():
    """``--driver scan`` and ``--eval-every 1`` by default, as in the reference."""
    defaults = {}
    for name in ("driver", "eval_every"):
        defaults[name] = train.run_paper_experiment.__kwdefaults__[name]
        assert defaults[name] == jtrain.run_paper_experiment.__kwdefaults__[name]
    assert defaults == {"driver": "scan", "eval_every": 1}
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--eval-every", "0"])


def test_bad_driver_raises_reference_error(mnist_small):
    exp = tconfigs.noniid_k2(algorithm="p2pl_affinity")
    with pytest.raises(ValueError) as want:
        jtrain.run_paper_experiment(jconfigs.noniid_k2(algorithm="p2pl_affinity"), rounds=1,
                                    data=mnist_small, driver="loop")
    with pytest.raises(ValueError) as got:
        train.run_paper_experiment(exp, rounds=1, data=mnist_small, driver="loop", device="cpu")
    assert str(got.value) == str(want.value) == "driver must be 'scan' or 'python', got 'loop'"

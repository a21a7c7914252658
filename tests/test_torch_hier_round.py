"""Port parity, the one-slice hierarchical runtime: all K peers on one device
(``peers_per_device = K``), consensus over the degree-bounded sparse
schedule, against the reference's ``make_sharded_round_fn`` on a one-device
mesh.  The 2NN, K = 8 on a ring, three schedules, 3 rounds from exported
parameters, with both affinity biases, two consensus steps and momentum:

- "segment" is allclose to the reference's segment round at rtol / atol
  1e-5 (slot-ordered sums, as the reference's own hierarchical tests hold
  its segment mode to its vmap runtime);
- "bridge" is bitwise the port's own vmap round, and allclose to the
  reference's bridge round at tests/test_kernels.py's float32 tolerance;
- "auto" picks bridge at K <= 64 and segment above;
- push-sum (``directed_k8`` reduced, static and directed link dropout) runs
  both modes the same way, the mass held to the reference's and to sum K:
  "segment" through the ``segment_mix`` kernel's mass mode.

At K = 4096 one segment consensus phase creates no tensor with two
dimensions equal to K (the counterpart of the reference's ``_no_kk_avals``).
The layout, mix-mode and feature errors read as the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import task as jtask  # noqa: E402
from repro.data import partition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import features as tfeatures  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant, ops, segment  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
K = 8
ROUNDS = 3
SEGMENT_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=5e-5, rtol=1e-4)
SCHEDULES = ("static", "link_dropout", "round_robin")
FIELDS = ("params", "momentum", "d_bias", "b_bias")


def _configs(schedule, push_sum=False):
    """timevarying_k8 (gossip) or directed_k8 (push-sum), reduced, with both
    affinity biases, two consensus steps and momentum."""
    kw = dict(schedule=schedule, local_steps=2, schedule_rounds=4)
    rep = dict(eta_b=0.1, consensus_steps=2, momentum=0.3)
    jexp, texp = ((jconfigs.directed_k8(**kw), tconfigs.directed_k8(**kw)) if push_sum
                  else (jconfigs.timevarying_k8(**kw), tconfigs.timevarying_k8(**kw)))
    return (dataclasses.replace(jexp.p2p, **rep), dataclasses.replace(texp.p2p, **rep),
            list(jexp.peer_classes))


def _leaves(tree):
    return {f"{layer}.{leaf}": np.asarray(tree[layer][leaf])
            for layer in ("fc1", "fc2", "out") for leaf in ("w", "b")}


def _assert_close(tstate, jstate, what, tol):
    layout = tp2p.layout_of("mnist_mlp")
    for field in FIELDS:
        got = layout.views(getattr(tstate, field))
        for name, want in _leaves(getattr(jstate, field)).items():
            np.testing.assert_allclose(got[name].numpy(), want, **tol,
                                       err_msg=f"{what} {field} {name}")
    assert tstate.round_idx == int(jstate.round_idx)
    if jstate.protocol != ():
        mass = tstate.protocol.mass
        np.testing.assert_allclose(mass.numpy(), np.asarray(jstate.protocol.mass), **tol,
                                   err_msg=f"{what} mass")
        np.testing.assert_allclose(float(mass.sum()), K, rtol=1e-5)
        assert bool((mass > 0).all())


def _start(schedule, mnist_small, push_sum=False):
    jcfg, tcfg, classes = _configs(schedule, push_sum)
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, classes, samples_per_class=50)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(0)
    exported = jax.tree.map(np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, K)))
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jcfg, data_sizes=sizes)
    task = ttask.get_task("mnist_mlp")
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    return jcfg, tcfg, task, parts, sizes, jstate, tstate


def _one_device_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("pod",))


def _run(schedule, mix_mode, mnist_small, push_sum=False):
    """3 rounds of the port's and the reference's one-slice runtimes, and of
    the port's vmap runtime, on the same batches; yields each round's
    (port hier, reference hier, port vmap) (after_local, after_consensus)."""
    jcfg, tcfg, task, parts, sizes, jstate, tstate = _start(schedule, mnist_small, push_sum)
    mesh = _one_device_mesh()
    jround = jp2p.make_sharded_round_fn(jmlp.loss_2nn, jcfg, mesh, data_sizes=sizes,
                                        peers_per_device=K, mix_mode=mix_mode)
    tround = tp2p.make_hier_round_fn(task, tcfg, sizes, peers_per_device=K, mix_mode=mix_mode,
                                     device="cpu")
    vround = tp2p.make_round_fn(task, tcfg, sizes, device="cpu")
    jstate = jspecs.shard_peer_tree(jstate, mesh)
    vstate = tstate
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    tbatch = tpipeline.PeerBatcher(parts, 10, seed=0)
    for r in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        batches = tbatch.round_batches_on(tcfg.local_steps, torch.device("cpu"))
        jl, jstate, _ = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tstate, _ = tround(tstate, batches)
        vl, vstate, _ = vround(vstate, batches)
        yield r, (tl, tstate), (jl, jstate), (vl, vstate)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_segment_round_matches_reference(schedule, mnist_small):
    for r, (tl, tc), (jl, jc), _ in _run(schedule, "segment", mnist_small):
        _assert_close(tl, jl, f"{schedule} round {r} after local", SEGMENT_TOL)
        _assert_close(tc, jc, f"{schedule} round {r} after consensus", SEGMENT_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bridge_round_is_the_vmap_round_bit_for_bit(schedule, mnist_small):
    for r, (tl, tc), (jl, jc), (vl, vc) in _run(schedule, "bridge", mnist_small):
        for hier, vmap in ((tl, vl), (tc, vc)):
            for field in FIELDS:
                assert torch.equal(getattr(hier, field), getattr(vmap, field)), (r, field)
        _assert_close(tc, jc, f"{schedule} round {r} after consensus", TOL)


PUSH_SUM_SCHEDULES = ("static", "link_dropout")


@pytest.mark.parametrize("schedule", PUSH_SUM_SCHEDULES)
def test_push_sum_segment_round_matches_reference(schedule, mnist_small):
    for r, (tl, tc), (jl, jc), _ in _run(schedule, "segment", mnist_small, push_sum=True):
        _assert_close(tl, jl, f"push-sum {schedule} round {r} after local", SEGMENT_TOL)
        _assert_close(tc, jc, f"push-sum {schedule} round {r} after consensus", SEGMENT_TOL)


@pytest.mark.parametrize("schedule", PUSH_SUM_SCHEDULES)
def test_push_sum_bridge_round_is_the_vmap_round_bit_for_bit(schedule, mnist_small):
    for r, (tl, tc), (jl, jc), (vl, vc) in _run(schedule, "bridge", mnist_small, push_sum=True):
        for hier, vmap in ((tl, vl), (tc, vc)):
            for field in FIELDS:
                assert torch.equal(getattr(hier, field), getattr(vmap, field)), (r, field)
            assert torch.equal(hier.protocol.mass, vmap.protocol.mass), r
        _assert_close(tc, jc, f"push-sum {schedule} round {r} after consensus", TOL)


def test_push_sum_segment_mode_calls_the_mass_mode(monkeypatch, mnist_small):
    """The push-sum segment runtime mixes through
    ``segment_mix_push_sum_schedule``, once per consensus step."""
    calls = []
    real = segment.segment_mix_push_sum_schedule

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(segment, "segment_mix_push_sum_schedule", spy)
    _, tcfg, task, parts, sizes, _, state = _start("static", mnist_small, push_sum=True)
    batches = tpipeline.PeerBatcher(parts, 10, seed=0).round_batches_on(
        tcfg.local_steps, torch.device("cpu"))
    tp2p.make_hier_round_fn(task, tcfg, sizes, peers_per_device=K, mix_mode="segment",
                            device="cpu")(state, batches)
    assert len(calls) == tcfg.consensus_steps


def test_auto_mode_picks_bridge_up_to_64_peers(monkeypatch, mnist_small):
    assert [tp2p.resolve_mix_mode("auto", k) for k in (8, 64, 65, 4096)] == [
        "bridge", "bridge", "segment", "segment"]
    assert tp2p.MIX_MODES == jp2p.MIX_MODES
    assert tp2p._BRIDGE_MAX_PEERS == jp2p._BRIDGE_MAX_PEERS == 64
    calls = []

    def spy(module, name):
        real = getattr(module, name)

        def call(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, call)

    spy(ops, "consensus_mix_stacked")
    spy(segment, "segment_mix_schedule")
    _, tcfg, task, parts, sizes, _, state = _start("static", mnist_small)
    batches = tpipeline.PeerBatcher(parts, 10, seed=0).round_batches_on(
        tcfg.local_steps, torch.device("cpu"))
    for mode, want in (("auto", "consensus_mix_stacked"), ("bridge", "consensus_mix_stacked"),
                       ("segment", "segment_mix_schedule")):
        calls.clear()
        tp2p.make_hier_round_fn(task, tcfg, sizes, peers_per_device=K, mix_mode=mode,
                                device="cpu")(state, batches)
        assert calls == [want] * tcfg.consensus_steps, mode


class _ShapeRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


def test_large_k_segment_phase_builds_no_kk_tensor():
    bigk = 4096
    cfg = tp2p.P2PConfig(algorithm="p2pl_affinity", num_peers=bigk, local_steps=1,
                         eta_d=0.5, eta_b=0.1, topology="ring")
    ops_s = tp2p.schedule_operands(cfg, device="cpu")
    rng = np.random.default_rng(0)
    flat = torch.as_tensor(rng.normal(size=(bigk, 8)).astype(np.float32))
    state = tp2p.P2PState(flat, torch.zeros_like(flat), torch.zeros_like(flat),
                          flat / 2, round_idx=0)
    with _ShapeRecorder() as rec:
        after = tp2p.consensus_phase_hier(state, cfg, ops_s, mix_mode="segment")
    assert rec.shapes, "the dispatch mode saw no operation"
    bad = [(op, s) for op, s in rec.shapes if sum(d == bigk for d in s) >= 2]
    assert bad == []
    assert after.round_idx == 1 and bool(torch.isfinite(after.params).all())
    assert bool((after.d_bias != 0).any())


def test_compression_x_hierarchical_message_equals_reference():
    jcfg = jconfigs.timevarying_k8(compressor="qint8").p2p
    tcfg = tconfigs.timevarying_k8(compressor="qint8").p2p
    with pytest.raises(ValueError) as want:
        jfeatures.check_config(jcfg, peers_per_device=K)
    with pytest.raises(ValueError) as got:
        tfeatures.check_config(tcfg, peers_per_device=K)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got_rt:
        tp2p.make_hier_round_fn(ttask.get_task("mnist_mlp"), tcfg, peers_per_device=K,
                                device="cpu")
    assert str(got_rt.value) == str(want.value)
    tfeatures.check_config(tcfg)  # one peer per device: compression runs


def test_layout_and_mix_mode_errors_read_as_the_reference():
    task = ttask.get_task("mnist_mlp")
    _, tcfg, _ = _configs("static")
    with pytest.raises(ValueError) as want:
        jspecs.hierarchical_layout(K, _one_device_mesh(), peers_per_device=1)
    with pytest.raises(ValueError) as got:
        tp2p.make_hier_round_fn(task, tcfg, peers_per_device=1, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jp2p.make_sharded_round_fn(jmlp.loss_2nn, _configs("static")[0], _one_device_mesh(),
                                   peers_per_device=K, mix_mode="dense")
    with pytest.raises(ValueError) as got:
        tp2p.make_hier_round_fn(task, tcfg, peers_per_device=K, mix_mode="dense", device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="does not divide"):
        tp2p.make_hier_round_fn(task, tcfg, peers_per_device=3, device="cpu")
    # several slices run a process a slice: a round without a group points to it
    with pytest.raises(ValueError, match="needs a group"):
        tp2p.make_hier_round_fn(task, tcfg, peers_per_device=4, device="cpu")


@pytest.mark.parametrize("kw,err", [
    (dict(peer_axis="mesh"), ValueError),
    (dict(peers_per_device=0), ValueError),
    (dict(peers_per_device=8), ValueError),  # peer_axis "vmap"
    (dict(peer_axis="pod", peers_per_device=3), ValueError),
    (dict(peer_axis="pod", peers_per_device=4, mix_mode="dense"), ValueError),
])
def test_run_paper_experiment_rejects_other_layouts(kw, err, mnist_small):
    with pytest.raises(err):
        train.run_paper_experiment(tconfigs.timevarying_k8(), rounds=1, data=mnist_small,
                                   device="cpu", **kw)


def test_run_paper_experiment_several_slices_runs(mnist_small):
    """``peer_axis="pod"`` with 4 peers a slice: the hierarchical runtime over
    two processes (gloo ranks on the CPU), segment mode, the accuracies
    allclose to the vmap run's (slot-ordered sums)."""
    exp = tconfigs.timevarying_k8(local_steps=1)
    log_p = train.run_paper_experiment(exp, rounds=1, data=mnist_small, device="cpu",
                                       peer_axis="pod", peers_per_device=4, mix_mode="segment")
    log_v = train.run_paper_experiment(exp, rounds=1, data=mnist_small, device="cpu")
    assert np.isfinite(log_p.train_loss).all() and len(log_p.ranks) == K // 4
    for group in log_v.after_consensus:
        np.testing.assert_allclose(np.stack(log_p.after_consensus[group]),
                                   np.stack(log_v.after_consensus[group]), atol=1e-3)


def test_run_paper_experiment_one_peer_per_device_runs(mnist_small):
    """``peer_axis="pod"`` with one peer per device: the sharded runtime, one
    process per peer (gloo ranks on the CPU), the vmap run's accuracies."""
    exp = tconfigs.timevarying_k8(local_steps=1)
    log_p = train.run_paper_experiment(exp, rounds=1, data=mnist_small, device="cpu",
                                       peer_axis="pod")
    log_v = train.run_paper_experiment(exp, rounds=1, data=mnist_small, device="cpu")
    assert np.isfinite(log_p.train_loss).all() and len(log_p.ranks) == K
    for group in log_v.after_consensus:
        assert np.array_equal(np.stack(log_p.after_consensus[group]),
                              np.stack(log_v.after_consensus[group]))


def test_one_slice_run_on_cpu_launches_no_kernel(mnist_small):
    for counter in (ops.launches, dequant.launches, segment.launches):
        counter.reset()
    log = train.run_paper_experiment(tconfigs.timevarying_k8(), rounds=2, data=mnist_small,
                                     device="cpu", peer_axis="pod", peers_per_device=K,
                                     mix_mode="segment")
    assert np.isfinite(log.train_loss).all() and len(log.train_loss) == 2
    assert (ops.launches.count, dequant.launches.count, segment.launches.count) == (0, 0, 0)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, mnist_small):
    exp = tconfigs.timevarying_k8()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_paper_experiment(exp, rounds=1, data=mnist_small, peer_axis="pod",
                                   peers_per_device=K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp2p.make_hier_round_fn(ttask.get_task("mnist_mlp"), exp.p2p, peers_per_device=K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--experiment", "timevarying_k8", "--peer-axis", "pod",
                    "--peers-per-device", "8", "--rounds", "1"])


@pytest.mark.parametrize("argv,msg", [
    (["--peers-per-device", "0"], "--peers-per-device must be >= 1"),
    (["--peers-per-device", "8"], "needs --peer-axis pod"),
    (["--peer-axis", "pod", "--peers-per-device", "3"], "does not divide"),
    (["--peer-axis", "pod", "--peers-per-device", "8", "--compressor", "topk"],
     "is not supported with the hierarchical runtime"),
    (["--mix-mode", "dense"], "invalid choice"),
])
def test_cli_rejects_bad_layouts(argv, msg, capsys):
    with pytest.raises(SystemExit) as ex:
        train.main(["--experiment", "timevarying_k8", *argv, "--device", "cpu"])
    assert ex.value.code == 2
    assert msg in capsys.readouterr().err

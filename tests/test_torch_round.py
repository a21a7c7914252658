"""Port parity, the round: started from the same exported parameters and fed
the same ``PeerBatcher`` batches, the port's rounds are allclose to
``repro.core.p2p.make_round_fn`` after the local phase and after consensus,
for every algorithm of the family at ``noniid_k2`` shapes, and uncompressed
over every undirected time-varying schedule at ``timevarying_k8`` shapes.

Tolerance: float32 atol 5e-5 / rtol 1e-4 (tests/test_kernels.py's float32
tolerance).  TF32 is off; the packages differ only in summation order (BLAS
vs XLA dots, slot loop vs HIGHEST einsum), which after 3 rounds of 10 SGD
steps leaves ~1e-7 absolute differences.  Per-peer accuracies agree within
one test sample (1 / N_eval).

Compressed rounds cannot run free at that tolerance: a ~1e-7 difference in
``x - x̂`` flips ``round(diff / scale)`` by one on a fraction of the
coordinates, or moves a top-k boundary, each by one quantization step, far
above 5e-5.  So they are held teacher-forced: each round both packages run
the local phase from the reference's state and the consensus phase from the
reference's post-local state.  A free-running compressed run is compared
loosely (mean loss within 1e-3 relative).
"""
import dataclasses

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
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
ROUNDS = 3


def test_config_fields_match_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(jp2p.P2PConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tp2p.P2PConfig)]
    assert got == want
    assert tp2p.ALGORITHMS == jp2p.ALGORITHMS


@pytest.mark.parametrize("field,value", [
    ("algorithm", "sgd"), ("protocol", "flood"), ("schedule", "weekly"),
    ("compressor", "zip"), ("model", "resnet"), ("topology", "mesh3d"),
])
def test_unknown_config_values_raise_value_error(field, value):
    with pytest.raises(ValueError):
        tp2p.P2PConfig(**{field: value})


def _configs(algorithm):
    t = 1 if algorithm == "dsgd" else 10
    return (jconfigs.noniid_k2(algorithm=algorithm, local_steps=t).p2p,
            tconfigs.noniid_k2(algorithm=algorithm, local_steps=t).p2p)


CASES = {algo: (lambda a=algo: _configs(a)) for algo in jp2p.ALGORITHMS}
# both affinity biases, two consensus steps per round, and momentum
CASES["p2pl_affinity_b_s2"] = lambda: tuple(
    dataclasses.replace(c, eta_b=0.1, consensus_steps=2, momentum=0.5, eta_d=0.5)
    for c in _configs("p2pl_affinity")
)
# no mixing weight on the edge, affinity weight kept: d still moves (the
# port once built its operands from W's pattern and dropped beta here)
ZERO_MIXING = {
    "p2pl_affinity_identity": dict(mixing="identity"),
    "p2pl_affinity_eps0": dict(consensus_step_size=0.0),
}
for _name, _rep in ZERO_MIXING.items():
    CASES[_name] = lambda rep=_rep: tuple(
        dataclasses.replace(c, **rep) for c in _configs("p2pl_affinity"))


def _leaves(tree):
    return {f"{layer}.{leaf}": np.asarray(tree[layer][leaf])
            for layer in ("fc1", "fc2", "out") for leaf in ("w", "b")}


def _assert_state_close(tstate, jstate, task, what):
    layout = tp2p.ParamLayout.of(task)
    fields = ["params", "momentum", "d_bias", "b_bias"]
    assert (tstate.compression == ()) == (jstate.compression == ())
    if jstate.compression != ():
        fields.append("compression")
    for field in fields:
        got = layout.views(getattr(tstate, field))
        want = _leaves(getattr(jstate, field))
        for name in want:
            np.testing.assert_allclose(
                got[name].numpy(), want[name], **TOL, err_msg=f"{what} {field} {name}"
            )
    assert tstate.round_idx == int(jstate.round_idx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_parity(case, mnist_small):
    jcfg, tcfg = CASES[case]()
    x, y, x_te, y_te = mnist_small
    parts = partition.pathological_partition(x, y, [(0, 1), (7, 8)], samples_per_class=50)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(0)
    exported = jax.tree.map(
        np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, jcfg.num_peers))
    )
    task = ttask.get_task("mnist_mlp")
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jcfg, data_sizes=sizes)
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    _assert_state_close(tstate, jstate, task, "init")
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    tround = tp2p.make_round_fn(task, tcfg, data_sizes=sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    tbatch = tpipeline.PeerBatcher(parts, 10, seed=0)

    groups = {"peer0_seen": np.array([0, 1]), "peer1_seen": np.array([7, 8]),
              "all": np.array([0, 1, 7, 8])}
    sel = np.isin(y_te, [0, 1, 7, 8])
    x_eval, y_eval = x_te[sel], y_te[sel]
    for r in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        tx, ty = tbatch.round_batches_on(tcfg.local_steps, torch.device("cpu"))
        np.testing.assert_array_equal(tx.numpy(), bx)
        jl, jc, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tc, tloss = tround(tstate, (tx, ty))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        _assert_state_close(tl, jl, task, f"round {r} after local")
        _assert_state_close(tc, jc, task, f"round {r} after consensus")
        for tst, jst in ((tl, jl), (tc, jc)):
            want = jp2p.stratified_accuracy(jmlp.apply_2nn, jst.params, jnp.asarray(x_eval),
                                            jnp.asarray(y_eval), groups)
            got = tp2p.stratified_accuracy(task.apply_fn, tp2p.param_views(tst, task),
                                           torch.as_tensor(x_eval),
                                           torch.as_tensor(y_eval, dtype=torch.int64), groups)
            for name in groups:
                np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                           atol=1.0 / len(y_eval) + 1e-7, err_msg=name)
        jstate, tstate = jc, tc


@pytest.mark.parametrize("case", sorted(ZERO_MIXING))
def test_affinity_d_kept_where_mixing_weight_is_zero(case, mnist_small):
    """W = I, Beta = the affinity matrix: consensus leaves the parameters as
    they are and sets every peer's d = (sum_j beta_kj x_j - x_k) / T, nonzero
    wherever beta is, as the reference does (its round is compared with this
    one's in ``test_round_parity``)."""
    _, tcfg = CASES[case]()
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, [(0, 1), (7, 8)], samples_per_class=50)
    sizes = partition.data_sizes(parts)
    task = ttask.get_task("mnist_mlp")
    state = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu", seed=1)
    batches = tpipeline.PeerBatcher(parts, 10, seed=0).round_batches_on(
        tcfg.local_steps, torch.device("cpu"))
    after_local, after_cons, _ = tp2p.make_round_fn(task, tcfg, sizes, device="cpu")(
        state, batches)
    assert torch.equal(after_cons.params, after_local.params)
    x = after_local.params
    want = (x.flip(0) - x) / tcfg.local_steps  # K = 2: each peer's only neighbor
    torch.testing.assert_close(after_cons.d_bias, want, **TOL)
    layout = tp2p.ParamLayout.of(task)
    assert bool((after_cons.d_bias[:, :layout.size].abs().sum(dim=1) > 0).all())


def test_max_norm_init_matches_reference():
    cfg_j = jconfigs.iid_k100().p2p
    jcfg = dataclasses.replace(cfg_j, num_peers=6)
    tcfg = dataclasses.replace(tconfigs.iid_k100().p2p, num_peers=6)
    key = jax.random.PRNGKey(3)
    exported = jax.tree.map(np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, 6)))
    jstate = jp2p.init_state(key, jmlp.init_2nn, jcfg)
    task = ttask.get_task("mnist_mlp")
    tstate = tp2p.init_state(task, tcfg, device="cpu",
                             init_params=interop.params_from_jax(exported))
    got = tp2p.param_views(tstate, task)
    for name, want in _leaves(jstate.params).items():
        np.testing.assert_array_equal(got[name].numpy(), want)
    layout = tp2p.ParamLayout.of(task)
    assert (layout.size, layout.row) == (199_210, 199_212)
    assert torch.all(tstate.params[:, layout.size:] == 0)


def test_isolated_round_skips_consensus():
    _, tcfg = _configs("isolated")
    task = ttask.get_task("mnist_mlp")
    state = tp2p.init_state(task, tcfg, device="cpu")
    after = tp2p.consensus_phase(state, tcfg, ops=None)
    assert after.round_idx == 1 and after.params is state.params


# -- time-varying schedules and compressed wires ------------------------------


def _timevarying_case(schedule, compressor="none", local_steps=2):
    kw = dict(schedule=schedule, local_steps=local_steps, schedule_rounds=4)
    rep = dict(compressor=compressor, topk_frac=0.05)
    return (dataclasses.replace(jconfigs.timevarying_k8(**kw).p2p, **rep),
            dataclasses.replace(tconfigs.timevarying_k8(**kw).p2p, **rep),
            [(2 * k % 10, 2 * k % 10 + 1) for k in range(8)])


def _noniid_case(compressor):
    jcfg, tcfg = _configs("p2pl_affinity")
    rep = dict(compressor=compressor, topk_frac=0.05)
    return (dataclasses.replace(jcfg, **rep), dataclasses.replace(tcfg, **rep),
            [(0, 1), (7, 8)])


def _start(jcfg, tcfg, classes, mnist_small, seed=0):
    x, y, _, _ = mnist_small
    parts = partition.pathological_partition(x, y, classes, samples_per_class=50)
    sizes = partition.data_sizes(parts)
    key = jax.random.PRNGKey(seed)
    exported = jax.tree.map(
        np.asarray, jax.vmap(jmlp.init_2nn)(jax.random.split(key, jcfg.num_peers))
    )
    task = ttask.get_task("mnist_mlp")
    jstate = jp2p.init_state(key, jtask.get_task("mnist_mlp"), jcfg, data_sizes=sizes)
    tstate = tp2p.init_state(task, tcfg, data_sizes=sizes, device="cpu",
                             init_params=interop.params_from_jax(exported))
    _assert_state_close(tstate, jstate, task, "init")
    return task, parts, sizes, jstate, tstate


@pytest.mark.parametrize("schedule", ["static", "link_dropout", "random_matching",
                                      "peer_churn", "round_robin"])
def test_uncompressed_schedule_round_parity(schedule, mnist_small):
    """Free-running rounds over every undirected schedule (T cut to 2)."""
    jcfg, tcfg, classes = _timevarying_case(schedule)
    task, parts, sizes, jstate, tstate = _start(jcfg, tcfg, classes, mnist_small)
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    tround = tp2p.make_round_fn(task, tcfg, data_sizes=sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    tbatch = tpipeline.PeerBatcher(parts, 10, seed=0)
    for r in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        tx, ty = tbatch.round_batches_on(tcfg.local_steps, torch.device("cpu"))
        jl, jc, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tc, tloss = tround(tstate, (tx, ty))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        _assert_state_close(tl, jl, task, f"{schedule} round {r} after local")
        _assert_state_close(tc, jc, task, f"{schedule} round {r} after consensus")
        jstate, tstate = jc, tc


TEACHER_FORCED = [(case, compressor) for case in ("noniid_k2", "timevarying_k8")
                  for compressor in ("qint8", "topk")]


@pytest.mark.parametrize("case,compressor", TEACHER_FORCED)
def test_compressed_round_parity_teacher_forced(case, compressor, mnist_small):
    """Each round: the port's local phase from the reference's state, its
    consensus phase from the reference's post-local state (see the module
    docstring); both allclose to the reference's round."""
    if case == "noniid_k2":
        jcfg, tcfg, classes = _noniid_case(compressor)
    else:
        jcfg, tcfg, classes = _timevarying_case("round_robin", compressor)
    task, parts, sizes, jstate, _ = _start(jcfg, tcfg, classes, mnist_small)
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    ops = tp2p.round_operands(tcfg, sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    moved = False
    for r in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        jl, jc, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tl, tloss = tp2p.local_phase(interop.state_from_jax(jax.tree.map(np.asarray, jstate),
                                                            task),
                                     task, (torch.as_tensor(bx), torch.as_tensor(by)), tcfg)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        _assert_state_close(tl, jl, task, f"{case} {compressor} round {r} after local")
        tc = tp2p.consensus_phase(interop.state_from_jax(jax.tree.map(np.asarray, jl), task),
                                  tcfg, ops[r % len(ops)])
        _assert_state_close(tc, jc, task, f"{case} {compressor} round {r} after consensus")
        moved |= not torch.equal(tc.compression, tl.compression)
        jstate = jc
    assert moved, "the estimate stack never advanced"


@pytest.mark.parametrize("compressor", ["qint8", "topk"])
def test_compressed_rounds_free_running_loosely(compressor, mnist_small):
    """Free-running compressed rounds drift apart by whole quantization steps
    (module docstring), so only the mean training loss is compared, within
    1e-3 relative."""
    jcfg, tcfg, classes = _timevarying_case("round_robin", compressor)
    task, parts, sizes, jstate, tstate = _start(jcfg, tcfg, classes, mnist_small)
    jround = jp2p.make_round_fn(jmlp.loss_2nn, jcfg, data_sizes=sizes)
    tround = tp2p.make_round_fn(task, tcfg, data_sizes=sizes, device="cpu")
    jbatch = jpipeline.PeerBatcher(parts, 10, seed=0)
    tbatch = tpipeline.PeerBatcher(parts, 10, seed=0)
    for _ in range(ROUNDS):
        bx, by = jbatch.round_batches(jcfg.local_steps)
        tx, ty = tbatch.round_batches_on(tcfg.local_steps, torch.device("cpu"))
        _, jstate, jloss = jround(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        _, tstate, tloss = tround(tstate, (tx, ty))
        np.testing.assert_allclose(float(tloss.mean()), float(np.mean(jloss)), rtol=1e-3)
    assert torch.isfinite(tstate.params).all()

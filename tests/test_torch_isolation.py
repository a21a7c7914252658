"""The port stands alone and never quietly runs on the CPU.

- nothing under src/repro_torch/ nor chip_smoke.py imports jax or repro;
- entry points default to CUDA and raise without it;
- the consensus wrappers take their plain versions for CPU tensors only,
  never count those calls as launches, and have no fallback around their
  kernels.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.p2pl_mnist import iid_k100, noniid_k2, timevarying_k8  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p  # noqa: E402
from repro_torch.core import task as task_lib  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant, ops, segment  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    assert len(PORT_FILES) > 20
    bad = [
        (path.relative_to(ROOT).as_posix(), mod)
        for path in PORT_FILES
        for mod in _imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []


def test_kernel_ab_imports_neither_jax_nor_reference():
    """tools/kernel_ab.py runs on the card beside chip_smoke.py: no jax, no
    reference package."""
    path = ROOT / "tools" / "kernel_ab.py"
    assert [mod for mod in _imported_modules(path)
            if mod.split(".")[0] in ("jax", "jaxlib", "repro")] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_EXPERIMENTS = {
    "noniid_affinity": lambda: noniid_k2(algorithm="p2pl_affinity"),
    "timevarying_k8_qint8": lambda: timevarying_k8(schedule="round_robin", compressor="qint8"),
    "timevarying_k8_topk_link_dropout": lambda: timevarying_k8(schedule="link_dropout",
                                                               compressor="topk"),
}


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("experiment", sorted(ENTRY_EXPERIMENTS))
def test_entry_points_raise_without_cuda(no_cuda, device, experiment, mnist_small):
    exp = ENTRY_EXPERIMENTS[experiment]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_paper_experiment(exp, rounds=1, data=mnist_small, device=device)
    task = task_lib.get_task("mnist_mlp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p2p.init_state(task, exp.p2p, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p2p.make_round_fn(task, exp.p2p, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p2p.round_operands(exp.p2p, device=device)


@pytest.mark.parametrize("argv", [
    ["--experiment", "timevarying_k8", "--schedule", "round_robin", "--compressor", "qint8"],
    ["--experiment", "timevarying_k8", "--schedule", "round_robin", "--compressor", "topk",
     "--topk-frac", "0.01"],
    ["--experiment", "iid_k100", "--compressor", "qint8"],
    ["--experiment", "timevarying_k2", "--schedule", "link_dropout"],
])
def test_cli_raises_without_cuda(no_cuda, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([*argv, "--rounds", "1"])


@pytest.mark.parametrize("argv,msg", [
    (["--topk-frac", "0"], "--topk-frac must be in (0, 1]"),
    (["--protocol", "flood"], "invalid choice"),  # one_way_matching is valid since push-sum
    (["--adaptive-eps", "2"], "--adaptive-eps must be in [0, 1]"),
])
def test_cli_rejects_bad_flags(argv, msg, capsys):
    with pytest.raises(SystemExit) as ex:
        train.main(["--experiment", "timevarying_k8", *argv, "--device", "cpu"])
    assert ex.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_builds_the_reference_experiments():
    """The CLI's experiment builders and overrides follow the reference's
    (src/repro/launch/train.py): --compressor applies to any experiment."""
    parse = lambda *a: train.argparse.Namespace(  # noqa: E731
        topology="ring", local_steps=None, algorithm="local_dsgd", schedule=None,
        schedule_rounds=16, link_survival_prob=0.7, peer_online_prob=0.8,
        round_robin_topologies="ring,star", compressor=None, topk_frac=0.01,
        partner_rule="loss_proximity", adaptive_eps=0.1, adaptive_seed=0)
    exp = train.EXPERIMENTS["timevarying_k8"](parse())
    assert exp.p2p.schedule == "link_dropout" and exp.p2p.algorithm == "local_dsgd"
    assert exp.p2p.round_robin_topologies == ("ring", "star")
    assert train.EXPERIMENTS["iid_k100"](parse()).name == iid_k100(topology="ring").name


def _ring_ops(device="cpu"):
    g = tgraph.build_graph("ring", 4)
    return ops.sparse_from_matrices(tgraph.mixing_matrix(g), tgraph.affinity_matrix(g),
                                    device=device)


def test_wrapper_raises_off_cpu_and_cuda():
    flat = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.consensus_mix_stacked(flat, _ring_ops("meta"), 10)


@pytest.mark.parametrize("module", [ops, dequant, segment])
def test_wrapper_has_no_fallback_around_the_kernel(module):
    tree = ast.parse(Path(module.__file__).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    ops.launches.reset()
    dequant.launches.reset()
    rng = np.random.default_rng(0)
    flat = torch.as_tensor(rng.normal(size=(4, 33)).astype(np.float32))
    q = torch.as_tensor(rng.integers(-127, 128, (4, 33)).astype(np.int8))
    scale = torch.full((4, 2), 0.01)
    for _ in range(3):
        ops.consensus_mix_stacked(flat, _ring_ops(), 10)
        dequant.dequant_mix_stacked(flat, flat, q, scale, _ring_ops(), (0, 16, 33), 10)
        dequant.dequant_mix_stacked(flat, flat, None, None, _ring_ops(), (0, 33), 10)
    assert ops.launches.count == 0 and dequant.launches.count == 0


def test_compressed_round_on_cpu_launches_no_kernel(mnist_small):
    """A compressed CPU round runs the plain versions: no launch is counted."""
    ops.launches.reset()
    dequant.launches.reset()
    exp = timevarying_k8(schedule="round_robin", compressor="qint8")
    log = train.run_paper_experiment(exp, rounds=1, data=mnist_small, device="cpu")
    assert np.isfinite(log.train_loss).all()
    assert ops.launches.count == 0 and dequant.launches.count == 0

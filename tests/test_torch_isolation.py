"""The port stands alone and never quietly runs on the CPU.

- nothing under src/repro_torch/ nor chip_smoke.py imports jax or repro;
- entry points default to CUDA and raise without it;
- the consensus wrapper takes its plain version for CPU tensors only, never
  counts those calls as launches, and has no fallback around its kernel.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.p2pl_mnist import noniid_k2  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p  # noqa: E402
from repro_torch.core import task as task_lib  # noqa: E402
from repro_torch.kernels.consensus_mix import ops  # noqa: E402
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


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_points_raise_without_cuda(no_cuda, device, mnist_small):
    exp = noniid_k2(algorithm="p2pl_affinity")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_paper_experiment(exp, rounds=1, data=mnist_small, device=device)
    task = task_lib.get_task("mnist_mlp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p2p.init_state(task, exp.p2p, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p2p.make_round_fn(task, exp.p2p, device=device)


def _ring_ops(device="cpu"):
    g = tgraph.build_graph("ring", 4)
    return ops.sparse_from_matrices(tgraph.mixing_matrix(g), tgraph.affinity_matrix(g),
                                    device=device)


def test_wrapper_raises_off_cpu_and_cuda():
    flat = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.consensus_mix_stacked(flat, _ring_ops("meta"), 10)


def test_wrapper_has_no_fallback_around_the_kernel():
    tree = ast.parse(Path(ops.__file__).read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    ops.launches.reset()
    flat = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 33)).astype(np.float32))
    for _ in range(3):
        ops.consensus_mix_stacked(flat, _ring_ops(), 10)
    assert ops.launches.count == 0

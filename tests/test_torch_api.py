"""Port parity, the reference's public API: every public name of the JAX
package has a counterpart at the same path in the port, called the
reference's way, with the reference's result.

- ``repro_torch.core`` exports the reference's ``repro.core.__all__`` (the
  same 49 names), and every module of the port imports first in a fresh
  import state (the core package resolves its names lazily);
- a name-parity walk over every module of ``src/repro``: each public
  top-level name has a counterpart in the port's module of the same path,
  or stands in ``LEFT`` beside the ROADMAP.md item that ports it (or why it
  needs none);
- ``core.features``: active features, violations, ``check`` and the README's
  support matrix, string-equal;
- ``core.protocols``: ``register_protocol``'s refusals, a registered
  protocol running a round through ``p2p.run_round``,
  ``age_decayed_constants``; ``core.p2p.mixing_constants``;
  ``core.consensus.mix_leaf`` and ``scatter_rows``;
- the data functions (``token_stream``, ``lm_batches``,
  ``dirichlet_partition``, ``global_to_peer_batch``) array-equal;
- the oracles' reference names (``consensus_mix_ref``, ``dequant_mix_ref``,
  ``ssd_ref``).

Tolerance: float32 atol 5e-5 / rtol 1e-4, bf16 5e-2 (tests/test_kernels.py);
host-side numpy exact.
"""
import ast
import dataclasses
import importlib
import itertools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.configs import p2pl_mnist as jconfigs  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import p2p as jp2p  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.kernels.consensus_mix import ref as jref  # noqa: E402
from repro.kernels.mamba2 import ref as jssd_ref  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import p2pl_mnist as tconfigs  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import features as tfeatures  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import p2p as tp2p  # noqa: E402
from repro_torch.core import protocols as tprotocols  # noqa: E402
from repro_torch.core import task as ttask  # noqa: E402
from repro_torch.data import partition as tpartition  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.kernels.consensus_mix import ref as tref  # noqa: E402
from repro_torch.kernels.mamba2 import ref as tssd_ref  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread: the suite runs several workers on a few shared cores
torch.set_num_threads(1)
TOL = dict(atol=5e-5, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
SRC = Path(__file__).resolve().parents[1] / "src"

# ---------------------------------------------------------------------------
# The name-parity walk
# ---------------------------------------------------------------------------

ITEM_18C = "ROADMAP.md queue 1 item 18c (the examples, the next slice)"
ALIAS = "no counterpart needed: a type alias"
PALLAS = "no counterpart needed here: the Pallas kernel, ported by hand as {}"
SHARDING = ("not ported yet: places tensors over a data and model mesh within one peer; the "
            "port does not split a peer over cards, which waits for a machine with several "
            "cards and item 15b's NCCL transport (ROADMAP.md queue 1)")

# reference modules with no module at the same path in the port
LEFT_MODULES = {
    "kernels/consensus_mix/consensus_mix.py": PALLAS.format(
        "consensus_mix/csrc/consensus_mix.cu (ops.consensus_mix_stacked)"),
    "kernels/flash_attention/flash_attention.py": PALLAS.format(
        "flash_attention/csrc/flash_attention.cu (ops.gqa_flash_attention)"),
    "kernels/mamba2/mamba2.py": PALLAS.format("mamba2/csrc/ssd.cu (ops.ssd)"),
    "kernels/rwkv6/rwkv6.py": PALLAS.format("rwkv6/csrc/wkv6.cu (ops.wkv6)"),
    "kernels/lowering.py": (
        "no counterpart needed: the Pallas interpret policy; the port has no interpret mode, "
        "its counterpart is the device dispatch of device.py:resolve_device and of each "
        "kernel wrapper (a CPU tensor takes the plain version, a CUDA tensor the kernel)"),
    "launch/hlo_cost.py": (
        "ported as launch/op_cost.py: the port has no HLO, so its eager steps are counted op "
        "by op as they are dispatched (each layer's ops once a layer: no trip counts)"),
    "sharding/__init__.py": SHARDING,
    "sharding/logical.py": SHARDING,
    "sharding/specs.py": SHARDING + (
        "; specs.hierarchical_layout's counterpart is core/p2p.py:check_hierarchical_layout"),
}
# public names of ported modules that the port's module lacks
LEFT_NAMES = {
    ("compression/compressors.py", "PyTree"): ALIAS,
    ("core/consensus.py", "PyTree"): ALIAS,
    ("core/p2p.py", "LossFn"): ALIAS,
    ("core/p2p.py", "PyTree"): ALIAS,
    ("core/protocols.py", "PyTree"): ALIAS,
    ("core/task.py", "PyTree"): ALIAS,
    ("kernels/consensus_mix/dequant.py", "PyTree"): ALIAS,
    ("kernels/consensus_mix/dequant.py", "dequant_mix_2d"): PALLAS.format(
        "consensus_mix/csrc/dequant_mix.cu (dequant.dequant_mix_stacked)"),
    ("kernels/consensus_mix/ops.py", "PyTree"): ALIAS,
    ("kernels/consensus_mix/segment.py", "segment_mix_2d"): PALLAS.format(
        "consensus_mix/csrc/segment_mix.cu (segment.segment_mix_stacked)"),
    ("launch/dryrun_lib.py", "ACTIVATION_RULES"): SHARDING + (
        ": the activations' logical axes over that mesh"),
    ("launch/dryrun_lib.py", "PyTree"): ALIAS,
    ("launch/mesh.py", "make_test_mesh"): SHARDING + (
        ": a small data x model mesh for the sharding tests"),
    ("launch/roofline.py", "parse_collectives"): (
        "no counterpart needed: it reads collectives off HLO text; the port's collective term "
        "counts the peer exchange's bytes (dryrun_lib.exchange_bytes, the sends of "
        "core/peer_group.py:PeerGroup.exchange)"),
    ("launch/serve.py", "PyTree"): ALIAS,
    ("launch/steps.py", "PyTree"): ALIAS,
    ("models/registry.py", "PyTree"): ALIAS,
    ("models/transformer.py", "PyTree"): ALIAS,
}


def _reference_names(path: Path) -> set[str]:
    """Public top-level names a reference module defines (def, class,
    assignment) and its ``__all__``, read from its source."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                names.update(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _port_module(rel: Path) -> str:
    parts = rel.with_suffix("").parts
    return ".".join(("repro_torch",) + (parts[:-1] if parts[-1] == "__init__" else parts))


REFERENCE_MODULES = sorted(p.relative_to(SRC / "repro").as_posix()
                           for p in (SRC / "repro").rglob("*.py"))


@pytest.mark.parametrize("rel", REFERENCE_MODULES)
def test_every_reference_name_has_a_counterpart(rel):
    want = _reference_names(SRC / "repro" / rel)
    if rel in LEFT_MODULES:
        assert not (SRC / "repro_torch" / rel).exists(), f"{rel} is ported: drop it from LEFT"
        return
    module = importlib.import_module(_port_module(Path(rel)))
    have = set(dir(module)) | set(getattr(module, "__all__", ()))
    missing = want - have
    listed = {name for (path, name) in LEFT_NAMES if path == rel}
    assert missing == listed, (f"{rel}: missing {sorted(missing - listed)}, listed but "
                               f"present {sorted(listed - missing)}")


# the reference's examples (thin drivers of ported entry points), still to port
LEFT_EXAMPLES = dict.fromkeys(
    ("p2p_adaptive.py", "p2p_async.py", "p2p_compressed.py", "p2p_noniid_affinity.py",
     "p2p_pushsum.py", "p2p_realmodel.py", "p2p_serve.py", "p2p_sharded.py",
     "p2p_timevarying.py", "quickstart.py", "serve_batch.py", "train_p2p_llm.py"), ITEM_18C)


def test_left_examples_are_the_reference_examples():
    examples = SRC.parent / "examples"
    assert set(LEFT_EXAMPLES) == {p.name for p in examples.glob("*.py")}


def test_left_names_are_reference_names():
    for path, name in LEFT_NAMES:
        assert name in _reference_names(SRC / "repro" / path), (path, name)
    assert set(LEFT_MODULES) <= set(REFERENCE_MODULES)


def test_core_exports_the_reference_names():
    assert len(jcore.__all__) == 49
    assert set(tcore.__all__) == set(jcore.__all__)
    for name in jcore.__all__:
        assert getattr(tcore, name) is not None, name
    namespace = {}
    exec("from repro_torch.core import *", namespace)
    assert set(namespace) - {"__builtins__"} == set(jcore.__all__)
    assert tcore.GossipProtocol is tprotocols.GossipProtocol
    assert tcore.consensus is tconsensus and tcore.protocols is tprotocols
    with pytest.raises(AttributeError):
        tcore.no_such_name  # noqa: B018


PORT_MODULES = sorted(_port_module(p.relative_to(SRC / "repro_torch"))
                      for p in (SRC / "repro_torch").rglob("*.py"))


@pytest.mark.parametrize("name", PORT_MODULES)
def test_module_imports_first(name):
    """Each module of the port imports with no other module of the port
    loaded (torch stays loaded); the caller's modules come back after."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "repro_torch" or k.startswith("repro_torch.")}
    try:
        for k in saved:
            del sys.modules[k]
        importlib.import_module(name)
    finally:
        for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
            del sys.modules[k]
        sys.modules.update(saved)


# ---------------------------------------------------------------------------
# core.features
# ---------------------------------------------------------------------------

CONTEXT_AXES = dict(schedule=("static", "adaptive"), compressor=("none", "qint8"),
                    steps_profile=("uniform", "linear"), staleness_bound=(0, 2),
                    model=("mnist_mlp", "rwkv6_seqmnist"), peers_per_device=(1, 8))


def test_features_agree_with_reference():
    for values in itertools.product(*CONTEXT_AXES.values()):
        kw = dict(zip(CONTEXT_AXES, values))
        jctx, tctx = jfeatures.FeatureContext(**kw), tfeatures.FeatureContext(**kw)
        assert tfeatures.active_features(tctx) == jfeatures.active_features(jctx)
        assert ([dataclasses.astuple(v) for v in tfeatures.violations(tctx)]
                == [dataclasses.astuple(v) for v in jfeatures.violations(jctx)])
        try:
            jfeatures.check(jctx)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tfeatures.check(tctx)
            assert str(got.value) == str(e)
        else:
            tfeatures.check(tctx)
    assert [(f.name, f.title) for f in tfeatures.FEATURES.values()] == \
        [(f.name, f.title) for f in jfeatures.FEATURES.values()]


def test_support_matrix_markdown_is_the_reference_string():
    assert tfeatures.support_matrix_markdown() == jfeatures.support_matrix_markdown()
    readme = (SRC.parent / "README.md").read_text()
    assert tfeatures.support_matrix_markdown() in readme


# ---------------------------------------------------------------------------
# core.protocols, core.p2p.mixing_constants
# ---------------------------------------------------------------------------


class LazyGossip(tprotocols.GossipProtocol):
    """Gossip that moves each peer half way to its gossip step."""

    name = "lazy_gossip_test"

    def mix(self, proto_state, flat, ops, local_steps):
        proto_state, mixed, d = super().mix(proto_state, flat, ops, local_steps)
        return proto_state, 0.5 * (flat + mixed), d


@pytest.fixture
def lazy_gossip():
    proto = tprotocols.register_protocol(LazyGossip())
    try:
        yield proto
    finally:
        del tprotocols._REGISTRY[proto.name]


@pytest.mark.parametrize("make", [
    lambda p: p.ConsensusProtocol(),
    lambda p: type("Nameless", (p.GossipProtocol,), {"name": ""})(),
    lambda p: p.GossipProtocol(),
    lambda p: p.PushSumProtocol(),
], ids=["base", "empty", "gossip_again", "push_sum_again"])
def test_register_protocol_refusals_match_reference(make):
    with pytest.raises(ValueError) as want:
        jprotocols.register_protocol(make(jprotocols))
    with pytest.raises(ValueError) as got:
        tprotocols.register_protocol(make(tprotocols))
    assert str(got.value) == str(want.value)
    assert tprotocols.protocol_names() == jprotocols.protocol_names() == ("gossip", "push_sum")


def test_unknown_protocol_message_matches_reference():
    with pytest.raises(ValueError) as want:
        jprotocols.get_protocol("flood")
    with pytest.raises(ValueError) as got:
        tprotocols.get_protocol("flood")
    assert str(got.value) == str(want.value)


def test_base_protocol_declares_the_runtime_interface():
    base = tprotocols.ConsensusProtocol()
    assert (base.name, base.stochasticity, base.directed_capable) == ("base", "row", False)
    for proto in (tprotocols.GossipProtocol(), tprotocols.PushSumProtocol()):
        assert isinstance(proto, tprotocols.ConsensusProtocol)
    calls = {"init_state": (None,), "mix": (None,) * 4, "mix_compressed": (None,) * 6,
             "mix_stale": (None,) * 5, "mix_hier": (None,) * 5}
    for method, args in calls.items():
        assert getattr(tprotocols.GossipProtocol, method) is not getattr(
            tprotocols.ConsensusProtocol, method), method
        with pytest.raises(NotImplementedError):
            getattr(base, method)(*args, **({"mode": "bridge"} if method == "mix_hier" else {}))


def test_registered_protocol_runs_a_round(lazy_gossip, mnist_small):
    assert tprotocols.protocol_names()[-1] == lazy_gossip.name
    assert tprotocols.get_protocol(lazy_gossip.name) is lazy_gossip
    x, y, _, _ = mnist_small
    parts = tpartition.pathological_partition(x, y, [(0, 1), (7, 8)], samples_per_class=50)
    sizes = tpartition.data_sizes(parts)
    gossip = tconfigs.noniid_k2(algorithm="p2pl_affinity", local_steps=3).p2p
    lazy = dataclasses.replace(gossip, protocol=lazy_gossip.name)
    task = ttask.get_task("mnist_mlp")
    batches = tpipeline.PeerBatcher(parts, 10, seed=0).round_batches_on(3, torch.device("cpu"))
    out = {}
    for cfg in (gossip, lazy):
        state = tp2p.init_state(task, cfg, data_sizes=sizes, device="cpu")
        ops = tp2p.round_operands(cfg, sizes, device="cpu")[0]
        out[cfg.protocol] = tp2p.run_round(state, task, batches, cfg, ops)
    (g_local, g_cons, g_loss), (l_local, l_cons, l_loss) = out["gossip"], out[lazy.protocol]
    assert torch.equal(g_local.params, l_local.params) and torch.equal(g_loss, l_loss)
    torch.testing.assert_close(l_cons.params, 0.5 * (l_local.params + g_cons.params),
                               atol=0, rtol=0)
    torch.testing.assert_close(l_cons.d_bias, g_cons.d_bias, atol=0, rtol=0)
    assert not torch.equal(l_cons.params, g_cons.params)
    assert l_cons.round_idx == 1


@pytest.mark.parametrize("stochasticity", ["row", "column"])
def test_age_decayed_constants_match_reference(stochasticity):
    graph = tgraph.build_graph("erdos_renyi", 8, p=0.5, seed=3)
    sched = tgraph.static_schedule(graph)
    sizes = np.arange(1, 9) * 10
    w, beta = tgraph.schedule_matrices(sched, "data_weighted", data_sizes=sizes,
                                       stochasticity=stochasticity)
    decay = np.array([1.0, 0.5, 0.25, 1.0, 0.0, 0.9, 0.125, 1.0], np.float32)
    beta = beta[0].copy()
    beta[3] = 0.0  # an isolated row stays zero
    want = jprotocols.age_decayed_constants(
        jprotocols.ProtocolConstants(jnp.asarray(w[0], jnp.float32),
                                     jnp.asarray(beta, jnp.float32)),
        jnp.asarray(decay), stochasticity)
    got = tprotocols.age_decayed_constants(
        tprotocols.ProtocolConstants(torch.as_tensor(w[0]), torch.as_tensor(beta)),
        torch.as_tensor(decay), stochasticity)
    for field in ("w", "beta"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **TOL, err_msg=field)
    assert not bool(got.beta[3].any())
    with pytest.raises(ValueError):
        tprotocols.age_decayed_constants(got, torch.as_tensor(decay), "diagonal")


MIXING_CASES = {
    "noniid_k2": lambda m: m.noniid_k2(algorithm="p2pl_affinity"),
    "timevarying_k8_link_dropout": lambda m: m.timevarying_k8(schedule="link_dropout"),
    "timevarying_k8_round_robin": lambda m: m.timevarying_k8(schedule="round_robin"),
    "directed_k8_one_way": lambda m: m.directed_k8(schedule="one_way_matching"),
}


@pytest.mark.parametrize("case", sorted(MIXING_CASES))
def test_mixing_constants_equal_reference(case):
    jexp, texp = MIXING_CASES[case](jconfigs), MIXING_CASES[case](tconfigs)
    sizes = np.arange(1, texp.p2p.num_peers + 1) * 7
    jw, jb, jsched = jp2p.mixing_constants(jexp.p2p, sizes)
    tw, tb, tsched = tp2p.mixing_constants(texp.p2p, sizes)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tb, jb)
    assert tsched.name == jsched.name and tw.shape[0] == len(tsched.graphs)


# ---------------------------------------------------------------------------
# core.consensus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mix_leaf_matches_reference(dtype):
    rng = np.random.default_rng(4)
    w = rng.dirichlet(np.ones(5), size=5).astype(np.float32)
    leaf = rng.normal(size=(5, 3, 7)).astype(np.float32)
    jleaf = jnp.asarray(leaf).astype(dtype)
    want = jconsensus.mix_leaf(jnp.asarray(w), jleaf)
    got = tconsensus.mix_leaf(torch.as_tensor(w), torch.as_tensor(leaf).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (5, 3, 7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_scatter_rows_equals_reference():
    graph = tgraph.build_graph("erdos_renyi", 12, p=0.3, seed=1)
    sparse = tgraph.SparseSchedule.from_schedule(tgraph.static_schedule(graph), degree_bound=6)
    rows = np.arange(4, 9)
    idx, w = sparse.nbr_idx[0][rows], sparse.nbr_w[0][rows].astype(np.float32)
    self_w = sparse.self_w[0][rows].astype(np.float32)
    want = jconsensus.scatter_rows(jnp.asarray(idx), jnp.asarray(w), 12,
                                   row_ids=jnp.asarray(rows, jnp.int32),
                                   self_w=jnp.asarray(self_w))
    got = tconsensus.scatter_rows(torch.as_tensor(idx), torch.as_tensor(w), 12,
                                  row_ids=torch.as_tensor(rows), self_w=torch.as_tensor(self_w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tconsensus.scatter_rows(torch.as_tensor(idx), torch.as_tensor(w), 12).numpy(),
        np.asarray(jconsensus.scatter_rows(jnp.asarray(idx), jnp.asarray(w), 12)))
    with pytest.raises(ValueError, match="row_ids"):
        tconsensus.scatter_rows(torch.as_tensor(idx), torch.as_tensor(w), 12,
                                self_w=torch.as_tensor(self_w))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_token_stream_and_lm_batches_equal_reference():
    for kw in (dict(seed=0), dict(seed=3, zipf_a=1.5)):
        np.testing.assert_array_equal(tsynthetic.token_stream(5000, 512, **kw),
                                      jsynthetic.token_stream(5000, 512, **kw))
    got = tsynthetic.lm_batches(3, 2, 16, 49152, seed=1)
    want = jsynthetic.lm_batches(3, 2, 16, 49152, seed=1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == (3, 2, 16)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][..., 1:], got[1][..., :-1])


@pytest.mark.parametrize("num_peers,alpha,n", [(4, 0.5, 2000), (10, 0.01, 300), (7, 0.05, 40)])
def test_dirichlet_partition_equals_reference(num_peers, alpha, n, mnist_small):
    x, y = mnist_small[0][:n], mnist_small[1][:n]
    if n == 40:  # three classes: most peers empty before the rebalancing loop
        keep = np.isin(y, [0, 1, 2])
        x, y = x[keep], y[keep]
    got = tpartition.dirichlet_partition(x, y, num_peers, alpha=alpha, seed=2)
    want = jpartition.dirichlet_partition(x, y, num_peers, alpha=alpha, seed=2)
    assert len(got) == len(want) == num_peers
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert min(len(p[1]) for p in got) >= 1
    assert sum(len(p[1]) for p in got) == len(y)
    with pytest.raises(ValueError, match="at least one sample per peer"):
        tpartition.dirichlet_partition(x[:3], y[:3], 4)


def test_global_to_peer_batch_equals_reference():
    x = np.arange(24 * 3).reshape(24, 3)
    np.testing.assert_array_equal(tpipeline.global_to_peer_batch(x, 4),
                                  jpipeline.global_to_peer_batch(x, 4))
    with pytest.raises(AssertionError):
        jpipeline.global_to_peer_batch(x, 5)
    with pytest.raises(ValueError, match="not divisible"):
        tpipeline.global_to_peer_batch(x, 5)


# ---------------------------------------------------------------------------
# the oracles' reference names
# ---------------------------------------------------------------------------


def _one_peer_case(d=3, n=200, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32), rng.normal(size=(d, n)).astype(np.float32),
            np.float32(0.3), rng.dirichlet(np.ones(d)).astype(np.float32) * 0.7,
            rng.dirichlet(np.ones(d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consensus_mix_ref_matches_reference(dtype):
    x, nbrs, ws, wn, beta = _one_peer_case()
    want = jref.consensus_mix_ref(jnp.asarray(x).astype(dtype), jnp.asarray(nbrs).astype(dtype),
                                  jnp.asarray(ws), jnp.asarray(wn), jnp.asarray(beta), 4)
    tdt = getattr(torch, dtype)
    got = tref.consensus_mix_ref(torch.as_tensor(x).to(tdt), torch.as_tensor(nbrs).to(tdt),
                                 ws, torch.as_tensor(wn), torch.as_tensor(beta), 4)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == (200,)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   **(TOL if dtype == "float32" else BF16_TOL))
    # no neighbor weight in beta: d stays 0
    _, d0 = tref.consensus_mix_ref(torch.as_tensor(x), torch.as_tensor(nbrs), ws,
                                   torch.as_tensor(wn), torch.zeros(3), 4)
    assert not bool(d0.any())


def test_dequant_mix_ref_matches_reference():
    x, nbrs, ws, wn, beta = _one_peer_case(seed=1)
    rng = np.random.default_rng(7)
    self_est = x + rng.normal(scale=0.1, size=x.shape).astype(np.float32)
    q = rng.integers(-127, 128, size=nbrs.shape).astype(np.int8)
    scale = rng.uniform(0.0, 0.01, size=3).astype(np.float32)
    want = jref.dequant_mix_ref(*(jnp.asarray(a) for a in (x, self_est, nbrs, q, scale, ws, wn,
                                                           beta)), 4)
    got = tref.dequant_mix_ref(*(torch.as_tensor(a) for a in (x, self_est, nbrs, q, scale)),
                               ws, torch.as_tensor(wn), torch.as_tensor(beta), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_ref_matches_reference(with_state):
    rng = np.random.default_rng(2)
    b, t, h, p, n = 2, 40, 3, 4, 5
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, t, h, n)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.01, 0.5, size=(b, t, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_state else None
    want = jssd_ref.ssd_ref(*(jnp.asarray(v) for v in (x, bm, cm, dt, a)),
                            initial_state=None if s0 is None else jnp.asarray(s0))
    got = tssd_ref.ssd_ref(*(torch.as_tensor(v) for v in (x, bm, cm, dt, a)),
                           initial_state=None if s0 is None else torch.as_tensor(s0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

"""The dry run of the port (``repro_torch.launch.dryrun_lib`` and the
``launch.dryrun`` CLI) against the reference's figures:

- ``run_case`` on fake tensors succeeds for smollm-135m at all four input
  shapes and for one shape each of the other architectures, all at full
  width and depth (nothing is allocated);
- its parameter bytes equal the reference's ``param_bytes_total``
  (``jax.eval_shape(model.init, ...)``, as ``repro.launch.dryrun_lib``
  computes it), and for the prefill and decode shapes its cache bytes equal
  ``jax.eval_shape(model.init_cache)``'s;
- every hand kernel on the stepped path takes its fake route, once a layer,
  and nothing is built or launched; a real CPU tensor never takes it;
- the two-peer layout's training case adds the consensus step through
  ``consensus_mix``'s fake route, with the exchange's bytes as its
  collective term;
- the CLI writes its JSON and markdown and exits 0, and ``launch.report``
  tables its JSON; the CLI refuses the reference's XLA-only flags.

Tolerance: exact (byte counts and call counts).
"""
import json

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.launch import dryrun_lib as jdryrun  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.build import LaunchCounter  # noqa: E402
from repro_torch.launch import dryrun, dryrun_lib, mesh, report  # noqa: E402

torch.set_num_threads(1)

# one shape each beyond smollm-135m's four, covering every step kind, the
# vlm's patches, the encoder-decoder's training and each kernel's family
CASES = [("smollm-135m", shape) for shape in INPUT_SHAPES] + [
    ("rwkv6-7b", "prefill_32k"), ("minitron-8b", "long_500k"), ("phi4-mini-3.8b", "decode_32k"),
    ("qwen1.5-32b", "long_500k"), ("zamba2-2.7b", "prefill_32k"),
    ("deepseek-v2-236b", "long_500k"), ("qwen3-moe-235b-a22b", "long_500k"),
    ("internvl2-2b", "prefill_32k"), ("seamless-m4t-medium", "train_4k"),
]
_results: dict = {}


@pytest.fixture(autouse=True)
def _no_kernel_build(monkeypatch):
    """A fake call never builds or loads a kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the dry run reached the kernel build")

    monkeypatch.setattr(build, "load_library", refuse)


def _run(arch, shape, multi_pod=False) -> dryrun_lib.CaseResult:
    key = (arch, shape, multi_pod)
    if key not in _results:
        counts = [c.count for c in LaunchCounter.instances]
        _results[key] = dryrun_lib.run_case(arch, shape,
                                            mesh.make_production_mesh(multi_pod=multi_pod))
        assert [c.count for c in LaunchCounter.instances] == counts, "a fake call launched"
    res = _results[key]
    assert res.ok, res.error
    return res


def _expected_calls(cfg, kind: str) -> dict:
    """The hand kernels one step of ``kind`` calls: one forward a layer in
    training and prefill (a backward too in training), none in a decode
    step (its attention and recurrences take no kernel)."""
    if kind == "decode":
        return {}
    if cfg.family == "rwkv6":
        fwd = {"wkv6": cfg.num_layers}
    elif cfg.family == "hybrid":
        fwd = {"ssd": cfg.num_layers, "flash_attention": cfg.num_layers // cfg.shared_block_period}
    elif cfg.attention is not None and cfg.attention.kind == "mla":
        fwd = {}
    else:
        fwd = {"flash_attention": cfg.num_layers + (cfg.encoder_layers or 0)}
    if kind == "train":
        fwd |= {f"{k}_bwd": n for k, n in fwd.items()}
    return fwd


def _reference(arch, shape):
    cfg, shape_cfg = jdryrun.prepare_case(arch, shape)
    return jbuild_model(cfg), shape_cfg


@pytest.mark.parametrize("arch,shape", CASES)
def test_param_bytes_equal_the_references(arch, shape):
    res = _run(arch, shape)
    model, _ = _reference(arch, shape)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    want = sum(s.size * s.dtype.itemsize for s in jax.tree.leaves(params))
    assert res.state_bytes["params"] == want == res.report.param_bytes_per_chip


@pytest.mark.parametrize("arch,shape", [c for c in CASES if INPUT_SHAPES[c[1]].kind != "train"])
def test_cache_bytes_equal_the_references(arch, shape):
    res = _run(arch, shape)
    model, shape_cfg = _reference(arch, shape)
    cache = jax.eval_shape(lambda: model.init_cache(shape_cfg.global_batch, shape_cfg.seq_len))
    assert res.state_bytes["cache"] == sum(s.size * s.dtype.itemsize
                                           for s in jax.tree.leaves(cache))


@pytest.mark.parametrize("arch,shape", CASES)
def test_every_hand_kernel_takes_its_fake_route(arch, shape):
    res = _run(arch, shape)
    cfg, shape_cfg = dryrun_lib.prepare_case(arch, shape)
    assert res.kernel_calls == _expected_calls(cfg, shape_cfg.kind)
    assert res.report.extra["kernel_calls"] == res.kernel_calls
    assert res.report.extra["fake_device"] == dryrun_lib.fake_device() == "meta"
    rep = res.report
    assert rep.step_kind == shape_cfg.kind and rep.chips == 1
    assert rep.flops_per_chip > 0 and rep.hbm_bytes_per_chip > 0 and rep.collective_s == 0
    assert rep.extra["peak_bytes"] >= sum(res.state_bytes.values())
    assert res.fits == (rep.extra["peak_bytes"] <= mesh.PEAKS["H100 SXM"].memory_bytes)


def test_two_peers_add_the_consensus_step():
    res = _run("smollm-135m", "train_4k", multi_pod=True)
    one = _run("smollm-135m", "train_4k")
    rep, cons = res.report, res.consensus_report
    assert rep.chips == 2 and rep.mesh == "2x1card"
    assert res.state_bytes["params"] == 2 * one.state_bytes["params"]
    assert rep.param_bytes_per_chip == one.report.param_bytes_per_chip
    assert res.kernel_calls == one.kernel_calls  # the peers folded into one call a layer
    assert cons.step_kind == "consensus" and cons.extra["kernel_calls"] == {"consensus_mix": 1}
    # each rank sends its bf16 parameter row to the other, once
    assert cons.coll_breakdown == {"exchange": {"count": 1,
                                                "wire_bytes": float(one.state_bytes["params"])}}
    assert cons.collective_s == one.state_bytes["params"] / mesh.ICI_BW
    assert cons.memory_s > 0 and cons.useful_flop_ratio == 0.0


def test_a_case_that_cannot_run_is_a_failed_result():
    res = dryrun_lib.run_case("no-such-arch", "train_4k")
    assert not res.ok and "no-such-arch" in res.error and res.report is None


def test_cli_writes_json_and_markdown(tmp_path, capsys):
    out, md = tmp_path / "dryrun.json", tmp_path / "dryrun.md"
    rc = dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k", "--mesh", "both",
                      "--out", str(out), "--markdown", str(md)])
    assert rc == 0
    results = json.loads(out.read_text())
    assert [(r["mesh"], r["ok"]) for r in results] == [("1card", True), ("2x1card", True)]
    assert results[0]["report"]["extra"]["part"] == "H100 SXM"
    assert "| smollm-135m | long_500k | 1card | decode |" in md.read_text()
    printed = capsys.readouterr().out
    assert "fake tensors on 'meta'" in printed and "[ok]   smollm-135m" in printed
    assert "2/2 cases ran" in printed
    tables = tmp_path / "tables.md"
    report.main(["--single", str(out), "--out", str(tables)])
    text = tables.read_text()
    assert "| arch | long_500k |" in text and "| smollm-135m | memory " in text
    assert "2/2 ran" in text and "H100 SXM" in text


@pytest.mark.parametrize("flag", sorted(dryrun.XLA_ONLY))
def test_cli_refuses_xla_only_flags(flag):
    with pytest.raises(SystemExit, match="refused"):
        dryrun.main([flag, "x"])


def test_every_architecture_and_shape_is_a_case():
    assert len(set(a for a, _ in CASES)) == len(ARCHITECTURES)

"""Port parity of the roofline tooling (``repro_torch.launch.roofline`` and
``launch.mesh``) against the reference's ``repro.launch.roofline``:

- ``model_flops`` equals the reference's for every architecture x input
  shape x peers in {1, 2}, exactly (pure arithmetic on the configuration);
- ``fmt_seconds`` and ``markdown_table`` give the reference's strings for
  the same values; ``save_reports`` / ``load_reports`` round-trip;
- ``launch.mesh``: the part a card's name picks, the layouts, ``Card.bound``
  and ``Card.work_bound`` (both counts of a scan kernel).

Tolerance: exact (host arithmetic).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import for_shape as j_for_shape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, for_shape, get_config  # noqa: E402
from repro_torch.launch import mesh, roofline  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("peers", [1, 2])
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_model_flops_equals_the_reference(arch, shape, peers):
    assert set(ARCHITECTURES) == set(J_ARCHS) and set(INPUT_SHAPES) == set(J_SHAPES)
    got = roofline.model_flops(for_shape(get_config(arch), INPUT_SHAPES[shape]),
                               INPUT_SHAPES[shape], peers=peers)
    want = jroofline.model_flops(j_for_shape(j_get_config(arch), J_SHAPES[shape]),
                                 J_SHAPES[shape], peers=peers)
    assert got == want


@pytest.mark.parametrize("s", [0.0, 3.2e-10, 5e-9, 7.5e-6, 0.000999, 0.0123, 0.5, 1.0, 42.7])
def test_fmt_seconds_matches_the_reference(s):
    assert roofline.fmt_seconds(s) == jroofline.fmt_seconds(s)


def _fields(i: int) -> dict:
    return dict(arch=f"arch{i}", shape="train_4k", mesh="1card", chips=1 + i,
                step_kind="train", flops_per_chip=1.5e15 * (i + 1),
                hbm_bytes_per_chip=2.5e12, coll_wire_bytes_per_chip=3.0e9 * i,
                coll_breakdown={"exchange": {"count": 1, "wire_bytes": 3.0e9 * i}},
                compute_s=0.0123 * (i + 1), memory_s=0.75, collective_s=4e-6 * i,
                dominant="memory", model_flops_per_chip=1e15, useful_flop_ratio=0.6666,
                param_bytes_per_chip=2.7e8 * (i + 1), arg_bytes=1e9, temp_bytes=2e9,
                extra={"fits": i == 0})


def test_markdown_table_matches_the_reference():
    ported = [roofline.Roofline(**_fields(i)) for i in range(3)]
    reference = [jroofline.Roofline(**_fields(i)) for i in range(3)]
    assert [f.name for f in dataclasses.fields(roofline.Roofline)] == \
        [f.name for f in dataclasses.fields(jroofline.Roofline)]
    assert roofline.markdown_table(ported) == jroofline.markdown_table(reference)


def test_save_and_load_round_trip(tmp_path):
    reports = [roofline.Roofline(**_fields(i)) for i in range(2)]
    path = tmp_path / "reports.json"
    roofline.save_reports(str(path), reports)
    assert roofline.load_reports(str(path)) == [r.to_dict() for r in reports]
    assert jroofline.load_reports(str(path)) == [r.to_dict() for r in reports]


@pytest.mark.parametrize("name,part", [("NVIDIA H100 80GB HBM3", "H100 SXM"),
                                       ("NVIDIA H100 SXM5 80GB", "H100 SXM"),
                                       ("NVIDIA H100 PCIe", "H100 PCIe")])
def test_card_part_from_its_name(name, part):
    card = mesh.Card(f"{name}, 700.00 W")
    assert card.part == part and card.peaks is mesh.PEAKS[part]
    assert card.bytes_per_s == mesh.PEAKS[part].bytes_per_s


def test_unknown_card_and_part_raise():
    with pytest.raises(RuntimeError, match="no peak rates"):
        mesh.Card("NVIDIA A100-SXM4-80GB, 400.00 W")
    with pytest.raises(ValueError, match="unknown part"):
        mesh.Card.for_part("TPU v5e")


def test_peaks_are_the_h100s():
    card = mesh.Card.for_part()
    assert card.part == mesh.DEFAULT_PART == "H100 SXM"
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert "reckoned" in card.line


def test_layouts():
    one, two = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert (one.peers, mesh.num_chips(one)) == (1, 1)
    assert (two.peers, mesh.num_chips(two), two.name) == (2, 2, "2x1card")
    assert mesh.num_chips(mesh.make_peer_mesh(8)) == 8
    with pytest.raises(ValueError, match="at least one peer"):
        mesh.make_peer_mesh(0)


def test_bound_and_work_bound():
    card = mesh.Card("NVIDIA H100 80GB HBM3, 700.00 W")
    bd = card.bound(3.35e9, 67e9)  # 1 ms of bytes, 1 ms of float32 operations
    assert bd["bound_ms"] == pytest.approx(1.0) and bd["bound_by"] == "bytes"
    assert card.bound(1.0, 989e9, "bf16")["bound_by"] == "operations"
    work = roofline.Work(bytes=3.35e9, flops=134e9, kind="float32", tensor_flops=495e9,
                         tensor_kind="tf32")
    both = card.work_bound(work)  # pipes 2 ms (operations), tensor cores 1 ms
    assert both["bound_ms_fma"] == pytest.approx(2.0)
    assert both["bound_ms_tensor"] == pytest.approx(1.0)
    assert both["bound_ms"] == pytest.approx(1.0) and both["bound_tensor_type"] == "TF32"
    assert card.seconds(work) == pytest.approx(1e-3)

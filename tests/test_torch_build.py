"""The names the port's kernel build gives its libraries
(``repro_torch.kernels.build``), on the CPU: no ``nvcc`` runs here.

A library is built once under ``build/repro_torch/lib<name>-<hash>.so`` and
loaded as it is while its name stays the same, so the hash must change with
every file the compiler reads: the sources and every header they include
through a quoted ``#include``, followed from header to header and resolved
against the including file's directory as nvcc resolves it (the wkv6
backward includes ``../../mamba2/csrc/tf32_tiles.cuh``, which includes
``tf32_mma.cuh``).
"""
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402

KERNELS = Path(build.__file__).resolve().parent


def _copy_kernels(tmp_path: Path) -> Path:
    """A copy of the kernel sources' tree; returns the copied wkv6 backward."""
    for path in KERNELS.rglob("csrc/*.cu*"):
        dst = tmp_path / path.relative_to(KERNELS)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, dst)
    return tmp_path / "rwkv6" / "csrc" / "wkv6_bwd.cu"


def test_included_headers_follow_quoted_includes_across_directories():
    heads = build.included_headers(wkv6_ops.BWD_SOURCES)
    assert [h.relative_to(KERNELS).as_posix() for h in heads] == [
        "mamba2/csrc/tf32_mma.cuh", "mamba2/csrc/tf32_tiles.cuh"]


def test_every_quoted_include_of_every_kernel_resolves():
    for src in KERNELS.rglob("csrc/*.cu"):
        for header in build.included_headers([src]):
            assert header.is_file(), (src, header)


@pytest.mark.parametrize("header", ["tf32_tiles.cuh", "tf32_mma.cuh"])
def test_changing_an_included_header_renames_the_library(tmp_path, header):
    """A header in another directory, included directly or through another
    header: changing it gives the library another name, so the next load
    builds it anew instead of loading a stale one."""
    src = _copy_kernels(tmp_path)
    before = build.library_path("wkv6_bwd", [src])
    path = tmp_path / "mamba2" / "csrc" / header
    path.write_text(path.read_text() + "\n// changed\n")
    after = build.library_path("wkv6_bwd", [src])
    assert before != after
    assert before.parent == after.parent == build.BUILD_DIR
    assert after.name.startswith("libwkv6_bwd-") and after.suffix == ".so"


def test_a_header_nothing_includes_leaves_the_name(tmp_path):
    src = _copy_kernels(tmp_path)
    before = build.library_path("wkv6_bwd", [src])
    (src.parent / "unused.cuh").write_text("// included by nothing\n")
    assert build.library_path("wkv6_bwd", [src]) == before


def test_the_name_is_the_same_for_the_same_files(tmp_path):
    src = _copy_kernels(tmp_path)
    assert build.library_path("wkv6_bwd", [src]) == build.library_path("wkv6_bwd", [src])
    assert (build.library_path("wkv6_bwd", [src]).name
            == build.library_path("wkv6_bwd", wkv6_ops.BWD_SOURCES).name)

"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``.cu`` file with a plain C interface, compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library and loaded with ``ctypes``;
nothing includes PyTorch's headers, so a build takes seconds.  Libraries are
built at first use into ``build/repro_torch/`` at the repository root, under
a name keyed by a hash of the sources, every header they include (followed
from file to file, wherever it lies) and the flags, so a changed source or
header is rebuilt and an unchanged one is loaded as it is.  Nothing
here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class LaunchCounter:
    """Number of kernel launches since the last ``reset``; every wrapper
    keeps one and adds 1 where it launches its kernel, and nowhere else.
    ``instances`` lists every counter, for ``repro_torch.capture``, which
    moves the count of a recorded launch from the capture to each replay."""

    instances: list["LaunchCounter"] = []

    def __init__(self) -> None:
        self.count = 0
        LaunchCounter.instances.append(self)

    def reset(self) -> None:
        self.count = 0


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    log: str  # nvcc's output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    candidates = [
        Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc" if "CUDA_HOME" in os.environ else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for cand in candidates:
        if cand is not None and cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def included_headers(sources: list[Path]) -> list[Path]:
    """Every header the sources include through a quoted ``#include``, and
    every header those include in turn, each resolved against the directory
    of the file that names it (as nvcc resolves them); sorted."""
    found: set[Path] = set()
    todo = list(sources)
    while todo:
        src = todo.pop()
        for rel in _QUOTED_INCLUDE.findall(src.read_text()):
            header = (src.parent / rel).resolve()
            if header not in found:
                found.add(header)
                todo.append(header)
    return sorted(found)


def library_path(name: str, sources: list[Path]) -> Path:
    """``BUILD_DIR / lib<name>-<hash>.so``: the hash covers the flags, the
    sources and every header they include (``included_headers``)."""
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in [*sources, *included_headers(sources)]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str, sources: list[Path]) -> KernelLibrary:
    """Build (if needed) and load ``library_path(name, sources)``."""
    path = library_path(name, sources)
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return KernelLibrary(lib=ctypes.CDLL(str(path)), path=path, build_seconds=seconds, log=log)

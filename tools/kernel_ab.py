#!/usr/bin/env python3
"""Time two versions of the port's ``dequant_mix`` and ``flash_attention``
kernels in turns on one GPU: this checkout's and another tree's (an older
commit unpacked beside it).

Both versions are built from their ``.cu`` sources with the port's nvcc flags
into ``build/kernel_ab/``, called through the same C entry points on the same
inputs, held to the plain PyTorch versions at chip_smoke.py's tolerances, and
timed with CUDA events in turns (old, new, new, old) at the main paths'
shapes, beside the library call and the bound chip_smoke.py computes.

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/kernel_ab.py --old build/parent

Prints one JSON object a shape and, last, the card line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.core import graph as graph_lib  # noqa: E402
from repro_torch.core.p2p import layout_of  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402

KERNELS = {  # name: source below src/repro_torch/kernels, C entry point
    "dequant_mix": ("consensus_mix/csrc/dequant_mix.cu", None),
    "flash_attention": ("flash_attention/csrc/flash_attention.cu", "flash_attention_fwd"),
}
OUT = ROOT / "build" / "kernel_ab"


def build_lib(tree: Path, rel: str, tag: str) -> ctypes.CDLL:
    src = tree / "src" / "repro_torch" / "kernels" / rel
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{tag}-{src.stem}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def dequant_fn(lib: ctypes.CDLL, k: int):
    """The entry point this version's wrapper would call at K peers: the
    column-tile one where the library has it and K is within its cap."""
    tile = hasattr(lib, "dequant_mix_tile_f32") and dequant.takes_tile_path(k)
    fn = lib.dequant_mix_tile_f32 if tile else lib.dequant_mix_f32
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i64,
                   ctypes.c_float, ctypes.c_int, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn, "tile" if tile else "gather"


def ab_dequant(card, libs: dict, name: str, graph, k: int, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    layout = layout_of("mnist_mlp")
    sizes = np.full(k, 600)
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    sparse = ops.sparse_from_matrices(w, beta, device=dev)
    n, leaves, t = layout.row, layout.leaf_offsets, 10
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    est = x + torch.as_tensor(0.01 * rng.normal(size=(k, n)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(np.int8), device=dev)
    scale = torch.as_tensor(rng.uniform(0, 1e-4, (k, len(leaves) - 1)).astype(np.float32),
                            device=dev)
    want = ref.dequant_mix_stacked_ref(x, est, q, scale, leaves, *sparse, t)
    starts = (ctypes.c_int64 * (len(leaves) - 1))(*leaves[:-1])
    stream = torch.cuda.current_stream().cuda_stream
    runs, paths = {}, {}
    for tag, lib in libs.items():
        fn, paths[tag] = dequant_fn(lib, k)
        outs = [torch.empty_like(x) for _ in range(3)]

        def run(fn=fn, outs=outs):
            err = fn(x.data_ptr(), est.data_ptr(), q.data_ptr(), scale.data_ptr(), starts,
                     len(leaves) - 1, k, n, sparse.self_w.data_ptr(), sparse.nbr_idx.data_ptr(),
                     sparse.nbr_w.data_ptr(), sparse.beta.data_ptr(), sparse.nbr_idx.shape[1],
                     float(t), 1, *(o.data_ptr() for o in outs), stream)
            chip_smoke.check(err == 0, f"dequant_mix {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        for got, ref_out in zip(outs, want):
            torch.testing.assert_close(got, ref_out, **chip_smoke.TOL)
        runs[tag] = run
    dense = ref.dense_mix_operator(sparse.nbr_idx, sparse.nbr_w, sparse.beta)
    lib_out = torch.empty(2 * k, n, device=dev)
    times = in_turns(runs, lambda: torch.matmul(dense, want[2], out=lib_out))
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    flops = n * (4 * real + 5 * k)
    nbytes = 4 * k * n * 4 + k * n + k * (len(leaves) - 1) * 4 + k * n * 4 + k * 4 + \
        3 * k * sparse.nbr_idx.shape[1] * 4
    return {"kernel": "dequant_mix", "case": name, "K": k, "N": n, "paths": paths, **times,
            **card.bound(nbytes, flops)}


def ab_flash(card, libs: dict, name: str, b, s, h, kh, d, *, window=None, seed=0) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    want = flash_ref.gqa_attention_ref(q, k, v, causal=True, window=window)
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    for tag, lib in libs.items():
        fn = lib.flash_attention_fwd
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ptr] * 4 + [i64] * 6 + [ctypes.POINTER(i64), i64, i64, ctypes.c_double,
                                               ptr]
        fn.restype = ctypes.c_int
        out = torch.empty_like(q)
        strides = (ctypes.c_int64 * 12)(*(st for x in (q, k, v, out) for st in x.stride()[:3]))

        def run(fn=fn, out=out, strides=strides):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, s, h, kh, d,
                     strides, 1, window or 0, d**-0.5, stream)
            chip_smoke.check(err == 0, f"flash_attention {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        chip_smoke.check_flash(out, want, f"flash {tag} {name}")
        runs[tag] = run
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        library = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    else:
        mask = chip_smoke.visible_mask(s, causal=True, window=window, device=dev)
        library = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    times = in_turns(runs, library)
    bound = card.bound(*chip_smoke.flash_work(b, s, h, kh, d, causal=True, window=window,
                                              elem_bytes=2), bf16=True)
    return {"kernel": "flash_attention", "case": name, "B": b, "S": s, "H": h, "Kh": kh, "D": d,
            "window": window, "route_new": flash_ops.kernel_route(torch.bfloat16, d), **times,
            **bound}


def in_turns(runs: dict, library) -> dict:
    """Mean ms of each version and of the library call: old, new, library,
    library, new, old."""
    t = {"old_ms": [], "new_ms": [], "library_ms": []}
    for key, fn in (("old_ms", runs["old"]), ("new_ms", runs["new"]), ("library_ms", library),
                    ("library_ms", library), ("new_ms", runs["new"]), ("old_ms", runs["old"])):
        t[key].append(chip_smoke.cuda_ms(fn))
    return {key: sum(v) / len(v) for key, v in t.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="root of the other tree (holds src/repro_torch/kernels)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.Card(chip_smoke.card_line())
    with concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = {(kernel, tag): pool.submit(build_lib, tree, rel, tag)
                for kernel, (rel, _) in KERNELS.items()
                for tag, tree in (("old", args.old.resolve()), ("new", ROOT))}
        libs = {key: job.result() for key, job in jobs.items()}
    dq = {tag: libs[("dequant_mix", tag)] for tag in ("old", "new")}
    fl = {tag: libs[("flash_attention", tag)] for tag in ("old", "new")}
    results = [
        ab_dequant(card, dq, "iid_k100_qint8", graph_lib.build_graph("complete", 100), 100),
        ab_dequant(card, dq, "tv_k8_star", graph_lib.build_graph("star", 8), 8),
        ab_flash(card, fl, "main_minitron", 4, 1024, 32, 8, 128),
        ab_flash(card, fl, "long_window4096", 1, 8192, 32, 8, 128, window=4096, seed=2),
        ab_flash(card, fl, "zamba2_d80", 4, 1024, 32, 32, 80, seed=7),
    ]
    for r in results:
        print(json.dumps(r), flush=True)
    print(f"card: {card.line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time two versions of the port's ``consensus_mix``, ``dequant_mix``,
``segment_mix``, ``wkv6``, ``wkv6_bwd``, ``flash_attention``,
``flash_attention_bwd``, ``ssd`` and ``ssd_bwd`` kernels in turns on one
GPU: this checkout's and another tree's (an older commit unpacked beside
it).

Both versions are built from their ``.cu`` sources with the port's nvcc flags
into ``build/kernel_ab/``, called through the C entry points their wrappers
call on the same inputs, held to the plain PyTorch versions at
chip_smoke.py's tolerances, and timed with CUDA events in turns (old, new,
..., library, library, ..., new, old) at the main paths' shapes, beside the
library call and the bound ``launch/roofline.py:kernel_work`` counts:

- ``consensus_mix`` at K = 2, 8 (a ring padded to 3 slots) and 100, and
  on complete graphs of 12 to 32 peers (where its designs cross), each of
  the checkout's two designs (``new_tile_ms``, ``new_gather_ms``) beside
  the old tree's same design (``gossip_identical_bits``: the two versions'
  outputs equal bit for bit) and ``torch.matmul([W; Beta], X)``;
- ``dequant_mix`` at K = 100, 8 and 129, and ``segment_mix`` at K = 100
  complete and on the K = 4096 ring, old against new, each with
  ``gossip_identical_bits``;
- for the three consensus kernels also the mass mode (push-sum,
  ``new_mass_ms``, and ``old_mass_ms`` where the other tree has one) on the
  same inputs with a random positive mass, held to its plain version
  (``consensus_mix``: ``mass_identical_bits``, old and new mass outputs
  equal);
- for ``consensus_mix`` also the snapshot mode (bounded staleness), gossip
  and mass, in the design the wrapper takes, with a published buffer P
  beside x (``new_snapshot_ms``, ``new_snapshot_mass_ms``, and the old
  tree's where it has them), held to its plain version;
- ``wkv6`` at the serving prefill's B 4, T 1024 and at B 1, T 4096
  (float32), with bf16 r, k, v as served (an old tree whose kernel takes
  float32 only is timed as its wrapper ran it, casts included), and at a
  log-decay of -50 a step, each with the largest difference between the
  two versions' outputs;
- ``flash_attention`` at minitron's prefill, its 4096-token window,
  zamba2's D = 80, qwen3-moe's group of 16, internvl2's group of 2, the
  LM round's D = 64 (B 16, S 1024, H 9, Kh 3) and seamless-m4t's D = 64
  encoder (non-causal) and decoder, each with ``identical_bits`` (the two
  versions' outputs equal bit for bit);
- ``flash_attention_bwd`` at the LM round's shape and minitron's, both
  versions' dq, dk and dv held to the plain backward on the forward
  kernel's output and lse, beside SDPA's backward
  (``torch.autograd.grad`` through ``scaled_dot_product_attention``);
- ``ssd`` at zamba2's prefill (B 4, T 1024, H 80, P = N = 64, one group,
  chunk 64) with bf16 x, B and C as served, and in float32 from a zero and
  from a random state, at B 1, T 8192 from a state (float32) and at a
  ragged T 1000 (float32), each with both bounds and the largest
  difference between the two versions' outputs;
- ``ssd_bwd`` at zamba2's trained shape (B 2 = 2 peers x batch 1, T 1024,
  H 80, P = N = 64, one group, bf16 views of the convolution's output, each
  peer's a a row, a state in) and at the served batch of 4, both versions
  through ``ssd_bwd`` (the same C entry in both, each with its own scratch)
  held to the plain backward at chip_smoke.py's checks, each called twice
  (``repeat_identical_bits``: a version's two calls equal bit for bit),
  with the bound ``kernel_work`` counts for the function;
- ``wkv6_bwd`` at rwkv6-7b's trained shape (B 4 = 2 peers x batch 2, T
  1024, H 64, dk 64, bf16 r, k, v and do, each peer's u a row, a state in,
  no final-state gradient) and in float32 with both states, both versions
  through ``wkv6_bwd`` (the same C entry in both, each with its own
  scratch) held to the plain backward at chip_smoke.py's checks, each
  called twice (``repeat_identical_bits``), with the bound ``kernel_work``
  counts for the function.

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/kernel_ab.py --old build/parent [--only ssd]

Prints one JSON object a shape and, last, the card line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
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
from repro_torch.launch.roofline import kernel_work  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.consensus_mix import dequant, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv6_ref  # noqa: E402

KERNELS = {  # name: source below src/repro_torch/kernels
    "consensus_mix": "consensus_mix/csrc/consensus_mix.cu",
    "dequant_mix": "consensus_mix/csrc/dequant_mix.cu",
    "segment_mix": "consensus_mix/csrc/segment_mix.cu",
    "wkv6": "rwkv6/csrc/wkv6.cu",
    "wkv6_bwd": "rwkv6/csrc/wkv6_bwd.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "ssd": "mamba2/csrc/ssd.cu",
    "ssd_bwd": "mamba2/csrc/ssd_bwd.cu",
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
    out = ctypes.CDLL(str(lib))
    out.source_text = src.read_text()  # which form of an entry point this version has
    return out


def push_sum_mass(k: int, dev) -> torch.Tensor:
    """A positive (K,) mass summing to K for the mass-mode runs."""
    return chip_smoke.push_sum_mass(k, 11, dev)


def mass_stats(outs: list, want: tuple, what: str) -> dict:
    """Holds a mass-mode run's outputs to its plain version at chip_smoke's
    tolerance; returns their largest difference."""
    err = 0.0
    for got, ref_out in zip(outs, want):
        torch.testing.assert_close(got, ref_out, **chip_smoke.TOL, msg=lambda m: f"{what}: {m}")
        err = max(err, float((got - ref_out).abs().max()))
    return {"mass_max_abs_err": err}


def dequant_fns(lib: ctypes.CDLL, k: int) -> dict:
    """The entry points this version's wrapper would call at K peers (the
    column-tile one where the library has it and K is within its cap):
    ``gossip`` and, where the library has it, ``mass``."""
    tile = hasattr(lib, "dequant_mix_tile_f32") and dequant.takes_tile_path(k)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    head = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i64, ctypes.c_float,
            ctypes.c_int]
    fns = {"gossip": (lib.dequant_mix_tile_f32 if tile else lib.dequant_mix_f32,
                      head + [ptr] * 4)}
    if hasattr(lib, "dequant_mix_push_sum_f32"):
        fns["mass"] = (lib.dequant_mix_push_sum_tile_f32 if tile else lib.dequant_mix_push_sum_f32,
                       head + [ptr] * 6)
    for fn, argtypes in fns.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {mode: fn for mode, (fn, _) in fns.items()} | {"path": "tile" if tile else "gather"}


def ab_dequant(card, libs: dict, name: str, graph, k: int, seed: int = 0) -> dict:
    """dequant_mix's gossip mode, old against new (outputs compared bit for
    bit), and the new version's mass mode (push-sum) on the same inputs."""
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
    mass = push_sum_mass(k, dev)
    want = ref.dequant_mix_stacked_ref(x, est, q, scale, leaves, *sparse, t)
    starts = (ctypes.c_int64 * (len(leaves) - 1))(*leaves[:-1])
    stream = torch.cuda.current_stream().cuda_stream
    head = lambda: [x.data_ptr(), est.data_ptr(), q.data_ptr(), scale.data_ptr(),  # noqa: E731
                    starts, len(leaves) - 1, k, n, sparse.self_w.data_ptr(),
                    sparse.nbr_idx.data_ptr(), sparse.nbr_w.data_ptr(), sparse.beta.data_ptr(),
                    sparse.nbr_idx.shape[1], float(t), 1]
    runs, paths, outs = {}, {}, {}
    for tag, lib in libs.items():
        fns = dequant_fns(lib, k)
        paths[tag] = fns["path"]
        outs[tag] = [torch.empty_like(x) for _ in range(3)]

        def run(fn=fns["gossip"], o=outs[tag], tag=tag):
            err = fn(*head(), *(t_.data_ptr() for t_ in o), stream)
            chip_smoke.check(err == 0, f"dequant_mix {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        for got, ref_out in zip(outs[tag], want):
            torch.testing.assert_close(got, ref_out, **chip_smoke.TOL)
        runs[tag] = run
    want_mass = ref.dequant_mix_push_sum_stacked_ref(x, est, q, scale, leaves, mass, *sparse, t)
    stats = {}
    for tag, lib in libs.items():
        fns = dequant_fns(lib, k)
        if "mass" not in fns:
            continue
        mass_outs = [torch.empty_like(x) for _ in range(3)] + [torch.empty_like(mass)]

        def run_mass(fn=fns["mass"], o=mass_outs, tag=tag):
            err = fn(*head(), mass.data_ptr(), *(t_.data_ptr() for t_ in o), stream)
            chip_smoke.check(err == 0, f"dequant_mix {tag} mass launch: cudaError_t {err}")

        run_mass()
        torch.cuda.synchronize()
        stats |= {f"{tag}_{key}": v for key, v in mass_stats(
            mass_outs, want_mass, f"dequant_mix {tag} {name} mass mode").items()}
        runs[f"{tag}_mass"] = run_mass
    identical = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
    dense = ref.dense_mix_operator(sparse.nbr_idx, sparse.nbr_w, sparse.beta)
    lib_out = torch.empty(2 * k, n, device=dev)
    times = in_turns(runs, lambda: torch.matmul(dense, want[2], out=lib_out))
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    work = kernel_work("dequant_mix", k=k, n=n, d=sparse.nbr_idx.shape[1], real=real,
                       leaves=len(leaves) - 1)
    return {"kernel": "dequant_mix", "case": name, "K": k, "N": n, "paths": paths,
            "gossip_identical_bits": identical, **stats, **times, **card.work_bound(work)}


def consensus_fns(lib: ctypes.CDLL) -> dict:
    """The consensus_mix entry points a library has: ``gather`` (every
    version), ``tile`` (from the column-tile design on), their mass modes
    ``mass_gather`` / ``mass_tile`` (from push-sum on) and the snapshot
    modes ``snap_*`` / ``mass_snap_*`` (from bounded staleness on, the
    published buffer after x), each called with the full launch's
    arguments (a library with row ranges gets the full range)."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    names = {"gather": "consensus_mix_f32", "tile": "consensus_mix_tile_f32",
             "mass_gather": "consensus_mix_push_sum_f32",
             "mass_tile": "consensus_mix_push_sum_tile_f32",
             "snap_gather": "consensus_mix_snapshot_f32",
             "snap_tile": "consensus_mix_snapshot_tile_f32",
             "mass_snap_gather": "consensus_mix_push_sum_snapshot_f32",
             "mass_snap_tile": "consensus_mix_push_sum_snapshot_tile_f32"}
    fns = {key: getattr(lib, name) for key, name in names.items() if hasattr(lib, name)}
    # from the sharded runtime on, every entry point takes a row range
    # (row0, rows) after n; the full launch is (0, num_peers)
    rows = hasattr(lib, "consensus_mix_row_range_abi")
    for key, fn in fns.items():
        fn.argtypes = [ptr, *([ptr] if "snap" in key else []), i64, i64,
                       *([i64, i64] if rows else []), ptr, ptr, ptr, ptr,
                       i64, ctypes.c_float, *([ptr] * (5 if key.startswith("mass") else 3))]
        fn.restype = ctypes.c_int
    if rows:
        def full_launch(fn, lead):
            return lambda *args: fn(*args[:lead + 2], 0, args[lead], *args[lead + 2:])

        fns = {key: full_launch(fn, 2 if "snap" in key else 1) for key, fn in fns.items()}
    return fns


def ab_consensus(card, libs: dict, name: str, graph, sizes, n: int, *, dmax=None,
                 seed=0) -> dict:
    """consensus_mix: each design of the old tree against the same design of
    this checkout (outputs compared bit for bit), and each tree's mass mode
    (push-sum, bit for bit too) and snapshot modes (bounded staleness, gossip
    and mass) in the design the wrapper's rule (``ops.takes_tile_path``)
    takes, on the same inputs."""
    dev = torch.device("cuda")
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    k, d = sparse.nbr_idx.shape
    t = 10
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    pub = x + torch.as_tensor(0.05 * rng.normal(size=(k, n)).astype(np.float32), device=dev)
    mass = push_sum_mass(k, dev)
    want = ref.consensus_mix_stacked_ref(x, *sparse, t)
    stream = torch.cuda.current_stream().cuda_stream
    rule = "tile" if ops.takes_tile_path(k) else "gather"
    old, new = consensus_fns(libs["old"]), consensus_fns(libs["new"])
    fns = {f"old_{design}": old[design] for design in ("gather", "tile") if design in old}
    fns |= {f"new_{design}": new[design] for design in ("gather", "tile")}
    for mode in ("mass", "snapshot", "snapshot_mass"):
        key = {"mass": "mass", "snapshot": "snap", "snapshot_mass": "mass_snap"}[mode]
        fns |= {f"{tag}_{mode}": lib[f"{key}_{rule}"] for tag, lib in (("old", old), ("new", new))
                if f"{key}_{rule}" in lib}
    head = [k, n, sparse.self_w.data_ptr(), sparse.nbr_idx.data_ptr(),
            sparse.nbr_w.data_ptr(), sparse.beta.data_ptr(), d, float(t)]
    runs, outs = {}, {}
    for tag, fn in fns.items():
        outs[tag] = [torch.empty_like(x) for _ in range(2)]
        tail = [o.data_ptr() for o in outs[tag]]
        if tag.endswith("_mass"):
            outs[tag].append(torch.empty_like(mass))
            tail = [mass.data_ptr(), *(o.data_ptr() for o in outs[tag])]
        lead = [x.data_ptr(), pub.data_ptr()] if "_snapshot" in tag else [x.data_ptr()]

        def run(fn=fn, lead=lead, tail=tail, tag=tag):
            err = fn(*lead, *head, *tail, stream)
            chip_smoke.check(err == 0, f"consensus_mix {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        if not tag.endswith("_mass") and "_snapshot" not in tag:
            for got, ref_out in zip(outs[tag], want):
                torch.testing.assert_close(got, ref_out, **chip_smoke.TOL)
        runs[tag] = run
    stats = {}
    for mode, want_mode in (
            ("mass", ref.consensus_mix_push_sum_stacked_ref(x, mass, *sparse, t)),
            ("snapshot", ref.consensus_mix_stacked_ref(x, *sparse, t, published=pub)),
            ("snapshot_mass", ref.consensus_mix_push_sum_stacked_ref(x, mass, *sparse, t,
                                                                     published=pub))):
        for tag in (f"old_{mode}", f"new_{mode}"):
            if tag in outs:
                stats |= {f"{tag}_{key.removeprefix('mass_')}": v for key, v in mass_stats(
                    outs[tag], want_mode, f"consensus_mix {tag} {name}").items()}
    identical = {design: all(torch.equal(a, b) for a, b in
                             zip(outs[f"old_{design}"], outs[f"new_{design}"]))
                 for design in ("gather", "tile", "mass") if f"old_{design}" in outs}
    if "mass" in identical:
        stats["mass_identical_bits"] = identical.pop("mass")
    dense = torch.as_tensor(np.concatenate([w, beta]), dtype=torch.float32, device=dev)
    lib_out = torch.empty(2 * k, n, device=dev)
    times = in_turns(runs, lambda: torch.matmul(dense, x, out=lib_out))
    times["new_ms"] = times[f"new_{rule}_ms"]  # the design the wrapper takes at this K
    if f"old_{rule}_ms" in times:
        times["old_ms"] = times[f"old_{rule}_ms"]
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    work = kernel_work("consensus_mix", k=k, n=n, d=d, real=real)
    return {"kernel": "consensus_mix", "case": name, "K": k, "D": d, "N": n, "rule": rule,
            "gossip_identical_bits": identical, **stats, **times, **card.work_bound(work)}


def segment_fns(lib: ctypes.CDLL) -> dict:
    """segment_mix's entry points: ``gossip`` and, from push-sum on, ``mass``."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    head = [ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_float]
    fns = {"gossip": (lib.segment_mix_f32, head + [ptr] * 3)}
    if hasattr(lib, "segment_mix_push_sum_f32"):
        fns["mass"] = (lib.segment_mix_push_sum_f32, head + [ptr] * 5)
    for fn, argtypes in fns.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {mode: fn for mode, (fn, _) in fns.items()}


def ab_segment(card, libs: dict, name: str, topology: str, k: int, sizes, seed=0) -> dict:
    """segment_mix's gossip mode, old against new (outputs compared bit for
    bit), and the new version's mass mode on the same inputs and operands,
    at the 2NN's row."""
    dev = torch.device("cuda")
    layout = layout_of("mnist_mlp")
    n, t = layout.row, 10
    sched = graph_lib.static_schedule(graph_lib.build_graph(topology, k))
    sparse = graph_lib.SparseSchedule.from_schedule(sched, "data_weighted", data_sizes=sizes)
    ops_s = ops.upload_schedule(sparse, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :layout.size] = torch.randn(k, layout.size, generator=gen, device=dev)
    mass = push_sum_mass(k, dev)
    stream = torch.cuda.current_stream().cuda_stream
    head = [x.data_ptr(), k, n, ops_s.self_w.data_ptr(), ops_s.nbr_idx.data_ptr(),
            ops_s.nbr_w.data_ptr(), ops_s.beta.data_ptr(), 1, 0, sparse.degree_bound, float(t)]
    runs, outs = {}, {}
    for tag, lib in libs.items():
        outs[tag] = [torch.empty_like(x) for _ in range(2)]

        def run(fn=segment_fns(lib)["gossip"], o=outs[tag], tag=tag):
            err = fn(*head, *(t_.data_ptr() for t_ in o), stream)
            chip_smoke.check(err == 0, f"segment_mix {tag} launch: cudaError_t {err}")

        run()
        runs[tag] = run
    torch.cuda.synchronize()
    one = ops.select_round(ops_s, 0)
    want = ref.segment_mix_stacked_ref(x, *one, t)
    for got, ref_out in zip(outs["new"], want):
        torch.testing.assert_close(got, ref_out, **chip_smoke.TOL)
    del want
    identical = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
    del outs["old"]
    want_mass = ref.segment_mix_push_sum_stacked_ref(x, mass, *one, t)
    mass_outs = outs["new"] + [torch.empty_like(mass)]  # the gossip runs' buffers, reused
    stats = {}
    for tag, lib in libs.items():
        fns = segment_fns(lib)
        if "mass" not in fns:
            continue

        def run_mass(fn=fns["mass"], tag=tag):
            err = fn(*head, mass.data_ptr(), *(t_.data_ptr() for t_ in mass_outs), stream)
            chip_smoke.check(err == 0, f"segment_mix {tag} mass launch: cudaError_t {err}")

        run_mass()
        torch.cuda.synchronize()
        stats |= {f"{tag}_{key}": v for key, v in mass_stats(
            mass_outs, want_mass, f"segment_mix {tag} {name} mass mode").items()}
        runs[f"{tag}_mass"] = run_mass
    del want_mass
    as_csr = k > 1000
    lib_op = chip_smoke.library_operator(sparse, 0, dev, as_csr=as_csr)
    library = ((lambda: torch.sparse.mm(lib_op, x)) if as_csr  # noqa: E731
               else (lambda: torch.matmul(lib_op, x)))
    times = in_turns(runs, library)
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    work = kernel_work("segment_mix", k=k, n=n, d=sparse.degree_bound, real=real)
    out = {"kernel": "segment_mix", "case": name, "K": k, "D": sparse.degree_bound, "N": n,
           "gossip_identical_bits": identical, **stats, **times, **card.work_bound(work)}
    del x, mass_outs, lib_op
    torch.cuda.empty_cache()
    return out


def ab_wkv6(card, libs: dict, name: str, b, t, h, dk, q, *, dtype=torch.float32, ld=None,
            seed=0) -> dict:
    """wkv6 from a zero state, the old tree's kernel against this checkout's.
    An old tree with the float32-only entry (``wkv6_f32``) is timed as its
    wrapper ran it: with bf16 operands, casts to float32 and of the output
    back included.  ``ld`` is a constant log-decay (else a uniform draw in
    [-4, -0.01]); ``max_abs_diff_old`` is the largest difference between the
    two versions' outputs."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype) for _ in range(3))
    if ld is None:
        ld = -(0.01 + 3.99 * torch.rand(b, t, h, dk, generator=gen, device=dev))
    else:
        ld = torch.full((b, t, h, dk), ld, device=dev)
    u = 0.5 * torch.randn(h, dk, generator=gen, device=dev)
    want, want_s = wkv6_ref.wkv6_chunked_ref(r, k, v, ld, u, None, chunk=q)
    stream = torch.cuda.current_stream().cuda_stream
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    bf16 = dtype == torch.bfloat16
    tol = chip_smoke.WKV6_BF16_TOL if bf16 else chip_smoke.WKV6_TOL
    final = torch.empty(b, h, dk, dk, device=dev)
    outs = {tag: torch.empty(b, t, h, dk, dtype=dtype, device=dev) for tag in libs}

    def run_for(tag: str, lib: ctypes.CDLL):
        out = outs[tag]
        if hasattr(lib, "wkv6_fwd"):
            fn = lib.wkv6_fwd
            # a version whose u may hold a row per group of batch elements
            # takes their count after the chunk (B: one u for the batch)
            rows = (b,) if "u_batch" in lib.source_text else ()
            fn.argtypes = [ptr] * 8 + [i64] * (5 + len(rows)) + [ctypes.c_int, ptr]
            fn.restype = ctypes.c_int

            def run():
                err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), ld.data_ptr(), u.data_ptr(),
                         None, out.data_ptr(), final.data_ptr(), b, t, h, dk, q, *rows,
                         int(bf16), stream)
                chip_smoke.check(err == 0, f"wkv6 {tag} launch: cudaError_t {err}")
            return run
        fn = lib.wkv6_f32
        fn.argtypes, fn.restype = [ptr] * 8 + [i64] * 5 + [ptr], ctypes.c_int
        out_f32 = torch.empty(b, t, h, dk, device=dev)

        def run_f32():
            rf, kf, vf = (x.float() for x in (r, k, v))  # no copy for float32 operands
            err = fn(rf.data_ptr(), kf.data_ptr(), vf.data_ptr(), ld.data_ptr(), u.data_ptr(),
                     None, out_f32.data_ptr(), final.data_ptr(), b, t, h, dk, q, stream)
            chip_smoke.check(err == 0, f"wkv6 {tag} launch: cudaError_t {err}")
            out.copy_(out_f32)  # the old wrapper's cast to the output's type
        return run_f32

    runs, errs = {}, {}
    for tag, lib in libs.items():
        runs[tag] = run_for(tag, lib)
        runs[tag]()
        torch.cuda.synchronize()
        torch.testing.assert_close(outs[tag].float(), want, **tol,
                                   msg=lambda m: f"wkv6 {tag} {name}: {m}")
        torch.testing.assert_close(final, want_s, **chip_smoke.WKV6_TOL,
                                   msg=lambda m: f"wkv6 {tag} {name} state: {m}")
        errs[tag] = float((outs[tag].float() - want).abs().max())
    diff = float((outs["new"].float() - outs["old"].float()).abs().max())
    times = in_turns(runs, None)
    es = r.element_size()
    bound = card.work_bound(kernel_work("wkv6", b=b, t=t, h=h, dk=dk, q=q, state=False,
                                        in_bytes=es, out_bytes=es))
    return {"kernel": "wkv6", "case": name, "B": b, "T": t, "H": h, "dk": dk, "chunk": q,
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": errs,
            "max_abs_diff_old": diff, **times, **bound}


def ab_flash(card, libs: dict, name: str, b, s, h, kh, d, *, causal=True, window=None,
             seed=0) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    want = flash_ref.gqa_attention_ref(q, k, v, causal=causal, window=window)
    stream = torch.cuda.current_stream().cuda_stream
    runs, outs = {}, {}
    for tag, lib in libs.items():
        fn = lib.flash_attention_fwd
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ptr] * 4 + [i64] * 6 + [ctypes.POINTER(i64), i64, i64, ctypes.c_double,
                                               ptr]
        fn.restype = ctypes.c_int
        out = outs[tag] = torch.empty_like(q)
        strides = (ctypes.c_int64 * 12)(*(st for x in (q, k, v, out) for st in x.stride()[:3]))

        def run(fn=fn, out=out, strides=strides):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, s, h, kh, d,
                     strides, int(causal), window or 0, d**-0.5, stream)
            chip_smoke.check(err == 0, f"flash_attention {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        chip_smoke.check_flash(out, want, f"flash {tag} {name}")
        runs[tag] = run
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        library = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
    else:
        mask = chip_smoke.visible_mask(s, causal=causal, window=window, device=dev)
        library = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    times = in_turns(runs, library)
    bound = card.work_bound(kernel_work("flash_attention", b=b, s=s, h=h, kh=kh, d=d,
                                        causal=causal, window=window, elem_bytes=2))
    return {"kernel": "flash_attention", "case": name, "B": b, "S": s, "H": h, "Kh": kh, "D": d,
            "causal": causal, "window": window,
            "route_new": flash_ops.kernel_route(torch.bfloat16, d),
            "identical_bits": torch.equal(outs["old"], outs["new"]), **times, **bound}


def ab_flash_bwd(card, libs: dict, name: str, b, s, h, kh, d, *, seed=0) -> dict:
    """The backward (causal, bf16) of both versions through
    ``flash_attention_bwd`` (the same C entry in both) on the forward
    kernel's output and lse, each held to the plain backward at
    chip_smoke.py's tolerances, timed in turns beside SDPA's backward."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    dout = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    scale = d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    flash_ops.launch(q, k, v, out, causal=True, window=None, scale=scale, lse=lse)
    want = flash_ref.gqa_attention_bwd_ref(q, k, v, out, dout, lse, causal=True, window=None,
                                           scale=scale)
    stream = torch.cuda.current_stream().cuda_stream
    strides = (ctypes.c_int64 * 15)(*(st for x in (q, k, v, out, dout) for st in x.stride()[:3]))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    runs, grads, errs = {}, {}, {}
    for tag, lib in libs.items():
        fn = lib.flash_attention_bwd
        fn.argtypes = [ptr] * 10 + [i64] * 6 + [ctypes.POINTER(i64), i64, i64, ctypes.c_double,
                                                ptr]
        fn.restype = ctypes.c_int
        g = grads[tag] = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        # this tree's scratch (delta and the scaled lse, padded) holds the
        # older one's (B, H, S) delta
        delta = flash_ops.bwd_scratch(b, h, s, dev)

        def run(fn=fn, g=g, delta=delta, tag=tag):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), g[0].data_ptr(), g[1].data_ptr(),
                     g[2].data_ptr(), 1, b, s, h, kh, d, strides, 1, 0, scale, stream)
            chip_smoke.check(err == 0, f"flash_attention_bwd {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        errs[tag] = {}
        for got, w, what in zip(g, want, ("dq", "dk", "dv")):
            torch.testing.assert_close(got.float(), w.float(), **chip_smoke.FLASH_BWD_BF16_TOL,
                                       msg=lambda m: f"flash_bwd {tag} {name} {what}: {m}")
            rel = chip_smoke.rel_norm(got, w)
            chip_smoke.check(rel < chip_smoke.FLASH_BWD_REL_NORM[torch.bfloat16],
                             f"flash_bwd {tag} {name} {what}: relative norm error {rel}")
            errs[tag][what] = {"max_abs_err": float((got.float() - w.float()).abs().max()),
                               "rel_norm_err": rel}
        runs[tag] = run
    del want
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    library = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,  # noqa: E731
                                          retain_graph=True)
    times = in_turns(runs, library)
    bound = card.work_bound(kernel_work("flash_attention_bwd", b=b, s=s, h=h, kh=kh, d=d,
                                        causal=True, window=None, elem_bytes=2))
    return {"kernel": "flash_attention_bwd", "case": name, "B": b, "S": s, "H": h, "Kh": kh,
            "D": d, "causal": True, "route_new": flash_ops.bwd_kernel_route(torch.bfloat16, d),
            "errors": errs, **times, **bound}


def ab_ssd(card, libs: dict, name: str, b, t, h, *, dtype=torch.float32, state=False,
           dt_range=(0.01, 1.0), seed=0) -> dict:
    """ssd at P = N = 64, one B/C group, chunk 64, both versions through
    ``ssd_fwd`` (the same C entry in both) on chip_smoke.py's draws, each
    held to the plain version at chip_smoke.py's tolerance and relative norm
    error; ``max_abs_diff_old`` is the largest difference between the two
    versions' outputs (y and final state)."""
    p = n = q = 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    bm, cm = (torch.randn(b, t, 1, n, generator=gen, device=dev).to(dtype) for _ in range(2))
    low, high = dt_range
    dt = low + (high - low) * torch.rand(b, t, h, generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand(h, generator=gen, device=dev))
    s0 = torch.randn(b, h, p, n, generator=gen, device=dev) if state else None
    want = ssd_ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=q)
    strides = (ctypes.c_int64 * 6)(*(st for m in (x, bm, cm) for st in m.stride()[:2]))
    stream = torch.cuda.current_stream().cuda_stream
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    outs = {tag: (torch.empty(b, t, h, p, device=dev), torch.empty(b, h, p, n, device=dev))
            for tag in libs}
    runs, errs = {}, {}
    for tag, lib in libs.items():
        fn = lib.ssd_fwd
        # a version whose a may hold a row per group of batch elements takes
        # their count after the chunk (B: one a for the batch)
        rows = (b,) if "a_batch" in lib.source_text else ()
        fn.argtypes = [ptr] * 8 + [i64] * (8 + len(rows)) + [ctypes.POINTER(i64), ptr]
        fn.restype = ctypes.c_int

        def run(fn=fn, tag=tag, rows=rows):
            y, final = outs[tag]
            err = fn(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a.data_ptr(),
                     None if s0 is None else s0.data_ptr(), y.data_ptr(), final.data_ptr(),
                     ssd_ops.DTYPE_CODES[dtype], b, t, h, 1, p, n, q, *rows, strides, stream)
            chip_smoke.check(err == 0, f"ssd {tag} launch: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        errs[tag] = chip_smoke._compare_ssd((x, bm, cm, dt), {}, outs[tag], want,
                                            f"ssd {tag} {name}")
        runs[tag] = run
    diff = max(float((outs["new"][i] - outs["old"][i]).abs().max()) for i in range(2))
    times = in_turns(runs, None)
    bounds = card.work_bound(kernel_work("ssd", b=b, t=t, h=h, g=1, p=p, n=n, q=q, state=state,
                                         in_bytes=x.element_size()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"kernel": "ssd", "case": name, "B": b, "T": t, "H": h, "P": p, "N": n, "chunk": q,
            "dtype": str(dtype).removeprefix("torch."), "state": state,
            "route_new": ssd_ops.kernel_route(dtype),
            "split_new": ssd_ops.kernel_split(b * h, p, dtype, sms),
            "errors": {tag: {key: e[key] for key in ("y_max_abs_err", "y_rel_norm_err",
                                                    "state_max_abs_err", "state_rel_norm_err")}
                       for tag, e in errs.items()},
            "max_abs_diff_old": diff, **times, **bounds}


def ssd_bwd_scratch(lib: ctypes.CDLL, b, t, h, p, n, dev) -> tuple:
    """The float32 scratch a version's ``ssd_bwd`` takes: the chunked form's
    (this tree's ``ops.bwd_scratch``), or the earlier token loop's ((B, H)
    partials of da and the state at every 16-token chunk's end but the
    last)."""
    if "chunk_states" in lib.source_text:
        return ssd_ops.bwd_scratch(b, t, h, p, n, dev)
    ends = -(-t // 16) - 1
    return (torch.empty((b, t, h, n), device=dev), torch.empty((b, t, h, n), device=dev),
            torch.empty((b, h), device=dev), torch.empty(max(b * h * ends * p * n, 1), device=dev))


def ab_ssd_bwd(card, libs: dict, name: str, b, t, h, *, a_rows=1, seed=0) -> dict:
    """The ssd backward at P = N = 64, one B/C group, bf16 x, B and C as
    views of one (B, T, H P + 2 N) buffer (the model's convolution output), a
    state in and no final-state gradient (as the LM round calls it), both
    versions through ``ssd_bwd``, each held to the plain backward at
    chip_smoke.py's checks and called twice, timed in turns."""
    p = n = 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.randn(b, t, h * p + 2 * n, generator=gen, device=dev).to(torch.bfloat16)
    x = conv[..., :h * p].unflatten(-1, (h, p))
    bm = conv[..., h * p:h * p + n].unflatten(-1, (1, n))
    cm = conv[..., h * p + n:].unflatten(-1, (1, n))
    dt = 0.01 + 0.99 * torch.rand(b, t, h, generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand(*((a_rows,) if a_rows > 1 else ()), h, generator=gen,
                                 device=dev))
    dy = torch.randn(b, t, h, p, generator=gen, device=dev)
    s0 = torch.randn(b, h, p, n, generator=gen, device=dev)
    want = ssd_ref.ssd_bwd_ref(x, bm, cm, dt, a, s0, dy, None)
    strides = (ctypes.c_int64 * 6)(*(st for m in (x, bm, cm) for st in m.stride()[:2]))
    stream = torch.cuda.current_stream().cuda_stream
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    runs, outs, checks = {}, {}, {}
    for tag, lib in libs.items():
        fn = lib.ssd_bwd
        fn.argtypes = [ptr] * 18 + [i64] * 8 + [ctypes.POINTER(i64), ptr]
        fn.restype = ctypes.c_int
        scratch = ssd_bwd_scratch(lib, b, t, h, p, n, dev)

        def grads():  # contiguous, in the operands' types
            return (*(torch.empty(m.shape, dtype=m.dtype, device=dev) for m in (x, bm, cm)),
                    torch.empty_like(dt), torch.empty_like(a), torch.empty_like(s0))

        def run(fn=fn, tag=tag, scratch=scratch, out=None):
            g = outs.setdefault(tag, grads()) if out is None else out
            err = fn(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a.data_ptr(),
                     s0.data_ptr(), dy.data_ptr(), None, *(m.data_ptr() for m in g[:5]),
                     *(m.data_ptr() for m in scratch), g[5].data_ptr(), 1, b, t, h, 1, p, n,
                     ssd_ops.a_batch(a, b), strides, stream)
            chip_smoke.check(err == 0, f"ssd_bwd {tag} launch: cudaError_t {err}")

        run()
        again = grads()
        run(out=again)
        torch.cuda.synchronize()
        checks[tag] = chip_smoke.check_bwd(f"ssd_bwd {tag}", name,
                                           ("x", "b", "c", "dt", "a", "state"), outs[tag],
                                           again, want, extreme=False)
        runs[tag] = run
    identical = all(torch.equal(u, v) for u, v in zip(outs["old"], outs["new"]))
    times = in_turns(runs, None)
    bounds = card.work_bound(kernel_work("ssd_bwd", b=b, t=t, h=h, g=1, p=p, n=n, in_bytes=2,
                                         a_rows=a_rows, state=True, dstate=False))
    return {"kernel": "ssd_bwd", "case": name, "B": b, "T": t, "H": h, "P": p, "N": n,
            "a_rows": a_rows, "dtype": "bfloat16", "repeat_identical_bits": True,
            "old_new_identical_bits": identical,
            "rel_norm_err": {tag: c["rel_norm_err_by_grad"] for tag, c in checks.items()},
            **times, **bounds}


def ab_wkv6_bwd(card, libs: dict, name: str, b, t, h, dk, *, dtype=torch.bfloat16, u_rows=1,
                dstate=False, ld=None, seed=0) -> dict:
    """The wkv6 backward of both versions through ``wkv6_bwd`` on the same
    inputs (chip_smoke.py's draws: r, k, v and do in ``dtype``, u of
    ``u_rows`` rows, a state in, a final-state gradient with ``dstate``,
    log-decays uniform in -``ld``), each held to the plain backward at
    chip_smoke.py's checks and called twice, timed in turns.  The chunked
    version takes ``ops.bwd_scratch``, the token loop a (B, H, dk) scratch of
    du's partials."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v, dout = (torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype)
                     for _ in range(4))
    low, high = ld or (0.01, 4.0)
    logd = -(low + (high - low) * torch.rand(b, t, h, dk, generator=gen, device=dev))
    u = 0.5 * torch.randn(*((u_rows,) if u_rows > 1 else ()), h, dk, generator=gen, device=dev)
    s0 = torch.randn(b, h, dk, dk, generator=gen, device=dev)
    ds = torch.randn(b, h, dk, dk, generator=gen, device=dev) if dstate else None
    want = wkv6_ref.wkv6_bwd_ref(r, k, v, logd, u, s0, dout, ds)
    stream = torch.cuda.current_stream().cuda_stream
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    runs, outs, checks = {}, {}, {}
    for tag, lib in libs.items():
        fn = lib.wkv6_bwd
        fn.argtypes = [ptr] * 15 + [i64] * 5 + [ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        scratch = (wkv6_ops.bwd_scratch(b, t, h, dk, dev) if "wkv6_bwd_chunk" in lib.source_text
                   else torch.empty(b, h, dk, device=dev))

        def grads():  # in the operands' types
            return (*(torch.empty_like(x) for x in (r, k, v, logd, u, s0)),)

        def run(fn=fn, tag=tag, scratch=scratch, out=None):
            g = outs.setdefault(tag, grads()) if out is None else out
            err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logd.data_ptr(), u.data_ptr(),
                     s0.data_ptr(), dout.data_ptr(), None if ds is None else ds.data_ptr(),
                     *(x.data_ptr() for x in g[:5]), scratch.data_ptr(), g[5].data_ptr(),
                     b, t, h, dk, wkv6_ops.u_batch(u, b), int(dtype == torch.bfloat16), stream)
            chip_smoke.check(err == 0, f"wkv6_bwd {tag} launch: cudaError_t {err}")

        run()
        again = grads()
        run(out=again)
        torch.cuda.synchronize()
        checks[tag] = chip_smoke.check_bwd(f"wkv6_bwd {tag}", name,
                                           ("r", "k", "v", "logdecay", "u", "state"), outs[tag],
                                           again, want, extreme=False)
        runs[tag] = run
    identical = all(torch.equal(x, y) for x, y in zip(outs["old"], outs["new"]))
    times = in_turns(runs, None)
    by_kernel = {tag: device_us_by_kernel(run) for tag, run in runs.items()}
    bounds = card.work_bound(kernel_work("wkv6_bwd", b=b, t=t, h=h, dk=dk,
                                         in_bytes=r.element_size(), u_rows=u_rows, state=True,
                                         dstate=dstate))
    return {"kernel": "wkv6_bwd", "case": name, "B": b, "T": t, "H": h, "dk": dk,
            "u_rows": u_rows, "dstate": dstate, "dtype": str(dtype).removeprefix("torch."),
            "repeat_identical_bits": True, "old_new_identical_bits": identical,
            "rel_norm_err": {tag: c["rel_norm_err_by_grad"] for tag, c in checks.items()},
            "device_us_by_kernel": by_kernel, **times, **bounds}


def device_us_by_kernel(fn, calls: int = 10) -> dict:
    """Mean device microseconds a call of each kernel ``fn`` launches, by
    torch.profiler over ``calls`` calls after a warm-up one (the kernel's
    name up to its template arguments)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            found = re.search(r"(\w+)\s*[<(]", e.key.replace("(anonymous namespace)", ""))
            name = found.group(1) if found else e.key
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out


def in_turns(runs: dict, library) -> dict:
    """Mean ms of each version (``<tag>_ms``) and of the library call
    (``library_ms``, None without one), in turns: each version in order,
    the library call twice, each version in reverse order."""
    order = [*runs.items(), ("library", library), ("library", library),
             *reversed(runs.items())]
    t: dict[str, list] = {}
    for tag, fn in order:
        if fn is not None:
            t.setdefault(f"{tag}_ms", []).append(chip_smoke.cuda_ms(fn))
    return {"library_ms": None} | {key: sum(v) / len(v) for key, v in t.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="root of the other tree (holds src/repro_torch/kernels)")
    parser.add_argument("--only", nargs="*", choices=sorted(KERNELS), default=sorted(KERNELS),
                        help="the kernels to time (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.Card(chip_smoke.card_line())
    with concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = {(kernel, tag): pool.submit(build_lib, tree, KERNELS[kernel], tag)
                for kernel in args.only
                for tag, tree in (("old", args.old.resolve()), ("new", ROOT))}
        libs = {key: job.result() for key, job in jobs.items()}
    pick = lambda kernel: {tag: libs[(kernel, tag)] for tag in ("old", "new")}  # noqa: E731
    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    row = layout_of("mnist_mlp").row
    cases = {
        "consensus_mix": lambda libs: [
            ab_consensus(card, libs, "iid_k100", complete(100), np.full(100, 600), row),
            ab_consensus(card, libs, "noniid_k2", complete(2), np.full(2, 100), row),
            ab_consensus(card, libs, "ring_k8_padded", graph_lib.build_graph("ring", 8),
                         np.arange(1, 9) * 10, row, dmax=3),
            # where the two designs cross: the rule's lower bound
            *(ab_consensus(card, libs, f"complete_k{k}", complete(k), np.full(k, 600), row)
              for k in (12, 16, 24, 32))],
        "dequant_mix": lambda libs: [
            ab_dequant(card, libs, "iid_k100_qint8", complete(100), 100),
            ab_dequant(card, libs, "tv_k8_star", graph_lib.build_graph("star", 8), 8),
            ab_dequant(card, libs, "gather_k129_qint8", complete(129), 129)],
        "segment_mix": lambda libs: [
            ab_segment(card, libs, "iid_k100", "complete", 100, np.full(100, 600)),
            ab_segment(card, libs, "ring_k4096", "ring", chip_smoke.LARGE_K,
                       np.where(np.arange(chip_smoke.LARGE_K) < 60000 % chip_smoke.LARGE_K,
                                15, 14), seed=1)],
        "wkv6": lambda libs: [
            ab_wkv6(card, libs, "main_b4_t1024", 4, 1024, 64, 64, 16),
            ab_wkv6(card, libs, "b1_t4096", 1, 4096, 64, 64, 16, seed=5),
            ab_wkv6(card, libs, "main_b4_t1024_bf16", 4, 1024, 64, 64, 16,
                    dtype=torch.bfloat16, seed=7),
            ab_wkv6(card, libs, "extreme_decay", 4, 1024, 64, 64, 16, ld=-50.0, seed=3)],
        # chip_smoke.py's timed wkv6_bwd cases and draws
        "wkv6_bwd": lambda libs: [
            ab_wkv6_bwd(card, libs, "trained_k2_b2_t1024_bf16", 4, 1024, 64, 64, u_rows=2,
                        seed=31),
            ab_wkv6_bwd(card, libs, "b4_t1024_state_dstate_f32", 4, 1024, 64, 64,
                        dtype=torch.float32, dstate=True, ld=(1e-4, 2e-3), seed=32)],
        # chip_smoke.py's timed flash cases and draws
        "flash_attention": lambda libs: [
            ab_flash(card, libs, "main_minitron", 4, 1024, 32, 8, 128),
            ab_flash(card, libs, "long_window4096", 1, 8192, 32, 8, 128, window=4096, seed=2),
            ab_flash(card, libs, "zamba2_d80", 4, 1024, 32, 32, 80, seed=7),
            ab_flash(card, libs, "qwen3moe_group16", 4, 1024, 64, 4, 128, seed=19),
            ab_flash(card, libs, "internvl2_group2", 4, 1024, 16, 8, 128, seed=20),
            ab_flash(card, libs, "lm_smollm_k4", 16, 1024, 9, 3, 64, seed=23),
            ab_flash(card, libs, "seamless_encoder_noncausal", 4, 256, 16, 16, 64, causal=False,
                     seed=21),
            ab_flash(card, libs, "seamless_decoder", 4, 768, 16, 16, 64, seed=22)],
        "flash_attention_bwd": lambda libs: [
            ab_flash_bwd(card, libs, "lm_smollm_k4", 16, 1024, 9, 3, 64),
            ab_flash_bwd(card, libs, "minitron", 4, 1024, 32, 8, 128, seed=1)],
        # chip_smoke.py's ssd cases and draws
        "ssd": lambda libs: [
            ab_ssd(card, libs, "main_b4_t1024_bf16", 4, 1024, 80, dtype=torch.bfloat16, seed=2),
            ab_ssd(card, libs, "main_b4_t1024", 4, 1024, 80),
            ab_ssd(card, libs, "main_b4_t1024_state", 4, 1024, 80, state=True,
                   dt_range=(1e-4, 2e-3), seed=1),
            ab_ssd(card, libs, "b1_t8192", 1, 8192, 80, state=True, dt_range=(1e-5, 2e-4),
                   seed=6),
            ab_ssd(card, libs, "ragged_t1000", 4, 1000, 80, state=True, dt_range=(1e-4, 2e-3),
                   seed=3)],
        # chip_smoke.py's timed ssd_bwd shapes: the LM round's and the served batch
        "ssd_bwd": lambda libs: [
            ab_ssd_bwd(card, libs, "trained_k2_b1_t1024_bf16", 2, 1024, 80, a_rows=2, seed=41),
            ab_ssd_bwd(card, libs, "served_b4_t1024_bf16", 4, 1024, 80, seed=42)],
    }
    for kernel in args.only:
        for result in cases[kernel](pick(kernel)):
            print(json.dumps(result), flush=True)
        torch.cuda.empty_cache()
    print(f"card: {card.line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

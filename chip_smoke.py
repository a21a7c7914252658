#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

In order:
1. prints the card's name and power limit, the torch version and the TF32
   flags (set off: the reference mixes at full float32 precision), and takes
   the card's peak memory rate and float32 rate from its name;
2. builds every kernel of the port's main paths from this checkout's sources,
   one nvcc per source, all started together;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (atol 5e-5 / rtol 1e-4) and times kernel, plain
   version and one PyTorch library call in turns with CUDA events:
   ``consensus_mix`` at three shapes, ``dequant_mix`` at four (the vector
   path at K=100, a padded star round, and the scalar path with odd leaf
   boundaries, a zero beta row, a zero-scale leaf and a no-payload call),
   ``segment_mix`` at five (K=100 complete, K=4096 ring, a padded star with
   a zero beta row and ragged N on the scalar path, round 17 of a stacked
   R=16 link-dropout schedule, and D=2047 slots staged in chunks);
4. drives the trainer through ``run_paper_experiment``: uncompressed
   ``noniid_affinity`` (5 rounds) and ``iid_k100`` (2), then compressed
   ``timevarying_k8`` round robin with qint8 (5) and with top-k (3),
   ``iid_k100`` with qint8 (2), and ``iid_k100`` on the one-slice
   hierarchical runtime (segment mode, 2), with every kernel's launch count
   reset just before and read just after each run; after each of the first,
   the compressed and the hierarchical runs it recomputes one consensus
   phase with the plain version;
5. breaks one round of ``noniid_affinity``, ``iid_k100`` and ``iid_k100``
   with qint8 down by phase (synchronized host timers) and profiles one more
   for the device's busy share;
6. trains the 2NN at K=4096 peers on a ring at full width on the one-slice
   segment runtime, 2 rounds through the round function without evaluation,
   and prints its seconds per round and peak memory beside the state's size;
7. prints the ``kernels`` JSON line and, last, the contract line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so does a run without a CUDA device or outside a checkout of the repository.

    python3 chip_smoke.py
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = dict(atol=5e-5, rtol=1e-4)  # float32, as tests/test_kernels.py
# (memory bytes/s, float32 FLOP/s outside the tensor cores) by card, from
# NVIDIA's H100 data sheet; the card's name, as nvidia-smi prints it, picks one
PEAKS = {"H100 SXM": (3.35e12, 67e12), "H100 PCIe": (2.0e12, 51e12)}
NONIID_ROUNDS = 5
IID_ROUNDS = 2
TV_QINT8_ROUNDS = 5
TV_TOPK_ROUNDS = 3
IID_QINT8_ROUNDS = 2
IID_POD_ROUNDS = 2
LARGE_K = 4096
LARGE_K_ROUNDS = 2


class Card:
    """The card's name and power limit (``nvidia-smi``), and its peaks."""

    def __init__(self, line: str):
        self.line = line
        name = line.split(",")[0]
        if "H100" in name and ("HBM3" in name or "SXM" in name):
            self.part = "H100 SXM"
        elif "H100" in name and "PCIe" in name:
            self.part = "H100 PCIe"
        else:
            raise RuntimeError(f"no peak rates known for the card {line!r}")
        self.bytes_per_s, self.flop_per_s = PEAKS[self.part]

    def bound(self, nbytes: float, flops: float) -> dict:
        """The least time for ``nbytes`` and ``flops`` on this card, and which bounds it."""
        t_bytes, t_flops = nbytes / self.bytes_per_s * 1e3, flops / self.flop_per_s * 1e3
        return {"bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "bound_card": f"{self.line} ({self.part} peaks: "
                              f"{self.bytes_per_s / 1e12} TB/s, {self.flop_per_s / 1e12} TFLOP/s)"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, target_s: float = 0.25) -> float:
    """Mean milliseconds per call of ``fn``, from CUDA events around a run of
    calls sized to take about ``target_s``, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once_ms = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max(target_s * 1e3 / once_ms, 3), 500))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kern, library) -> dict:
    """Mean ms of each, timed in turns: plain, kernel, library, library, kernel, plain."""
    t = {"plain_ms": [], "ms": [], "library_ms": []}
    for fn, key in ((plain, "plain_ms"), (kern, "ms"), (library, "library_ms"),
                    (library, "library_ms"), (kern, "ms"), (plain, "plain_ms")):
        t[key].append(cuda_ms(fn))
    return {key: sum(v) / len(v) for key, v in t.items()}


def consensus_case(card, name, graph, sizes, n, *, dmax=None, zero_beta_rows=(), seed=0):
    """Kernel vs plain version (and the dense library product) at one shape."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    beta[list(zero_beta_rows)] = 0.0  # isolated for d: d must stay 0
    sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    k, d = sparse.nbr_idx.shape
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)

    got = ops.consensus_mix_stacked(x, sparse, local_steps)
    want = ref.consensus_mix_stacked_ref(x, *sparse, local_steps)
    torch.cuda.synchronize()
    err = 0.0
    for g, r, what in zip(got, want, ("mixed", "d")):
        torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - r).abs().max()))
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")

    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    dense = torch.as_tensor(np.concatenate([w, beta]), dtype=torch.float32, device=dev)
    lib_out = torch.empty((2 * k, n), device=dev)
    kern = lambda: ops.launch(x, sparse, local_steps, mixed, d_out)  # noqa: E731
    plain = lambda: ref.consensus_mix_stacked_ref(x, *sparse, local_steps)  # noqa: E731
    library = lambda: torch.matmul(dense, x, out=lib_out)  # noqa: E731
    times = in_turns(plain, kern, library)

    # work this run's data needs: real (non-padding) slots only
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    flops = n * (4 * real + 3 * k)  # 2 FMAs per real slot, self scale + d per row
    nbytes = 3 * k * n * 4 + k * 4 + 3 * k * d * 4  # x once, mixed + d, operands
    return {"case": name, "K": k, "D": d, "N": n, "max_abs_err": err, **times,
            **card.bound(nbytes, flops)}


def dequant_case(card, name, graph, sizes, leaf_offsets, n, *, dmax=None, zero_beta_rows=(),
                 zero_scale_leaves=(), payload=True, want_vector=None, seed=0):
    """dequant_mix kernel vs its plain version (and the dense library product
    of the advanced estimates) at one shape.  ``leaf_offsets`` are the L + 1
    leaf boundaries; columns from the last one to ``n`` are row padding, zero
    in every input.  ``payload=False`` is top-k's call: no q, no scales."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant, ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    beta[list(zero_beta_rows)] = 0.0  # isolated for d: d must stay exactly 0
    sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    k, d = sparse.nbr_idx.shape
    size, num_leaves = leaf_offsets[-1], len(leaf_offsets) - 1
    rng = np.random.default_rng(seed)
    x = torch.zeros(k, n, device=dev)
    est = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.as_tensor(rng.normal(size=(k, size)).astype(np.float32), device=dev)
    est[:, :size] = x[:, :size] + torch.as_tensor(
        0.01 * rng.normal(size=(k, size)).astype(np.float32), device=dev)
    q = scale = None
    if payload:
        q = torch.zeros(k, n, dtype=torch.int8, device=dev)
        q[:, :size] = torch.as_tensor(rng.integers(-127, 128, (k, size)).astype(np.int8),
                                      device=dev)
        scale = torch.as_tensor(rng.uniform(0, 1e-4, (k, num_leaves)).astype(np.float32),
                                device=dev)
        scale[:, list(zero_scale_leaves)] = 0.0
    vector = dequant.takes_vector_path(leaf_offsets if payload else (0, 0), x, est, q)
    check(want_vector is None or vector == want_vector,
          f"{name}: vector path {vector}, want {want_vector}")

    got = dequant.dequant_mix_stacked(x, est, q, scale, sparse, leaf_offsets, local_steps)
    want = ref.dequant_mix_stacked_ref(x, est, q, scale, leaf_offsets, *sparse, local_steps)
    torch.cuda.synchronize()
    err = 0.0
    for g, r, what in zip(got, want, ("mixed", "d", "est'")):
        torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - r).abs().max()))
        check(bool((g[:, size:] == 0).all()), f"{name} {what}: row padding stays exactly 0")
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")
    check(payload or got[2] is est, f"{name}: a call with no payload leaves est as it is")

    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    est_out = torch.empty_like(x) if payload else None
    adv = want[2]  # the advanced estimates, prepared outside the timed region
    w_off = w - np.diag(np.diag(w))
    dense = torch.as_tensor(np.concatenate([w_off, beta]), dtype=torch.float32, device=dev)
    lib_out = torch.empty((2 * k, n), device=dev)
    kern = lambda: dequant.launch(x, est, q, scale, sparse, leaf_offsets,  # noqa: E731
                                  local_steps, mixed, d_out, est_out)
    plain = lambda: ref.dequant_mix_stacked_ref(  # noqa: E731
        x, est, q, scale, leaf_offsets, *sparse, local_steps)
    library = lambda: torch.matmul(dense, adv, out=lib_out)  # noqa: E731
    times = in_turns(plain, kern, library)

    # work this run's data needs: real (non-padding) slots only; the own
    # estimate's advance (2 operations) only with a payload
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    flops = n * (4 * real + (5 if payload else 3) * k)
    nbytes = (2 * k * n * 4 + 2 * k * n * 4  # x, est in; mixed, d out
              + (k * n + k * num_leaves * 4 + k * n * 4 if payload else 0)  # q, scales; est'
              + k * 4 + 3 * k * d * 4)  # slot operands
    return {"case": name, "K": k, "D": d, "N": n, "leaves": num_leaves, "payload": payload,
            "vector_path": vector, "max_abs_err": err, **times, **card.bound(nbytes, flops)}


def library_operator(sparse, r: int, dev, *, as_csr: bool) -> torch.Tensor:
    """[W; Beta] of round ``r`` as a (2K, K) float32 operator: dense, or (the
    callers' choice above K = 1000) the CSR of its nonzeros; at K = 4096 on
    a ring a dense product would be 13 TFLOP, nearly all of it zeros."""
    k, d = sparse.num_peers, sparse.degree_bound
    rows = np.repeat(np.arange(k), d)
    cols = sparse.nbr_idx[r].ravel().astype(np.int64)
    real = cols != rows
    idx = np.stack([np.concatenate([np.arange(k), rows[real], rows[real] + k]),
                    np.concatenate([np.arange(k), cols[real], cols[real]])])
    vals = np.concatenate([sparse.self_w[r], sparse.nbr_w[r].ravel()[real],
                           sparse.beta[r].ravel()[real]]).astype(np.float32)
    op = torch.sparse_coo_tensor(torch.as_tensor(idx), torch.as_tensor(vals), (2 * k, k),
                                 device=dev).coalesce()
    return op.to_sparse_csr() if as_csr else op.to_dense()


def segment_case(card, name, sparse, n, *, round_idx=0, zero_beta_rows=(), size=None,
                 want_vector=None, seed=0):
    """segment_mix kernel vs its plain version (and the library product of
    [W; Beta]) over round ``round_idx % R`` of a stacked sparse schedule.
    Columns from ``size`` to ``n`` are row padding, zero in the input, and
    must stay exactly zero."""
    from repro_torch.kernels.consensus_mix import ops, ref, segment

    dev = torch.device("cuda")
    local_steps = 10
    if zero_beta_rows:  # isolated for d in every round: d must stay exactly 0
        beta = sparse.beta.copy()
        beta[:, list(zero_beta_rows)] = 0.0
        sparse = dataclasses.replace(sparse, beta=beta)
    ops_s = ops.upload_schedule(sparse, dev)
    k, d = sparse.num_peers, sparse.degree_bound
    r = round_idx % sparse.period
    size = n if size is None else size
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.randn(k, size, generator=gen, device=dev)
    vector = n % 4 == 0 and x.data_ptr() % 16 == 0
    check(want_vector is None or vector == want_vector,
          f"{name}: vector path {vector}, want {want_vector}")

    got = segment.segment_mix_schedule(x, round_idx, ops_s, local_steps)
    want = ref.segment_mix_stacked_ref(x, *ops.select_round(ops_s, round_idx), local_steps)
    torch.cuda.synchronize()
    err = 0.0
    for g, w, what in zip(got, want, ("mixed", "d")):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - w).abs().max()))
        check(bool((g[:, size:] == 0).all()), f"{name} {what}: row padding stays exactly 0")
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")
    del got, want

    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    as_csr = k > 1000
    lib_op = library_operator(sparse, r, dev, as_csr=as_csr)
    kern = lambda: segment.launch(x, round_idx, ops_s, local_steps, mixed, d_out)  # noqa: E731
    plain = lambda: ref.segment_mix_stacked_ref(  # noqa: E731
        x, *ops.select_round(ops_s, round_idx), local_steps)
    library = ((lambda: torch.sparse.mm(lib_op, x)) if as_csr  # noqa: E731
               else (lambda: torch.matmul(lib_op, x)))
    times = in_turns(plain, kern, library)

    # work this run's data needs: the round's real (non-padding) slots only;
    # x read once, mixed and d written once, the round's operands read once
    real = int((sparse.nbr_idx[r] != np.arange(k)[:, None]).sum())
    flops = n * (4 * real + 3 * k)
    nbytes = 3 * k * n * 4 + k * 4 + 3 * k * d * 4
    return {"case": name, "K": k, "D": d, "N": n, "round": r, "vector_path": vector,
            "library": "torch.sparse.mm (CSR [W; Beta])" if as_csr else "torch.matmul",
            "max_abs_err": err, **times, **card.bound(nbytes, flops)}


def build_kernels() -> None:
    """Build every kernel library at once (one nvcc each, in parallel)."""
    from repro_torch.kernels.consensus_mix import dequant, ops, segment

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(("consensus_mix", "dequant_mix", "segment_mix"),
                        pool.map(lambda mod: mod.load_kernel(), (ops, dequant, segment))))
    print(f"build: all three kernels in {time.perf_counter() - start:.2f} s", flush=True)
    for name, kl in libs.items():
        print(f"  {name}: nvcc {kl.build_seconds:.2f} s -> {kl.path.relative_to(ROOT)}")
        for line in kl.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _print_case(kernel: str, c: dict) -> None:
    print(f"{kernel} {c['case']}: K={c['K']} D={c['D']} N={c['N']} "
          f"max_abs_err={c['max_abs_err']:.3g} kernel={c['ms']:.4f} ms "
          f"plain={c['plain_ms']:.4f} ms library={c['library_ms']:.4f} ms "
          f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']})", flush=True)


def segment_cases(card: Card) -> list[dict]:
    """``segment_mix`` at the one-slice runtime's shapes and at its edges."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    layout = layout_of("mnist_mlp")

    def sparse_of(sched, sizes):
        return graph_lib.SparseSchedule.from_schedule(sched, "data_weighted", data_sizes=sizes)

    def static(topology, k):
        return graph_lib.static_schedule(graph_lib.build_graph(topology, k))

    dropout = graph_lib.link_dropout_schedule(graph_lib.build_graph("ring", 64), 0.7, 16, seed=3)
    dropout_sparse = sparse_of(dropout, np.arange(64) % 5 + 10)
    # round 17 of R = 16 is round 1, whose operands differ from round 0's
    check(not np.array_equal(dropout_sparse.nbr_w[1], dropout_sparse.nbr_w[0]),
          "link-dropout rounds 0 and 1 differ")
    large_k_sizes = np.where(np.arange(LARGE_K) < 60000 % LARGE_K, 15, 14)  # iid_partition's
    cases = [
        segment_case(card, "iid_k100", sparse_of(static("complete", 100), np.full(100, 600)),
                     layout.row, size=layout.size, want_vector=True),
        segment_case(card, "ring_k4096", sparse_of(static("ring", LARGE_K), large_k_sizes),
                     layout.row, size=layout.size, want_vector=True, seed=1),
        segment_case(card, "star_k8_ragged", sparse_of(static("star", 8), np.arange(1, 9) * 10),
                     1001, zero_beta_rows=(3,), want_vector=False, seed=2),
        segment_case(card, "link_dropout_r16_at17", dropout_sparse, layout.row,
                     round_idx=17, size=layout.size, want_vector=True, seed=3),
        segment_case(card, "complete_k2048_chunked",
                     sparse_of(static("complete", 2048), np.arange(2048) % 7 + 5), 256,
                     want_vector=True, seed=4),
    ]
    torch.cuda.empty_cache()
    return cases


def check_kernels(card: Card) -> dict[str, list[dict]]:
    """Build the three kernels and hold each against its plain version at its shapes."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    build_kernels()
    layout = layout_of("mnist_mlp")
    row = layout.row  # 199,210 parameters -> 199,212
    cases = {"consensus_mix": [
        consensus_case(card, "noniid_k2", graph_lib.build_graph("complete", 2),
                       np.full(2, 100), row),
        consensus_case(card, "iid_k100", graph_lib.build_graph("complete", 100),
                       np.full(100, 600), row),
        consensus_case(card, "ring_k8_padded", graph_lib.build_graph("ring", 8),
                       np.arange(1, 9) * 10, 1001, dmax=3, zero_beta_rows=(3,)),
    ], "dequant_mix": [
        dequant_case(card, "iid_k100_qint8", graph_lib.build_graph("complete", 100),
                     np.full(100, 600), layout.leaf_offsets, row, want_vector=True),
        dequant_case(card, "tv_k8_star", graph_lib.build_graph("star", 8),
                     np.full(8, 100), layout.leaf_offsets, row, want_vector=True),
        dequant_case(card, "ring_odd_leaves", graph_lib.build_graph("ring", 8),
                     np.arange(1, 9) * 10, (0, 301, 302, 777, 999), 1001, dmax=3,
                     zero_beta_rows=(3,), zero_scale_leaves=(1,), want_vector=False),
        dequant_case(card, "ring_no_payload", graph_lib.build_graph("ring", 8),
                     np.arange(1, 9) * 10, (0, 301, 302, 777, 999), 1001, dmax=3,
                     zero_beta_rows=(3,), payload=False, seed=1),
    ], "segment_mix": segment_cases(card)}
    for kernel, kcases in cases.items():
        for c in kcases:
            _print_case(kernel, c)
    return cases


def recheck_consensus(name: str, exp, state, data, *, mix_mode=None) -> None:
    """One more round's consensus phase through the kernel, held against the
    plain version on the same post-local state (S = 1); ``mix_mode``
    "segment" rechecks the one-slice hierarchical runtime's phase."""
    from repro_torch import compression
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.kernels.consensus_mix import ops as cm_ops
    from repro_torch.kernels.consensus_mix import ref
    from repro_torch.launch import train

    cfg = exp.p2p
    check(cfg.consensus_steps == 1 and not cfg.use_affinity_b, f"{name}: one plain step")
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batches = task.make_peer_batches(parts, exp.batch_size, seed=1).round_batches_on(
        cfg.local_steps, torch.device("cuda"))
    after_local, _ = p2p.local_phase(state, task, batches, cfg)
    ops_s = p2p.schedule_operands(cfg, sizes, device="cuda")
    sparse = cm_ops.select_round(ops_s, after_local.round_idx)
    comp = compression.from_config(cfg)
    if mix_mode == "segment":
        after_cons = p2p.consensus_phase_hier(after_local, cfg, ops_s, mix_mode=mix_mode)
        mixed, d_bias = ref.segment_mix_stacked_ref(after_local.params, *sparse,
                                                    cfg.local_steps)
    elif comp.identity:
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        mixed, d_bias = ref.consensus_mix_stacked_ref(after_local.params, *sparse,
                                                      cfg.local_steps)
    else:
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        layout = p2p.layout_of(cfg.model)
        payload = comp.ef_flat(after_local.params, after_local.compression, layout)
        mixed, d_bias, est = ref.dequant_mix_stacked_ref(
            after_local.params, payload.est, payload.q, payload.scale, layout.leaf_offsets,
            *sparse, cfg.local_steps)
        torch.testing.assert_close(after_cons.compression, est, **TOL)
    torch.testing.assert_close(after_cons.params, mixed, **TOL)
    if cfg.use_affinity_d:
        torch.testing.assert_close(after_cons.d_bias, d_bias, **TOL)
    print(f"{name}: consensus of one more round matches the plain version")


def launch_counters() -> dict:
    from repro_torch.kernels.consensus_mix import dequant, ops, segment

    return {"consensus_mix": ops.launches, "dequant_mix": dequant.launches,
            "segment_mix": segment.launches}


def drive(name: str, exp, rounds: int, data, *, recheck: bool, mix_mode: str | None = None,
          **run_kw) -> dict:
    """Train ``exp`` for ``rounds`` rounds through ``run_paper_experiment`` on
    the card, every launch count set to 0 just before and read just after;
    checks that the path's kernel launched rounds x S times and the others
    none, and that the run's numbers are sane.  ``mix_mode`` "segment" with
    ``peer_axis="pod"`` runs the one-slice hierarchical runtime."""
    from repro_torch.launch import train

    counters = launch_counters()
    if mix_mode == "segment":
        kernel = "segment_mix"
        run_kw["mix_mode"] = mix_mode
    else:
        kernel = "consensus_mix" if exp.p2p.compressor == "none" else "dequant_mix"
    want = {key: 0 for key in counters}
    want[kernel] = rounds * exp.p2p.consensus_steps
    print(f"main path: {name}, {rounds} rounds", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():
        counter.reset()
    log, state = train.run_paper_experiment(exp, rounds=rounds, data=data, device="cuda",
                                            verbose=True, return_state=True, **run_kw)
    launches = {key: counter.count for key, counter in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == want, f"{name} launched {launches}, want {want}")
    check(all(math.isfinite(v) for v in log.train_loss), f"{name} losses finite")
    acc = log.series("all").mean(axis=1)
    check(bool(np.all((acc >= 0) & (acc <= 1))), f"{name} accuracies in [0, 1]")
    check(bool(torch.isfinite(state.params).all()), f"{name} parameters finite")
    if recheck:
        recheck_consensus(name, exp, state, data, mix_mode=mix_mode)
    print(f"{name}: launches {launches}, seconds per round {log.seconds}, "
          f"peak memory {peak_gb:.3f} GB")
    return {"launches": launches[kernel], "kernel": kernel, "peak_gb": peak_gb,
            "seconds": log.seconds}


def phase_breakdown(exp, data, rounds: int = 3) -> dict:
    """Where one round's time goes: mean seconds of each phase over ``rounds``
    rounds after a warm-up round, each phase ended by a device synchronize;
    then one more round under torch.profiler for the device's busy share."""
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    sparse = p2p.round_operands(cfg, sizes, device=dev)[0]
    x_eval = torch.as_tensor(data[2], device=dev)
    y_eval = torch.as_tensor(data[3], dtype=torch.int64, device=dev)
    groups = {"all": np.arange(10)}

    def one_round(st, times=None):
        marks = [time.perf_counter()]
        batches = batcher.round_batches_on(cfg.local_steps, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        after_local, _ = p2p.local_phase(st, task, batches, cfg)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for s in (after_local, after_cons):
            p2p.stratified_accuracy(task.apply_fn, p2p.param_views(s, task), x_eval, y_eval,
                                    groups)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if times is not None:
            for name, a, b in zip(("batches", "local", "consensus", "eval"), marks, marks[1:]):
                times.setdefault(name, []).append(b - a)
        return after_cons

    state = one_round(state)  # warm-up: cuBLAS handles, allocator, autograd
    times: dict[str, list] = {}
    for _ in range(rounds):
        state = one_round(state, times)
    out = {name: sum(v) / len(v) for name, v in times.items()}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        batches = batcher.round_batches_on(cfg.local_steps, dev)
        after_local, _ = p2p.local_phase(state, task, batches, cfg)
        p2p.consensus_phase(after_local, cfg, sparse)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    # device-side entries only: the aten ops' rows repeat their kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    out["profiled_round_s"] = wall_s
    out["device_busy_s"] = device_s
    out["device_busy_share"] = device_s / wall_s if device_s > 0 else None
    out["top_kernels_ms"] = [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                             for e in top[:6]]
    return out


def drive_large_k(exp, rounds: int, data) -> dict:
    """``exp`` at K = LARGE_K peers, full width, on the one-slice segment
    runtime: ``rounds`` rounds through the round function, no evaluation
    (as the reference's K = 4096 test drives its round step), launch counts
    reset just before and read just after, peak memory beside the size of
    the four state buffers (params, momentum, d, b)."""
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.data import partition
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    k = cfg.num_peers
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = partition.data_sizes(parts)
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    round_fn = p2p.make_hier_round_fn(task, cfg, sizes, peers_per_device=k, mix_mode="segment",
                                      device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    print(f"main path: 2NN at K={k} on a {cfg.topology}, one-slice segment runtime, "
          f"{rounds} rounds", flush=True)
    seconds, losses = [], []
    for _ in range(rounds):
        start = time.perf_counter()
        batches = batcher.round_batches_on(cfg.local_steps, dev)
        _, state, loss = round_fn(state, batches)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(float(loss.mean()))
    launches = {key: counter.count for key, counter in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = 4 * state.params.numel() * 4 / 1e9
    want = {"consensus_mix": 0, "dequant_mix": 0, "segment_mix": rounds * cfg.consensus_steps}
    check(launches == want, f"K={k} launched {launches}, want {want}")
    check(all(math.isfinite(v) for v in losses), f"K={k} losses finite")
    for field in ("params", "momentum", "d_bias", "b_bias"):
        check(bool(torch.isfinite(getattr(state, field)).all()), f"K={k} {field} finite")
    check(state.round_idx == rounds, f"K={k} ran {state.round_idx} rounds")
    print(f"K={k}: launches {launches}, set-up {setup_s:.3f} s, seconds per round {seconds}, "
          f"losses {losses}, peak memory {peak_gb:.3f} GB against {state_gb:.3f} GB for the "
          f"four (K, {state.params.shape[1]}) state buffers", flush=True)
    return {"launches": launches["segment_mix"], "kernel": "segment_mix", "peak_gb": peak_gb,
            "state_gb": state_gb, "seconds": seconds, "setup_s": setup_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.p2pl_mnist import iid_k100, noniid_k2, timevarying_k8
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card(card_line())
    print(f"card: {card.line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}",
          flush=True)

    cases = check_kernels(card)
    data = synthetic.mnist_like()
    noniid = noniid_k2(algorithm="p2pl_affinity", local_steps=10)
    iid = iid_k100()
    iid_qint8 = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p, compressor="qint8"))
    paths = {
        "noniid_affinity": drive("noniid_affinity", noniid, NONIID_ROUNDS, data, recheck=True),
        "iid_k100": drive("iid_k100", iid, IID_ROUNDS, data, recheck=False),
        "timevarying_k8_round_robin_qint8": drive(
            "timevarying_k8_round_robin_qint8",
            timevarying_k8(schedule="round_robin", compressor="qint8"), TV_QINT8_ROUNDS, data,
            recheck=True),
        "timevarying_k8_round_robin_topk": drive(
            "timevarying_k8_round_robin_topk",
            timevarying_k8(schedule="round_robin", compressor="topk"), TV_TOPK_ROUNDS, data,
            recheck=True),
        "iid_k100_qint8": drive("iid_k100_qint8", iid_qint8, IID_QINT8_ROUNDS, data,
                                recheck=True),
        "iid_k100_pod_segment": drive("iid_k100_pod_segment", iid, IID_POD_ROUNDS, data,
                                      recheck=True, mix_mode="segment", peer_axis="pod",
                                      peers_per_device=iid.p2p.num_peers),
    }
    for label, exp in (("noniid_affinity", noniid), ("iid_k100", iid),
                       ("iid_k100_qint8", iid_qint8)):
        print(f"breakdown {label} ({card.line}): {json.dumps(phase_breakdown(exp, data))}",
              flush=True)
    ring = iid_k100(topology="ring")
    large_k = dataclasses.replace(ring, p2p=dataclasses.replace(ring.p2p, num_peers=LARGE_K))
    paths[f"ring_k{LARGE_K}"] = drive_large_k(large_k, LARGE_K_ROUNDS, data)

    entries = []
    for kernel, source, replaces, main_case in (
        ("consensus_mix", "consensus_mix.cu", "consensus_mix.py:72", "iid_k100"),
        ("dequant_mix", "dequant_mix.cu", "dequant.py:117", "iid_k100_qint8"),
        ("segment_mix", "segment_mix.cu", "segment.py:124", f"ring_k{LARGE_K}"),
    ):
        main = next(c for c in cases[kernel] if c["case"] == main_case)
        by_path = {name: p["launches"] for name, p in paths.items() if p["kernel"] == kernel}
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/consensus_mix/csrc/{source}",
            "replaces": f"src/repro/kernels/consensus_mix/{replaces}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases[kernel]),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "bound_card")},
            "shape": f"K={main['K']} D={main['D']} N={main['N']}",
            "shapes": cases[kernel],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

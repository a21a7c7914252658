#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

In order:
1. prints the card's name and power limit, the torch version and the TF32
   flags (set off: the reference mixes at full float32 precision);
2. builds every kernel of the port's main path from this checkout's sources;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (atol 5e-5 / rtol 1e-4) and times kernel, plain
   version and one PyTorch library call in turns with CUDA events;
4. drives the paper's trainer through ``run_paper_experiment``:
   ``noniid_affinity`` for 5 rounds and ``iid_k100`` for 2, with each
   kernel's launch count reset just before and read just after each run,
   and recomputes one consensus phase with the plain version;
5. breaks one round of each configuration down by phase (synchronized host
   timers) and profiles one more for the device's busy share;
6. prints the ``kernels`` JSON line and, last, the contract line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so does a run without a CUDA device or outside a checkout of the repository.

    python3 chip_smoke.py
"""
from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NONIID_ROUNDS = 5
IID_ROUNDS = 2


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


def consensus_case(name, graph, sizes, n, *, dmax=None, zero_beta_rows=(), seed=0):
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
    # in turns: plain, kernel, library, library, kernel, plain
    t_plain, t_kern, t_lib = [], [], []
    for fn, acc in ((plain, t_plain), (kern, t_kern), (library, t_lib),
                    (library, t_lib), (kern, t_kern), (plain, t_plain)):
        acc.append(cuda_ms(fn))

    # work this run's data needs: real (non-padding) slots only
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    flops = n * (4 * real + 3 * k)  # 2 FMAs per real slot, self scale + d per row
    nbytes = 3 * k * n * 4 + k * 4 + 3 * k * d * 4  # x once, mixed + d, operands
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return {
        "case": name, "K": k, "D": d, "N": n,
        "max_abs_err": err,
        "ms": sum(t_kern) / 2, "plain_ms": sum(t_plain) / 2, "library_ms": sum(t_lib) / 2,
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
    }


def check_kernels() -> list[dict]:
    """Build the kernel and hold it against the plain version at three shapes."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import ParamLayout
    from repro_torch.core.task import get_task
    from repro_torch.kernels.consensus_mix import ops

    start = time.perf_counter()
    kl = ops.load_kernel()
    print(f"build: consensus_mix in {time.perf_counter() - start:.2f} s "
          f"(nvcc {kl.build_seconds:.2f} s) -> {kl.path.relative_to(ROOT)}", flush=True)
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    row = ParamLayout.of(get_task("mnist_mlp")).row  # 199,210 parameters -> 199,212
    cases = [
        consensus_case("noniid_k2", graph_lib.build_graph("complete", 2),
                       np.full(2, 100), row),
        consensus_case("iid_k100", graph_lib.build_graph("complete", 100),
                       np.full(100, 600), row),
        consensus_case("ring_k8_padded", graph_lib.build_graph("ring", 8),
                       np.arange(1, 9) * 10, 1001, dmax=3, zero_beta_rows=(3,)),
    ]
    for c in cases:
        print(f"consensus_mix {c['case']}: K={c['K']} D={c['D']} N={c['N']} "
              f"max_abs_err={c['max_abs_err']:.3g} kernel={c['ms']:.4f} ms "
              f"plain={c['plain_ms']:.4f} ms library={c['library_ms']:.4f} ms "
              f"bound={c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
    return cases


def run_noniid(data) -> int:
    """noniid_affinity through the trainer; returns the kernel's launches."""
    from repro_torch.configs.p2pl_mnist import noniid_k2
    from repro_torch.core import p2p, protocols, task as task_lib
    from repro_torch.kernels.consensus_mix import ops, ref
    from repro_torch.launch import train

    exp = noniid_k2(algorithm="p2pl_affinity", local_steps=10)
    cfg = exp.p2p
    print(f"main path: noniid_affinity, {NONIID_ROUNDS} rounds", flush=True)
    ops.launches.reset()
    log, state = train.run_paper_experiment(
        exp, rounds=NONIID_ROUNDS, data=data, device="cuda", verbose=True, return_state=True
    )
    launches = ops.launches.count
    check(launches == NONIID_ROUNDS * cfg.consensus_steps,
          f"noniid_affinity launched the kernel {launches} times, "
          f"want {NONIID_ROUNDS * cfg.consensus_steps}")
    check(all(math.isfinite(v) for v in log.train_loss), "noniid_affinity losses finite")

    # one more round's consensus, kernel vs plain version on the same state
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batches = task.make_peer_batches(parts, exp.batch_size, seed=1).round_batches_on(
        cfg.local_steps, torch.device("cuda"))
    after_local, _ = p2p.local_phase(state, task, batches, cfg)
    consts, _ = p2p.protocol_constants(cfg, sizes)
    sparse = protocols.get_protocol(cfg.protocol).operands(
        protocols.round_constants(consts, 0), "cuda")
    after_cons = p2p.consensus_phase(after_local, cfg, sparse)
    mixed, d_bias = ref.consensus_mix_stacked_ref(after_local.params, *sparse, cfg.local_steps)
    torch.testing.assert_close(after_cons.params, mixed, **TOL)
    torch.testing.assert_close(after_cons.d_bias, d_bias, **TOL)
    print("noniid_affinity: consensus of one more round matches the plain version")
    print(f"noniid_affinity: {launches} launches, seconds per round {log.seconds}")
    return launches


def run_iid(data) -> tuple[int, float]:
    """iid_k100 through the trainer; returns (launches, peak GB)."""
    from repro_torch.configs.p2pl_mnist import iid_k100
    from repro_torch.kernels.consensus_mix import ops
    from repro_torch.launch import train

    exp = iid_k100()
    print(f"main path: iid_k100, {IID_ROUNDS} rounds", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.launches.reset()
    log = train.run_paper_experiment(exp, rounds=IID_ROUNDS, data=data, device="cuda",
                                     verbose=True)
    launches = ops.launches.count
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == IID_ROUNDS * exp.p2p.consensus_steps,
          f"iid_k100 launched the kernel {launches} times, want {IID_ROUNDS}")
    check(all(math.isfinite(v) for v in log.train_loss), "iid_k100 losses finite")
    acc = log.series("all").mean(axis=1)
    check(bool(np.all((acc >= 0) & (acc <= 1))), "iid_k100 accuracies in [0, 1]")
    print(f"iid_k100: {launches} launches, seconds per round {log.seconds}, "
          f"peak memory {peak_gb:.3f} GB")
    return launches, peak_gb


def phase_breakdown(exp, data, rounds: int = 3) -> dict:
    """Where one round's time goes: mean seconds of each phase over ``rounds``
    rounds after a warm-up round, each phase ended by a device synchronize;
    then one more round under torch.profiler for the device's busy share."""
    from repro_torch.core import p2p, protocols, task as task_lib
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    consts, _ = p2p.protocol_constants(cfg, sizes)
    sparse = protocols.get_protocol(cfg.protocol).operands(
        protocols.round_constants(consts, 0), dev)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}",
          flush=True)

    cases = check_kernels()
    data = synthetic.mnist_like()
    n_noniid = run_noniid(data)
    n_iid, _ = run_iid(data)
    from repro_torch.configs.p2pl_mnist import iid_k100, noniid_k2

    for exp in (noniid_k2(algorithm="p2pl_affinity", local_steps=10), iid_k100()):
        print(f"breakdown {exp.name}: {json.dumps(phase_breakdown(exp, data))}", flush=True)

    main_case = next(c for c in cases if c["case"] == "iid_k100")
    entry = {
        "name": "consensus_mix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/consensus_mix/csrc/consensus_mix.cu",
        "replaces": "src/repro/kernels/consensus_mix/consensus_mix.py:72",
        "launches": n_noniid + n_iid,
        "launches_by_path": {"noniid_affinity": n_noniid, "iid_k100": n_iid},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **{key: main_case[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
        "shape": f"K={main_case['K']} D={main_case['D']} N={main_case['N']}",
        "shapes": cases,
    }
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

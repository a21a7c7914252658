#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

In order:
1. prints the card's name and power limit, the torch version and the TF32
   flags (set off: the reference mixes at full float32 precision), and takes
   the card's peak memory rate, float32 rate and dense bf16 and TF32 tensor
   rates from its name;
2. builds every kernel of the port's main paths from this checkout's sources,
   one nvcc per source, all started together (six: ``consensus_mix``,
   ``dequant_mix``, ``segment_mix``, ``wkv6``, ``flash_attention``,
   ``ssd``), and prints ptxas's report;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times kernel, plain version and, where one exists,
   one PyTorch library call in turns with CUDA events (atol 5e-5 / rtol 1e-4
   for the consensus kernels, float32 attention and ``ssd``, with a relative
   norm error under 1e-5 for ``ssd``, 1e-3 for ``wkv6``, atol = rtol = 1e-2
   and a relative norm error under 1e-2 for bf16 attention):
   ``consensus_mix`` at nine
   shapes, asserting the design each takes (the column tile from K = 16 to
   128, the gather below and above): the main paths' K = 2 and 100, a
   padded ring, K = 15 and 16 on either side of the small-K rule, K = 100
   with a ragged N and zero beta rows, K = 100 with W = I (d must survive),
   and K = 128 and 129 on either side of the cap; ``dequant_mix`` at nine,
   asserting the design each takes (the
   column tile up to K = 128, the gather above): the vector path at K=100
   (its N a ragged number of tiles), a padded star round, the scalar path
   with odd leaf boundaries inside a tile, a zero beta row, a zero-scale
   leaf and a no-payload call at K = 8 and K = 100, K = 2, and K = 128 and
   129 on either side of the cap), ``segment_mix`` at five (K=100
   complete, K=4096 ring, a padded star with a zero beta row and ragged N on
   the scalar path, round 17 of a stacked R=16 link-dropout schedule, and
   D=2047 slots staged in chunks); the mass mode (push-sum) of the three
   consensus kernels, mixed, d and the new mass each held to its plain
   version, the new mass to sum K within 1e-5 K, and timed against
   ``torch.matmul([A diag(y); Beta], X)``: ``consensus_mix`` at K = 8 on
   the directed ring (gather), K = 100 complete (tile), K = 129 (gather) and
   K = 16 with an isolated peer, ``dequant_mix`` (qint8) at K = 8, 100, 129
   and K = 8 with an isolated peer, ``segment_mix`` on the K = 4096
   directed ring at the 2NN's row and on a K = 64 one with an isolated peer
   (whose mass and parameters stay, and whose d is 0); the snapshot mode
   (bounded staleness) of ``consensus_mix``, gossip and mass, on
   age-decayed operands with every own snapshot stale, asserting its design
   and that d reads the live row, timed against
   ``torch.matmul([W_off; Beta], P)``: ``straggler_k8``'s K = 8 ring
   (gather), K = 100 complete (tile), K = 129 (gather) and K = 16 with an
   isolated peer (tile); the dense operands of adaptive rounds (a
   loss-proximity matching computed on the card, every j != k a slot, one
   weighted), asserting each design and timed against
   ``torch.matmul([W_off; Beta], X)``: ``consensus_mix`` at K = 8 (gather,
   D = 7, also timed on the same matching's D = 1 sparse operands), K = 9
   (one unmatched peer, whose row stays x_k and whose d stays 0) and K = 100
   (tile, D = 99), its mass mode at K = 8 and 100 (the new mass summing to
   K), ``dequant_mix`` (qint8) at K = 8 (tile); then each partner rule's
   matching on the card against the CPU's, partner, W and Beta equal, the
   all-zero-loss round's tie-break pairing among them; ``wkv6`` at seventeen (the prefill's
   B 4, T 1024, 64 heads of 64, chunk 16, from a zero and from a random
   state, and with bf16 r, k and v as served, timed; T 1000, ragged;
   log-decay -50; T 5, under one chunk; B 1, T 4096, timed; T 1001 ragged
   at chunk 48 with a state in bf16; the reference's three sweep shapes at
   head widths 16, 32 and 64; head widths 16 and 32 at chunks 1 and 64;
   and chunk 64 at head width 64 in float32 at B 1 and 4; bf16 outputs
   held within the float32 tolerance plus their one rounding),
   ``flash_attention`` at 37, asserting the route each takes (``wgmma``
   for bf16 at D = 80 and 128, ``mma_sync`` at D = 32 and 64, ``float32``)
   (minitron's prefill B 4, S 1024, H 32, Kh 8,
   D 128, causal, bf16, timed against SDPA; phi4's group of 3; the
   long-context B 1, S 8192, window 4096, timed against SDPA with a boolean
   mask; S 1000 ragged; S 5; non-causal float32; smollm's 9 over 3 heads;
   zamba2's shared block at its prefill's B 4, S 1024, H = Kh = 32, D 80,
   timed against SDPA; the reduced configs' D 32 float32; the wgmma
   design's edges: S 129 and 1000 against 128-row tiles, S 5 at D 80,
   window 4000 at S 8192, group 3 at D 80, non-causal D 128, B 4 S 1024 at
   both served widths, and the (B, H, S, D) entry read in place at both;
   qwen3-moe's prefill at its group of 16, B 4, S 1024, H 64, Kh 4, D 128,
   timed against SDPA;
   and the reference sweep's 9 (S, D, mask) shapes in both types), ``ssd``
   at 32, output and
   final state, each asserting its route (``tf32x2`` for bf16 inputs,
   ``tf32x3`` for float32) and its split of P (zamba2's prefill B 4, T 1024,
   80 heads of P = N = 64, one B/C group, chunk 64, from a zero and from a
   random state, and with bf16 x, B and C as the served path gives them,
   both timed beside both bounds, on the float32 pipes and on the tensor
   cores; T 1000, ragged; T 5 and T 1, under one chunk; B 1, T 8192, 128
   chunks of carried state; dt a = -50; G = 2 groups over H = 4; the
   reference sweep's three shapes in both types; then the tensor-core
   design's edges: B * H on either side of each change of the split, in
   bf16 and float32; B 1, H 80 in bf16 (split 4); P 64, N 32 split 4;
   T 65, T 17, chunk 48 and chunk 1, and P 16, N 8 over 3 groups, in both
   types);
4. serves RWKV6-7B at full width and depth (bf16, random init on the card)
   through ``serve_batch``: batch 4, prompt 1024, first prefill only, then
   prefill and 15 decode steps, asserting ``wkv6`` launched once per layer
   in the prefill and never in the decode; in one more prefill, reruns the
   WKV calls of layers 0 and 31 on the operands the served path gives them,
   through the plain version, and compares (``recheck_calls``); times a
   warm prefill and decode step and profiles each; then serves the K = 2
   fleet through ``serve_fleet`` (two stacked models, one request group
   each), asserting 2 x 32 launches;
5. serves minitron-8b (9.88 B parameters) at full width and depth the same
   way, asserting ``flash_attention`` launched once per layer in each
   prefill and never in the decode; reruns the attention calls of layers 0
   and 31 of one more prefill through the plain version the same way;
   times and profiles a warm prefill and decode step (device time by kernel
   category); then
   runs its long-context variant (``for_shape(..., long_500k)``, a 4096-slot
   ring) on a prompt of 8192 tokens and 3 decode steps, both ways (the
   python loop and the scanned decode from the same prefill's cache, tokens
   and rings equal), asserting 32 launches, finite logits and the ring's
   positions;
6. serves zamba2-2.7b (2.35 B parameters: 54 Mamba2 layers and one shared
   attention block applied 9 times) at full width and depth the same way,
   asserting 54 ``ssd`` and 9 ``flash_attention`` launches in each prefill
   and none in the decode, and printing the peak memory beside the
   parameters; reruns the SSD calls of layers 0 and 53 and the attention
   calls of the shared block's first and last application of one more
   prefill through the plain version the same way; times and profiles a
   warm prefill and decode step (device time by kernel category); then
   serves the two MoE decoders at their published widths with the depth cut
   to fit the card (bf16, random init from seed 0 on the card, batch 4,
   prompt 1024, 16 tokens, through ``serve_model``, the helper
   ``serve_batch`` runs): deepseek-v2-236b at 6 of 60 layers (21.25 B
   parameters: MLA, the dense layer 0, 5 MoE layers of 160 experts top-6
   and 2 shared; no kernel, so none launched) and qwen3-moe-235b-a22b at 8
   of 94 (21.15 B: GQA at a group of 16 through ``flash_attention``, 8
   launches in each prefill and none in the decode, layers 0 and 7
   rechecked; 128 experts top-8), each timed, profiled and decoded both
   ways as the others, printing the peak memory beside the parameters; and
   on each (``moe_checks``): the share of assignments dropped at capacity
   factor 1.25 in every MoE layer of one prefill, the first MoE layer's
   dispatch on 512 tokens of its real input at a capacity that drops
   nothing against ``apply_dense_reference`` (relative norm error under
   1e-2), and for deepseek one decode step under ``mla_absorb`` against the
   expanded step (each layer's MLA output on the expanded step's own input
   within 1e-2, the logits' error reported), both timed;
   in phases 4-6, ``serve_batch`` and ``serve_fleet`` decode through their
   default, the scanned decode (one decode step captured as a CUDA graph
   over the cache, written in place, and replayed per token); and on the
   parameters each phase loads for its recheck, one prefill is decoded 15
   steps both ways, the python loop and the scanned decode
   (``compare_decode``): tokens and every final cache leaf equal, the
   prefill's launches as above and none in either decode, decode s/token
   both ways, the capture seconds, a warm replay's seconds, the CUDA
   kernels of one step both ways (torch.profiler) and the peak memory both
   ways; the K = 2 fleet's groups are drawn again and decoded both ways,
   each equal to ``serve_fleet``'s tokens (``fleet_both_ways``);
7. drives the trainer through ``run_paper_experiment``: uncompressed
   ``noniid_affinity`` (5 rounds) and ``iid_k100`` (2), then compressed
   ``timevarying_k8`` round robin with qint8 (5) and with top-k (3),
   ``iid_k100`` with qint8 (2), and ``iid_k100`` on the one-slice
   hierarchical runtime (segment mode, 2); then push-sum: ``directed_k8``
   static (3), with one-way matchings (3) and with directed link dropout and
   qint8 (3), ``iid_k100 --protocol push_sum`` (2) and the same on the
   one-slice segment runtime (2), each push-sum run checking after every
   round that the mass sums to K within 1e-5 K and stays positive; then
   asynchronous rounds: ``iid_k100 --steps-profile linear`` (2: step budgets
   alone, the synchronous consensus), ``straggler_k8`` gossip static and
   push-sum round robin (5 each, through the snapshot mode); then adaptive
   partner selection (each round's matching chosen on the card inside the
   round, mixed through the dense operands): ``timevarying_k8 --schedule
   adaptive`` with loss proximity and with eps-greedy (eps 0.5),
   ``directed_k8 --schedule adaptive`` (push-sum, the mass mode) and
   ``timevarying_k8 --schedule adaptive --compressor qint8`` (5 each); then
   RWKV6 on sequential MNIST (``seqmnist_phase``: ``seqmnist_k8``, K = 8,
   T = 4, 31 leaves, N = 100,236): the classifier's K-batched loss and
   per-leaf gradients on the card against the CPU (atol 5e-5 / rtol 1e-4),
   ``rwkv6_features`` chunked (``wkv6``, 2 launches) against the token loop
   at B = 256, ``wkv6`` at B 256, T 196, H 4, dk 16, chunk 49 against its
   plain version (timed) and from a random state, autograd through
   ``wkv6`` (directly and under ``rwkv6_loss_fn``), ``ssd`` and
   ``flash_attention`` raising ``NotImplementedError`` with nothing
   launched, ``consensus_mix`` (gossip and mass mode) and ``dequant_mix``
   held and timed at the task's row, gossip static, push-sum static and
   gossip round robin over qint8 (3 rounds each), both drivers on gossip
   and push-sum (6 rounds, eval every 3), and one round's kernels eager and
   on replay (torch.profiler), printing the phase's seconds; with
   every kernel's launch count reset just before and read just after each
   run, and every plain version's calls counted (none allowed); after each
   of the first, the compressed, the hierarchical and three push-sum runs it
   recomputes one consensus phase with the plain version (the async ones
   on the round's delivery and age-decayed operands); these runs take
   ``run_paper_experiment``'s default driver, the scan driver (each round a
   replay of one captured CUDA graph of the round, launches counted on
   replay), evaluating every round, so ``on_round`` still sees every
   round; then runs both drivers from the same seed and rounds
   (``compare_drivers``): ``noniid_affinity`` (K = 2, the gather design; 15
   rounds, eval every 5), ``iid_k100`` (tile; 10, 5), ``iid_k100`` qint8
   (``dequant_mix``; 10, 5), ``timevarying_k8`` round robin with qint8 (R =
   2 operands refreshed per round; 9, 3), ``directed_k8`` (push-sum, mass
   mode; 15, 5), ``iid_k100`` on the one-slice segment runtime
   (``segment_mix``; 10, 5), ``straggler_k8`` gossip static and push-sum
   round robin (the snapshot mode's gather; 15, 5) and ``iid_k100
   --steps-profile straggler --staleness-bound 3`` (its tile; 10, 5), and
   the adaptive ``timevarying_k8`` loss-proximity and eps-greedy runs and
   ``directed_k8`` (15, 5 each): final params, momentum, d, b, mass, the
   selection key and last losses, estimate, published snapshots and ages,
   the logged losses and accuracies equal bit for bit, ages within the
   bound and the mass summing to K, the same
   launches, no plain version; s/round both ways after the first period,
   the capture seconds, peak memory both ways, and at K = 100 the cost of
   copying every state leaf once (the body's carry copy at most);
8. breaks one round of ``noniid_affinity``, ``iid_k100``, ``iid_k100``
   with qint8 and ``directed_k8`` down by phase (synchronized host timers:
   the python driver's per-round view, through the phase functions) and
   profiles one more for the device's busy share; and profiles one adaptive
   round's selection alone at K = 8 for each rule (kernels, device time,
   a CUDA graph of it replayed);
9. trains the 2NN at K=4096 peers on a ring at full width on the one-slice
   segment runtime, 2 rounds through the python driver's round function
   without evaluation (its rounds are device-bound, about 2 s, and its
   state 13.1 GB, so a graph of the round would save little and its carry
   copy more memory), and prints its seconds per round and peak memory
   beside the state's size;
10. prints the ``kernels`` JSON line (each consensus kernel with its mass
   mode beside its gossip mode, ``consensus_mix`` also with its snapshot
   mode, ``consensus_mix`` and ``dequant_mix`` with their dense-operand
   cases and the adaptive paths' launches) and, last, the contract line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so does a run without a CUDA device or outside a checkout of the repository.

    python3 chip_smoke.py
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
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
# (memory bytes/s, float32 FLOP/s outside the tensor cores, dense bf16 tensor
# FLOP/s, dense TF32 tensor FLOP/s: half of bf16's) by card, from NVIDIA's
# H100 data sheet; the card's name, as nvidia-smi prints it, picks one
PEAKS = {"H100 SXM": (3.35e12, 67e12, 989e12, 495e12),
         "H100 PCIe": (2.0e12, 51e12, 756e12, 378e12)}
NONIID_ROUNDS = 5
IID_ROUNDS = 2
TV_QINT8_ROUNDS = 5
TV_TOPK_ROUNDS = 3
IID_QINT8_ROUNDS = 2
IID_POD_ROUNDS = 2
DIRECTED_ROUNDS = 3
STRAGGLER_ROUNDS = 5
ADAPTIVE_ROUNDS = 5
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
        (self.bytes_per_s, self.flop_per_s, self.bf16_flop_per_s,
         self.tf32_flop_per_s) = PEAKS[self.part]

    def bound(self, nbytes: float, flops: float, *, bf16: bool = False,
              tf32: bool = False) -> dict:
        """The least time for ``nbytes`` and ``flops`` on this card, and which
        bounds it; ``bf16`` / ``tf32`` take the dense bf16 / TF32 tensor
        rate, else float32's."""
        rate, kind = ((self.bf16_flop_per_s, "bf16") if bf16 else
                      (self.tf32_flop_per_s, "TF32") if tf32 else (self.flop_per_s, "float32"))
        t_bytes, t_flops = nbytes / self.bytes_per_s * 1e3, flops / rate * 1e3
        return {"bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "bound_card": f"{self.line} ({self.part} peaks: {self.bytes_per_s / 1e12} TB/s, "
                              f"{rate / 1e12} TFLOP/s {kind})"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative norm error |got - want| / |want|, in float32."""
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


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
    """Mean ms of each, timed in turns: plain, kernel, library, library, kernel,
    plain; ``library`` None (no PyTorch call computes the function) gives
    ``library_ms`` None."""
    t = {"plain_ms": [], "ms": [], "library_ms": []}
    for fn, key in ((plain, "plain_ms"), (kern, "ms"), (library, "library_ms"),
                    (library, "library_ms"), (kern, "ms"), (plain, "plain_ms")):
        if fn is not None:
            t[key].append(cuda_ms(fn))
    return {key: sum(v) / len(v) if v else None for key, v in t.items()}


def consensus_case(card, name, graph, sizes, n, *, dmax=None, zero_beta_rows=(), self_only_w=False,
                   want_path="tile", seed=0):
    """Kernel vs plain version (and the dense library product) at one shape.
    ``self_only_w`` mixes with W = I while Beta stays the graph's (the mix
    is x, d must survive); ``want_path`` is the design the wrapper must
    pick: ``"tile"`` or ``"gather"``."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    if self_only_w:
        w = np.eye(len(sizes))
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    beta[list(zero_beta_rows)] = 0.0  # isolated for d: d must stay 0
    sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    k, d = sparse.nbr_idx.shape
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
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
    if self_only_w:
        check(bool(torch.equal(got[0], x)), f"{name}: W = I mixes nothing")
        check(float(got[1].abs().max()) > 0.0, f"{name}: d survives a W with no off-diagonal")

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
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "max_abs_err": err, **times, **card.bound(nbytes, flops)}


def consensus_cases(card: Card, row: int) -> list[dict]:
    """``consensus_mix`` at the main paths' shapes (K = 2 and 100 at the
    2NN's row) and at the edges of its two designs: the column tile from
    ``TILE_MIN_PEERS`` to ``TILE_MAX_PEERS`` peers, the gather elsewhere."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops

    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    lo, cap = ops.TILE_MIN_PEERS, ops.TILE_MAX_PEERS
    design = lambda k: "tile" if lo <= k <= cap else "gather"  # noqa: E731
    return [
        consensus_case(card, "noniid_k2", complete(2), np.full(2, 100), row,
                       want_path=design(2)),
        consensus_case(card, "iid_k100", complete(100), np.full(100, 600), row),
        consensus_case(card, "ring_k8_padded", graph_lib.build_graph("ring", 8),
                       np.arange(1, 9) * 10, 1001, dmax=3, zero_beta_rows=(3,),
                       want_path=design(8)),
        consensus_case(card, f"edge_k{lo - 1}", complete(lo - 1), np.arange(1, lo) * 10, 5003,
                       want_path="gather", seed=1),
        consensus_case(card, f"edge_k{lo}", complete(lo), np.arange(1, lo + 1) * 10, 5003,
                       zero_beta_rows=(0,), seed=2),
        consensus_case(card, "k100_ragged_n", complete(100), np.arange(1, 101) * 6, 4099,
                       zero_beta_rows=(0, 57), seed=3),
        consensus_case(card, "k100_w_self_only", complete(100), np.full(100, 600), 20000,
                       self_only_w=True, seed=4),
        consensus_case(card, f"cap_k{cap}", complete(cap), np.arange(1, cap + 1) * 5, 50000,
                       zero_beta_rows=(5,), seed=5),
        consensus_case(card, f"gather_k{cap + 1}", complete(cap + 1), np.arange(1, cap + 2) * 5,
                       50000, zero_beta_rows=(5,), want_path="gather", seed=6),
    ]


def dequant_case(card, name, graph, sizes, leaf_offsets, n, *, dmax=None, zero_beta_rows=(),
                 zero_scale_leaves=(), payload=True, want_vector=None, want_path="tile",
                 seed=0, operands=None):
    """dequant_mix kernel vs its plain version (and the dense library product
    of the advanced estimates) at one shape.  ``leaf_offsets`` are the L + 1
    leaf boundaries; columns from the last one to ``n`` are row padding, zero
    in every input.  ``payload=False`` is top-k's call: no q, no scales.
    ``want_path`` is the design the wrapper must pick: ``"tile"`` or
    ``"gather"``.  ``operands`` (an adaptive round's dense operands on the
    card) replace the graph's."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant, ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    if operands is None:
        w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
        beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
        beta[list(zero_beta_rows)] = 0.0  # isolated for d: d must stay exactly 0
        sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    else:
        sparse = operands
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
    path = "tile" if dequant.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")

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
    dense = ref.dense_mix_operator(sparse.nbr_idx, sparse.nbr_w, sparse.beta)
    lib_out = torch.empty((2 * k, n), device=dev)
    kern = lambda: dequant.launch(x, est, q, scale, sparse, leaf_offsets,  # noqa: E731
                                  local_steps, mixed, d_out, est_out)
    plain = lambda: ref.dequant_mix_stacked_ref(  # noqa: E731
        x, est, q, scale, leaf_offsets, *sparse, local_steps)
    library = lambda: torch.matmul(dense, adv, out=lib_out)  # noqa: E731
    times = in_turns(plain, kern, library)

    # work this run's data needs: slots of nonzero weight only (padding and a
    # dense round's unselected edges weigh 0); the own estimate's advance (2
    # operations) only with a payload
    real = ((sparse.nbr_w != 0) | (sparse.beta != 0)).sum().item()
    flops = n * (4 * real + (5 if payload else 3) * k)
    nbytes = (2 * k * n * 4 + 2 * k * n * 4  # x, est in; mixed, d out
              + (k * n + k * num_leaves * 4 + k * n * 4 if payload else 0)  # q, scales; est'
              + k * 4 + 3 * k * d * 4)  # slot operands
    tile_cols = dequant.load_kernel().lib.dequant_mix_tile_columns(k) if path == "tile" else None
    return {"case": name, "K": k, "D": d, "N": n, "leaves": num_leaves, "payload": payload,
            "vector_path": vector, "path": path, "tile_columns": tile_cols, "max_abs_err": err,
            **times, **card.bound(nbytes, flops)}


def dequant_cases(card: Card, layout) -> list[dict]:
    """``dequant_mix`` at the main paths' shapes and at the edges of its two
    designs: the column tile (K <= 128) and the gather (K > 128)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant

    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    cap = dequant.TILE_MAX_PEERS
    # leaves of a 50,000-column row, every start a multiple of 4 (vector path)
    mid_leaves, mid_n = (0, 12000, 12200, 40000, 40012, 49996), 50000
    odd_leaves, odd_n = (0, 301, 302, 777, 999), 1001  # scalar path, leaves inside a tile
    cases = [
        dequant_case(card, "iid_k100_qint8", complete(100), np.full(100, 600),
                     layout.leaf_offsets, layout.row, want_vector=True),
        dequant_case(card, "tv_k8_star", graph_lib.build_graph("star", 8), np.full(8, 100),
                     layout.leaf_offsets, layout.row, want_vector=True),
        dequant_case(card, "ring_odd_leaves", graph_lib.build_graph("ring", 8),
                     np.arange(1, 9) * 10, odd_leaves, odd_n, dmax=3, zero_beta_rows=(3,),
                     zero_scale_leaves=(1,), want_vector=False),
        dequant_case(card, "ring_no_payload", graph_lib.build_graph("ring", 8),
                     np.arange(1, 9) * 10, odd_leaves, odd_n, dmax=3, zero_beta_rows=(3,),
                     payload=False, seed=1),
        dequant_case(card, "noniid_k2", complete(2), np.full(2, 100), layout.leaf_offsets,
                     layout.row, want_vector=True, seed=2),
        dequant_case(card, "k100_odd_leaves_zero_beta", complete(100), np.arange(1, 101) * 6,
                     odd_leaves, odd_n, zero_beta_rows=(0, 57), zero_scale_leaves=(1,),
                     want_vector=False, seed=3),
        dequant_case(card, "k100_no_payload", complete(100), np.full(100, 600), mid_leaves,
                     mid_n, payload=False, want_vector=True, seed=4),
        dequant_case(card, f"cap_k{cap}", complete(cap), np.arange(1, cap + 1) * 5, mid_leaves,
                     mid_n, zero_beta_rows=(5,), zero_scale_leaves=(2,), want_vector=True,
                     seed=5),
        dequant_case(card, f"gather_k{cap + 1}", complete(cap + 1),
                     np.arange(1, cap + 2) * 5, mid_leaves, mid_n, zero_beta_rows=(5,),
                     zero_scale_leaves=(2,), want_vector=True, want_path="gather", seed=6),
    ]
    main = cases[0]
    check(main["N"] % main["tile_columns"] != 0,
          f"iid_k100_qint8: N={main['N']} should leave a ragged last tile of "
          f"{main['tile_columns']} columns")
    return cases


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
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(("consensus_mix", "dequant_mix", "segment_mix", "wkv6",
                         "flash_attention", "ssd"),
                        pool.map(lambda mod: mod.load_kernel(),
                                 (ops, dequant, segment, wkv6_ops, flash_ops, ssd_ops))))
    print(f"build: all six kernels in {time.perf_counter() - start:.2f} s", flush=True)
    for name, kl in libs.items():
        print(f"  {name}: nvcc {kl.build_seconds:.2f} s -> {kl.path.relative_to(ROOT)}")
        for line in kl.log.splitlines():
            if any(w in line for w in ("Function properties", "registers", "spill", "smem",
                                       "arning", "serialized")):
                print(f"  ptxas: {line.strip()}")
    smem = {f"{name} D={d}": libs["flash_attention"].lib.flash_attention_smem_bytes(code, d)
            for name, code in (("float32", 0), ("bfloat16", 1)) for d in (32, 64, 80, 128)}
    print(f"  flash_attention dynamic shared memory per block, bytes: {smem}", flush=True)


def _print_case(kernel: str, c: dict) -> None:
    path = f"path={c['path']} vector={c['vector_path']} " if "path" in c else ""
    print(f"{kernel} {c['case']}: K={c['K']} D={c['D']} N={c['N']} {path}"
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


def push_sum_operands(sched, sizes, dev):
    """Push-sum's column-stochastic sparse schedule of ``sched`` and its upload."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops

    sparse = graph_lib.SparseSchedule.from_schedule(sched, "data_weighted", data_sizes=sizes,
                                                    stochasticity="column")
    return sparse, ops.upload_schedule(sparse, dev)


def push_sum_mass(k: int, seed: int, dev) -> torch.Tensor:
    """A positive (K,) float32 mass summing to K, as push-sum keeps it."""
    y = np.random.default_rng(seed).uniform(0.2, 2.0, k)
    return torch.as_tensor((k * y / y.sum()).astype(np.float32), device=dev)


def isolated(graph, peer: int):
    """``graph`` with every edge into and out of ``peer`` removed."""
    from repro_torch.core import graph as graph_lib

    a = graph.adjacency.copy()
    a[peer, :] = a[:, peer] = False
    return graph_lib.CommGraph(a, directed=graph.directed)


def mass_library(sparse, mass: torch.Tensor, dev, *, as_csr: bool) -> torch.Tensor:
    """[A diag(y); Beta] of round 0 as a (2K, K) float32 operator (dense, or
    CSR above K = 1000): its product with X is the push-sum numerator and
    the neighbor sum, without the division."""
    y = mass.double().cpu().numpy()
    scaled = dataclasses.replace(sparse, self_w=sparse.self_w * y[None, :],
                                 nbr_w=sparse.nbr_w * y[sparse.nbr_idx])
    return library_operator(scaled, 0, dev, as_csr=as_csr)


def check_mass_outputs(name: str, got, want, x, mass, iso) -> float:
    """Kernel against plain version: mixed, d (and est') and the new mass at
    TOL; the new mass sums to K; an isolated peer keeps its parameters (to
    the rounding of y x / y) and its mass, and its d is 0.  Returns the
    largest absolute difference."""
    err = 0.0
    names = ("mixed", "d", "est'", "new_mass") if len(got) == 4 else ("mixed", "d", "new_mass")
    for g, r, what in zip(got, want, names):
        torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - r).abs().max()))
    y_new = got[-1]
    k = y_new.shape[0]
    check(abs(float(y_new.double().sum()) - k) <= 1e-5 * k, f"{name}: sum y' = K")
    check(bool((y_new > 0).all()), f"{name}: y' > 0")
    if iso is not None:
        check(float(y_new[iso]) == float(mass[iso]), f"{name}: isolated peer keeps its mass")
        torch.testing.assert_close(got[0][iso], x[iso], rtol=1e-6, atol=0,
                                   msg=lambda m: f"{name}: isolated peer's parameters: {m}")
        check(bool((got[1][iso] == 0).all()), f"{name}: isolated peer's d is 0")
    return err


def consensus_mass_case(card, name, graph, sizes, n, *, iso=None, want_path="tile", seed=0):
    """``consensus_mix``'s mass mode (push-sum) against its plain version and
    the library product of [A diag(y); Beta]; ``iso`` isolates a peer."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    sparse, ops_s = push_sum_operands(graph_lib.static_schedule(graph), sizes, dev)
    one = ops.select_round(ops_s, 0)
    k, d = sparse.num_peers, sparse.degree_bound
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32),
                        device=dev)
    mass = push_sum_mass(k, seed, dev)
    got = ops.consensus_mix_push_sum_stacked(x, mass, one, t)
    want = ref.consensus_mix_push_sum_stacked_ref(x, mass, *one, t)
    torch.cuda.synchronize()
    err = check_mass_outputs(name, got, want, x, mass, iso)
    del got, want

    mixed, d_out, new_mass = torch.empty_like(x), torch.empty_like(x), torch.empty_like(mass)
    lib_op = mass_library(sparse, mass, dev, as_csr=False)
    lib_out = torch.empty((2 * k, n), device=dev)
    times = in_turns(lambda: ref.consensus_mix_push_sum_stacked_ref(x, mass, *one, t),
                     lambda: ops.launch(x, one, t, mixed, d_out, mass, new_mass),
                     lambda: torch.matmul(lib_op, x, out=lib_out))
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    flops = n * (4 * real + 4 * k) + 2 * (real + k)  # gossip's, a divide a row, y'
    nbytes = 3 * k * n * 4 + k * 4 + 3 * k * d * 4 + 2 * k * 4  # gossip's, mass in and out
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "max_abs_err": err, **times, **card.bound(nbytes, flops)}


def dequant_mass_case(card, name, graph, sizes, layout, *, iso=None, want_path="tile", seed=0):
    """``dequant_mix``'s mass mode (compressed push-sum, qint8 at the 2NN's
    row) against its plain version and the library product of
    [A diag(y); Beta] with the advanced estimates."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant, ops, ref

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    sparse, ops_s = push_sum_operands(graph_lib.static_schedule(graph), sizes, dev)
    one = ops.select_round(ops_s, 0)
    k, d = sparse.num_peers, sparse.degree_bound
    path = "tile" if dequant.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    n, size, leaves = layout.row, layout.size, layout.leaf_offsets
    rng = np.random.default_rng(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.as_tensor(rng.normal(size=(k, size)).astype(np.float32), device=dev)
    est = x + torch.as_tensor(0.01 * rng.normal(size=(k, n)).astype(np.float32), device=dev)
    est[:, size:] = 0.0
    q = torch.zeros(k, n, dtype=torch.int8, device=dev)
    q[:, :size] = torch.as_tensor(rng.integers(-127, 128, (k, size)).astype(np.int8), device=dev)
    scale = torch.as_tensor(rng.uniform(0, 1e-4, (k, len(leaves) - 1)).astype(np.float32),
                            device=dev)
    mass = push_sum_mass(k, seed, dev)
    got = dequant.dequant_mix_push_sum_stacked(x, est, q, scale, mass, one, leaves, t)
    want = ref.dequant_mix_push_sum_stacked_ref(x, est, q, scale, leaves, mass, *one, t)
    torch.cuda.synchronize()
    err = check_mass_outputs(name, got, want, x, mass, iso)
    adv = want[2]
    del got, want

    outs = [torch.empty_like(x) for _ in range(3)]
    new_mass = torch.empty_like(mass)
    lib_op = mass_library(sparse, mass, dev, as_csr=False)
    lib_out = torch.empty((2 * k, n), device=dev)
    times = in_turns(
        lambda: ref.dequant_mix_push_sum_stacked_ref(x, est, q, scale, leaves, mass, *one, t),
        lambda: dequant.launch(x, est, q, scale, one, leaves, t, *outs, mass, new_mass),
        lambda: torch.matmul(lib_op, adv, out=lib_out))
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    flops = n * (4 * real + 6 * k) + 2 * (real + k)
    nbytes = (4 * k * n * 4 + k * n + k * (len(leaves) - 1) * 4 + k * n * 4 + k * 4
              + 3 * k * d * 4 + 2 * k * 4)
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": True,
            "max_abs_err": err, **times, **card.bound(nbytes, flops)}


def segment_mass_case(card, name, graph, sizes, n, *, size=None, iso=None, seed=0):
    """``segment_mix``'s mass mode (push-sum on the one-slice segment
    runtime) against its plain version and the library product of
    [A diag(y); Beta] (CSR above K = 1000)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ref, segment

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    sparse, ops_s = push_sum_operands(graph_lib.static_schedule(graph), sizes, dev)
    k, d = sparse.num_peers, sparse.degree_bound
    size = n if size is None else size
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.randn(k, size, generator=gen, device=dev)
    mass = push_sum_mass(k, seed, dev)
    got = segment.segment_mix_push_sum_schedule(x, mass, 0, ops_s, t)
    want = ref.segment_mix_push_sum_stacked_ref(x, mass, *(a[0] for a in ops_s), t)
    torch.cuda.synchronize()
    err = check_mass_outputs(name, got, want, x, mass, iso)
    del got, want

    mixed, d_out, new_mass = torch.empty_like(x), torch.empty_like(x), torch.empty_like(mass)
    as_csr = k > 1000
    lib_op = mass_library(sparse, mass, dev, as_csr=as_csr)
    library = ((lambda: torch.sparse.mm(lib_op, x)) if as_csr  # noqa: E731
               else (lambda: torch.matmul(lib_op, x)))
    times = in_turns(
        lambda: ref.segment_mix_push_sum_stacked_ref(x, mass, *(a[0] for a in ops_s), t),
        lambda: segment.launch(x, 0, ops_s, t, mixed, d_out, mass, new_mass), library)
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    flops = n * (4 * real + 4 * k) + 2 * (real + k)
    nbytes = 3 * k * n * 4 + k * 4 + 3 * k * d * 4 + 2 * k * 4
    out = {"case": name, "K": k, "D": d, "N": n, "vector_path": n % 4 == 0,
           "library": "torch.sparse.mm (CSR [A diag(y); Beta])" if as_csr else "torch.matmul",
           "max_abs_err": err, **times, **card.bound(nbytes, flops)}
    del x, mixed, d_out, lib_op
    torch.cuda.empty_cache()
    return out


def mass_cases(card: Card) -> dict[str, list[dict]]:
    """The mass mode (push-sum) of the three consensus kernels at the
    push-sum paths' shapes: ``directed_k8`` (K = 8, directed ring, gather /
    tile for qint8), ``iid_k100 --protocol push_sum`` (K = 100, tile), one
    K past the tile cap (gather), the K = 4096 directed ring on the segment
    kernel, and one case each with an isolated peer."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of
    from repro_torch.kernels.consensus_mix import ops

    layout = layout_of("mnist_mlp")
    row = layout.row
    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    ring8 = graph_lib.build_graph("directed_ring", 8)
    k8_sizes = np.array([150, 150, 150, 150, 100, 100, 100, 100])  # directed_k8's shards
    cap = ops.TILE_MAX_PEERS
    large_k_sizes = np.where(np.arange(LARGE_K) < 60000 % LARGE_K, 15, 14)
    return {
        "consensus_mix": [
            consensus_mass_case(card, "directed_k8", ring8, k8_sizes, row, want_path="gather"),
            consensus_mass_case(card, "iid_k100", complete(100), np.full(100, 600), row, seed=1),
            consensus_mass_case(card, f"gather_k{cap + 1}", complete(cap + 1),
                                np.arange(1, cap + 2) * 5, 50000, want_path="gather", seed=2),
            consensus_mass_case(card, "k16_isolated_peer", complete(16), np.arange(1, 17) * 10,
                                5003, iso=3, seed=3),
        ],
        "dequant_mix": [
            dequant_mass_case(card, "directed_k8_qint8", ring8, k8_sizes, layout),
            dequant_mass_case(card, "iid_k100_qint8", complete(100), np.full(100, 600), layout,
                              seed=1),
            dequant_mass_case(card, f"gather_k{cap + 1}_qint8", complete(cap + 1),
                              np.arange(1, cap + 2) * 5, layout, want_path="gather", seed=2),
            dequant_mass_case(card, "directed_k8_isolated_peer", ring8, k8_sizes, layout,
                              iso=5, seed=3),
        ],
        "segment_mix": [
            segment_mass_case(card, f"directed_ring_k{LARGE_K}",
                              graph_lib.build_graph("directed_ring", LARGE_K), large_k_sizes,
                              row, size=layout.size),
            segment_mass_case(card, "directed_ring_k64_isolated_peer",
                              graph_lib.build_graph("directed_ring", 64), np.arange(64) % 5 + 10,
                              1001, iso=7, seed=1),
        ],
    }


STALE_BOUND = 3  # straggler_k8's staleness bound: the ages the snapshot cases draw


def snapshot_case(card, name, graph, sizes, n, *, mass=False, iso=None, want_path="tile",
                  seed=0):
    """``consensus_mix``'s snapshot mode (bounded-staleness consensus), gossip
    or with ``mass`` its mass mode, against its plain version and the
    library product ``[W_off; Beta] P`` (mass: ``[A_off diag(y); Beta] P``),
    on the round's operands age-decayed (``protocols.age_decayed_operands``)
    by random ages up to ``STALE_BOUND``.  The published buffer P is x
    perturbed, so every own row is stale and d must read the live x_k.
    ``iso`` isolates a peer: it keeps its parameters (and its mass) and its
    d is 0."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import protocols
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    stochasticity = "column" if mass else "row"
    sparse = graph_lib.SparseSchedule.from_schedule(
        graph_lib.static_schedule(graph), "data_weighted", data_sizes=sizes,
        stochasticity=stochasticity)
    k, d = sparse.num_peers, sparse.degree_bound
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    rng = np.random.default_rng(seed)
    stale = protocols.StaleRoundOps(
        *ops.select_round(ops.upload_schedule(sparse, dev), 0),
        torch.as_tensor(protocols.column_sums(sparse)[0], device=dev),
        torch.zeros(k, dtype=torch.bool, device=dev))
    age = rng.integers(0, STALE_BOUND + 1, k)
    decay = torch.as_tensor((0.5 ** age).astype(np.float32), device=dev)
    a_ops = protocols.age_decayed_operands(stale, decay, stochasticity)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    pub = x + torch.as_tensor(0.05 * rng.normal(size=(k, n)).astype(np.float32), device=dev)
    y = push_sum_mass(k, seed, dev) if mass else None
    if mass:
        got = ops.consensus_mix_push_sum_snapshot_stacked(x, pub, y, a_ops, t)
        want = ref.consensus_mix_push_sum_stacked_ref(x, y, *a_ops, t, published=pub)
    else:
        got = ops.consensus_mix_snapshot_stacked(x, pub, a_ops, t)
        want = ref.consensus_mix_stacked_ref(x, *a_ops, t, published=pub)
    torch.cuda.synchronize()
    if mass:
        err = check_mass_outputs(name, got, want, x, y, iso)
    else:
        err = 0.0
        for g, r, what in zip(got, want, ("mixed", "d")):
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
            err = max(err, float((g - r).abs().max()))
        if iso is not None:
            check(bool(torch.equal(got[0][iso], x[iso])), f"{name}: isolated peer keeps x")
            check(bool((got[1][iso] == 0).all()), f"{name}: isolated peer's d is 0")
    # d's own term is the live row: with the stale own row it would differ
    live = int(np.argmax(np.asarray(a_ops.beta.sum(dim=1).cpu()) > 0))
    wrong = (want[1][live] * t + x[live] - pub[live]) / t
    check(not torch.allclose(got[1][live], wrong, **TOL), f"{name}: d reads the live x_k")
    del got, want

    outs = [torch.empty_like(x), torch.empty_like(x)]
    mass_args = (y, torch.empty_like(y)) if mass else ()
    w_off = torch.zeros(k, k, dtype=torch.float32, device=dev)
    rows = torch.arange(k, device=dev).repeat_interleave(d)
    cols = a_ops.nbr_idx.long().reshape(-1)
    w_vals = a_ops.nbr_w * (y[a_ops.nbr_idx.long()] if mass else 1.0)
    beta_d = torch.zeros(k, k, dtype=torch.float32, device=dev)
    w_off.index_put_((rows, cols), w_vals.reshape(-1), accumulate=True)
    beta_d.index_put_((rows, cols), a_ops.beta.reshape(-1), accumulate=True)
    lib_op = torch.cat([w_off, beta_d])
    lib_out = torch.empty((2 * k, n), device=dev)
    if mass:
        plain = lambda: ref.consensus_mix_push_sum_stacked_ref(  # noqa: E731
            x, y, *a_ops, t, published=pub)
    else:
        plain = lambda: ref.consensus_mix_stacked_ref(x, *a_ops, t, published=pub)  # noqa: E731
    times = in_turns(plain,
                     lambda: ops.launch(x, a_ops, t, *outs, *mass_args, published=pub),
                     lambda: torch.matmul(lib_op, pub, out=lib_out))
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    flops = n * (4 * real + (4 if mass else 3) * k) + (2 * (real + k) if mass else 0)
    # x and P read once, mixed and d written once, the operands (and the mass)
    nbytes = 4 * k * n * 4 + k * 4 + 3 * k * d * 4 + (2 * k * 4 if mass else 0)
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "weights": "mass" if mass else "gossip", "max_abs_err": err, **times,
            **card.bound(nbytes, flops)}


def snapshot_cases(card: Card) -> list[dict]:
    """The snapshot mode of ``consensus_mix`` in both designs and both weight
    modes: ``straggler_k8``'s K = 8 ring (gather), K = 100 complete at the
    2NN's row (tile: ``iid_k100`` with a staleness bound), K = 129 past the
    tile's cap (gather), and K = 16 with an isolated peer whose own row is
    stale (tile)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of
    from repro_torch.kernels.consensus_mix import ops

    row = layout_of("mnist_mlp").row
    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    ring8 = graph_lib.build_graph("ring", 8)
    cap = ops.TILE_MAX_PEERS
    cases = []
    for mass in (False, True):
        tag = "_mass" if mass else ""
        cases += [
            snapshot_case(card, f"straggler_k8{tag}", ring8, np.full(8, 100), row, mass=mass,
                          want_path="gather"),
            snapshot_case(card, f"iid_k100{tag}", complete(100), np.full(100, 600), row,
                          mass=mass, seed=1),
            snapshot_case(card, f"gather_k{cap + 1}{tag}", complete(cap + 1),
                          np.arange(1, cap + 2) * 5, 50000, mass=mass, want_path="gather",
                          seed=2),
            snapshot_case(card, f"k16_isolated_stale{tag}", complete(16),
                          np.arange(1, 17) * 10, 5003, mass=mass, iso=3, seed=3),
        ]
    return cases


def matching_operands(k: int, *, mass: bool, seed: int):
    """An adaptive round's dense (K, K) W and Beta computed on the card
    (``graph.adaptive_round_matrices``, loss proximity over random losses,
    ``timevarying_k8``-like data sizes; column-stochastic with ``mass``),
    and the kernel's operands gathered from them (``ops.dense_operands``)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import prng
    from repro_torch.kernels.consensus_mix import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    losses = torch.as_tensor(rng.uniform(1.0, 2.5, k).astype(np.float32), device=dev)
    sizes = torch.as_tensor((100 + 50 * (np.arange(k) % 3)).astype(np.float32), device=dev)
    w, beta = graph_lib.adaptive_round_matrices(
        losses, prng.prng_key(seed, dev), data_sizes=sizes,
        stochasticity="column" if mass else "row")
    return w, beta, ops.dense_operands(w, beta, ops.complete_candidates(k, dev))


def dense_case(card, name, k, n, *, mass=False, want_path="tile", with_d1=False, seed=0):
    """``consensus_mix`` on an adaptive round's dense operands (every j != k
    a slot, one of them weighted), gossip or with ``mass`` its mass mode,
    against its plain version on the same operands and the library product
    ``[W_off; Beta] X`` (mass: ``[A_off diag(y); Beta] X``).  An odd K
    leaves one peer unmatched: its parameters (and mass) stay, its d is 0.
    ``with_d1`` also times the kernel on the same matching's D = 1 sparse
    operands (``ops.sparse_from_matrices``), the rows the dense operands
    read but weight 0 left out."""
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    t = 10
    w, beta, dense = matching_operands(k, mass=mass, seed=seed)
    d = dense.nbr_idx.shape[1]
    check(d == k - 1, f"{name}: D = {d}, want K - 1")
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    lone = torch.nonzero(beta.sum(dim=1) == 0).flatten().tolist()
    check(len(lone) == k % 2, f"{name}: {len(lone)} unmatched peers, want {k % 2}")
    iso = lone[0] if lone else None
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    y = push_sum_mass(k, seed, dev) if mass else None
    if mass:
        got = ops.consensus_mix_push_sum_dense(x, y, w, beta, t)
        want = ref.consensus_mix_push_sum_stacked_ref(x, y, *dense, t)
        torch.cuda.synchronize()
        err = check_mass_outputs(name, got, want, x, y, iso)
    else:
        got = ops.consensus_mix_dense(x, w, beta, t)
        want = ref.consensus_mix_stacked_ref(x, *dense, t)
        torch.cuda.synchronize()
        err = 0.0
        for g, r, what in zip(got, want, ("mixed", "d")):
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
            err = max(err, float((g - r).abs().max()))
        if iso is not None:
            check(bool(torch.equal(got[0][iso], x[iso])), f"{name}: unmatched peer keeps x")
            check(bool((got[1][iso] == 0).all()), f"{name}: unmatched peer's d is 0")
    del want

    outs = [torch.empty_like(x), torch.empty_like(x)]
    mass_args = (y, torch.empty_like(y)) if mass else ()
    nbr_w = dense.nbr_w * y[dense.nbr_idx.long()] if mass else dense.nbr_w
    lib_op = ref.dense_mix_operator(dense.nbr_idx, nbr_w, dense.beta)
    lib_out = torch.empty((2 * k, n), device=dev)
    plain_fn = ref.consensus_mix_push_sum_stacked_ref if mass else ref.consensus_mix_stacked_ref
    times = in_turns(lambda: plain_fn(x, *((y,) if mass else ()), *dense, t),
                     lambda: ops.launch(x, dense, t, *outs, *mass_args),
                     lambda: torch.matmul(lib_op, x, out=lib_out))
    extra = {}
    if with_d1:
        sparse = ops.sparse_from_matrices(w.double().cpu().numpy(), beta.double().cpu().numpy(),
                                          device=dev)
        check(sparse.nbr_idx.shape[1] == 1, f"{name}: the matching's sparse operands have D = 1")
        d1_out = [torch.empty_like(x), torch.empty_like(x)]
        ops.launch(x, sparse, t, *d1_out)
        for g, r, what in zip(d1_out, got, ("mixed", "d")):
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} D = 1 {what}: {m}")
        extra = {"sparse_d1_ms": cuda_ms(lambda: ops.launch(x, sparse, t, *d1_out)),
                 "dense_ms_same_call": cuda_ms(lambda: ops.launch(x, dense, t, *outs))}
    # work this run's data needs: the matched slots (nonzero weight) only
    real = int(((dense.nbr_w != 0) | (dense.beta != 0)).sum())
    flops = n * (4 * real + (4 if mass else 3) * k) + (2 * (real + k) if mass else 0)
    nbytes = 3 * k * n * 4 + k * 4 + 3 * k * d * 4 + (2 * k * 4 if mass else 0)
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "weights": "mass" if mass else "gossip", "matched_slots": real,
            "max_abs_err": err, **times, **extra, **card.bound(nbytes, flops)}


def dense_cases(card: Card) -> dict[str, list[dict]]:
    """Adaptive rounds' dense operands at the 2NN's row: ``consensus_mix`` at
    K = 8 (gather, D = 7; also timed on the D = 1 sparse operands of the
    same matching), K = 9 (one unmatched peer) and K = 100 (tile, D = 99),
    its mass mode at K = 8 and 100, and ``dequant_mix`` (qint8) at K = 8
    (tile)."""
    from repro_torch.core.p2p import layout_of

    layout = layout_of("mnist_mlp")
    row = layout.row
    _, _, k8 = matching_operands(8, mass=False, seed=4)
    return {
        "consensus_mix": [
            dense_case(card, "adaptive_k8", 8, row, want_path="gather", with_d1=True),
            dense_case(card, "adaptive_k9_unmatched", 9, row, want_path="gather", seed=1),
            dense_case(card, "adaptive_k100", 100, row, seed=2),
            dense_case(card, "adaptive_k8_mass", 8, row, mass=True, want_path="gather",
                       seed=3),
            dense_case(card, "adaptive_k100_mass", 100, row, mass=True, seed=5),
        ],
        "dequant_mix": [
            dequant_case(card, "adaptive_k8_qint8", None, None, layout.leaf_offsets, row,
                         want_vector=True, seed=4, operands=k8),
        ],
    }


def check_matching_on_card() -> dict:
    """Each rule's ``adaptive_round_matrices`` on the card against the CPU's
    for the same losses and key: partner (via the matching), W and Beta
    equal, both stochasticities, at K = 8 and 9, the all-zero-loss round
    (every pair ties: ``torch.argmin``'s first flat index on the card, the
    pairing (0, 1), (2, 3), ...) among them."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import prng

    dev = torch.device("cuda")
    checked = 0
    for k in (8, 9):
        for seed in range(4):
            losses = np.random.default_rng(seed).uniform(0.5, 2.5, k).astype(np.float32)
            if seed == 0:
                losses[:] = 0.0
            for rule in graph_lib.ADAPTIVE_RULES:
                out = {}
                for where in ("cpu", dev):
                    l_t, key = torch.as_tensor(losses, device=where), prng.prng_key(seed, where)
                    partner = graph_lib.greedy_matching(
                        graph_lib.partner_scores(l_t, key, rule, 0.5))
                    mats = [graph_lib.adaptive_round_matrices(
                        l_t, key, rule=rule, eps=0.5, data_sizes=torch.arange(
                            1.0, k + 1, device=where), stochasticity=st)
                        for st in ("row", "column")]
                    out[str(where)] = [partner, *(m for pair in mats for m in pair)]
                for a, b in zip(out["cpu"], out[str(dev)]):
                    check(torch.equal(a, b.cpu()), f"matching K={k} seed {seed} {rule}: the "
                                                   "card's differs from the CPU's")
                if seed == 0 and rule == "loss_proximity":
                    pairs = out[str(dev)][0].cpu().tolist()
                    want = [i + 1 if i % 2 == 0 else i - 1 for i in range(k - k % 2)]
                    check(pairs[:k - k % 2] == want, f"K={k}: round 0 pairs {pairs}")
                checked += 1
    print(f"matching on the card equals the CPU's: {checked} (K, losses, key, rule) cases, "
          "partner, W and Beta, row and column", flush=True)
    return {"cases": checked}


def selection_profile(card: Card, exp, data) -> dict:
    """The device time of one adaptive round's selection (the key split, the
    scores, the greedy matching, W and Beta, the dense operands:
    ``p2p.adaptive_operands``) at ``exp``'s K, for each rule: the host's
    seconds of an eager call, its kernel count and device time
    (torch.profiler), and a replay of it alone captured as a CUDA graph
    (CUDA events)."""
    from repro_torch import capture as capture_lib
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import p2p, task as task_lib

    dev = torch.device("cuda")
    out = {"card": card.line}
    for rule in graph_lib.ADAPTIVE_RULES:
        cfg = dataclasses.replace(exp.p2p, partner_rule=rule)
        state = p2p.init_state(task_lib.get_task(cfg.model), cfg, device=dev)
        ad = state.adaptive._replace(last_losses=torch.linspace(1.0, 2.0, cfg.num_peers,
                                                                device=dev))
        ops = p2p.round_operands(cfg, device=dev)[0]
        select = lambda: p2p.adaptive_operands(ad, cfg, ops)  # noqa: E731
        select()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            select()
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - start) / 20
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            select()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        captured = capture_lib.capture(select, dev)
        out[rule] = {"eager_host_s": eager_s,
                     "kernels": sum(e.count for e in kernels),
                     "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                     "graph_replay_ms": cuda_ms(captured.replay)}
        del captured
    print(f"selection ({card.line}): {json.dumps(out)}", flush=True)
    return out


WKV6_TOL = dict(atol=1e-3, rtol=1e-3)  # float32, the wkv6 tolerance of tests/test_kernels.py
# bf16 r, k, v and output: both sides compute in float32 from the same bf16
# values, and the kernel rounds its float32 output once to bf16 (at most 2^-9
# of it), so each entry is held within WKV6_TOL plus that rounding
WKV6_BF16_TOL = dict(atol=1e-3, rtol=1e-3 + 2**-8)


def wkv6_work(b: int, t: int, h: int, dk: int, q: int, *, state: bool, in_bytes: int = 4,
              out_bytes: int = 4):
    """(bytes, FLOP) one wkv6 call needs: r, k, v (``in_bytes`` each) and
    the float32 log-decays, u and the state in (when given) read once, the
    output and the final state written once; per (b, h) and chunk of n real
    tokens the operations of the chunk form (an exp counts as one)."""
    nbytes = (3 * in_bytes + 4) * b * t * h * dk + h * dk * 4 + b * t * h * dk * out_bytes
    nbytes += (2 if state else 1) * b * h * dk * dk * 4
    flops = 0
    for start in range(0, t, q):
        n = min(q, t - start)
        flops += (5 * dk * n * (n - 1) // 2  # att below the diagonal: sub, exp, 3 FMA-ish
                  + 3 * n * dk  # the bonus on the diagonal
                  + 2 * n * dk + 5 * n * dk  # prefix sums; the decayed r and k
                  + n * (n + 1) * dk  # sum_s att[t, s] v[s]
                  + 2 * n * dk * dk  # (r * exp(cum_ex)) S
                  + 2 * dk * dk + 2 * n * dk * dk)  # the state update
    return nbytes, b * h * flops


def wkv6_case(card, name, b, t, h, dk, chunk, *, state=False, ld=None, timed=False,
              dtype=torch.float32, seed=0):
    """wkv6 kernel vs its plain version on the card at one shape; ``ld`` is
    a constant log-decay, or (low, high) for a uniform draw of -ld; r, k
    and v in ``dtype`` (bf16: the served type; the log-decays stay float32)."""
    from repro_torch.kernels.rwkv6 import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype) for _ in range(3))
    if isinstance(ld, float):
        logd = torch.full((b, t, h, dk), ld, device=dev)
    else:
        low, high = ld or (0.01, 4.0)  # tests/test_kernels.py's draw
        logd = -(low + (high - low) * torch.rand(b, t, h, dk, generator=gen, device=dev))
    u = 0.5 * torch.randn(h, dk, generator=gen, device=dev)
    s0 = torch.randn(b, h, dk, dk, generator=gen, device=dev) if state else None

    got, got_s = ops.wkv6(r, k, v, logd, u, state=s0, chunk=chunk)
    want, want_s = ref.wkv6_chunked_ref(r, k, v, logd, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    check(got.dtype == dtype, f"wkv6 {name}: output in r's type {dtype}, got {got.dtype}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(got_s).all()), f"wkv6 {name} finite")
    err = 0.0
    for g, w, what, tol in ((got, want, "out", WKV6_BF16_TOL if dtype == torch.bfloat16
                             else WKV6_TOL), (got_s, want_s, "final state", WKV6_TOL)):
        torch.testing.assert_close(g.float(), w, **tol, msg=lambda m: f"wkv6 {name} {what}: {m}")
        err = max(err, float((g.float() - w).abs().max()))
    case = {"case": name, "B": b, "T": t, "H": h, "dk": dk, "chunk": min(chunk, t),
            "state": state, "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "max_abs_out": float(want.abs().max())}
    if state:  # the state in must matter here: a zero state gives another result
        zero_s = ops.wkv6(r, k, v, logd, u, chunk=chunk)[1]
        case["state_effect"] = float((zero_s - got_s).abs().max())
        check(case["state_effect"] > 1e-2, f"wkv6 {name}: the initial state reaches the end")
    if timed:
        q = min(chunk, t)
        out = torch.empty_like(r)
        final = torch.empty(b, h, dk, dk, device=dev)
        kern = lambda: ops.launch(r, k, v, logd, u, s0, q, out, final)  # noqa: E731
        plain = lambda: ref.wkv6_chunked_ref(r, k, v, logd, u, s0, chunk=q)  # noqa: E731
        case.update(in_turns(plain, kern, None))
        es = r.element_size()
        case.update(card.bound(*wkv6_work(b, t, h, dk, q, state=state, in_bytes=es,
                                          out_bytes=es)))
    return case


def wkv6_cases(card: Card) -> list[dict]:
    """``wkv6`` at the serving prefill's shape (B 4, T 1024, 64 heads of 64,
    chunk 16) and at its edges."""
    small = (1e-4, 2e-3)  # decays summing to ~1 over 1024 tokens: the state survives
    cases = [
        wkv6_case(card, "main_b4_t1024", 4, 1024, 64, 64, 16, timed=True),
        wkv6_case(card, "main_b4_t1024_state", 4, 1024, 64, 64, 16, state=True, ld=small,
                  seed=1),
        wkv6_case(card, "ragged_t1000", 4, 1000, 64, 64, 16, state=True, ld=small, seed=2),
        wkv6_case(card, "extreme_decay", 4, 1024, 64, 64, 16, ld=-50.0, seed=3),
        wkv6_case(card, "short_t5", 4, 5, 64, 64, 16, state=True, ld=small, seed=4),
        wkv6_case(card, "b1_t4096", 1, 4096, 64, 64, 16, timed=True, seed=5),
        # the served type: bf16 r, k, v and output, float32 log-decays
        wkv6_case(card, "main_b4_t1024_bf16", 4, 1024, 64, 64, 16, timed=True,
                  dtype=torch.bfloat16, seed=7),
        wkv6_case(card, "ragged_t1001_q48_state_bf16", 2, 1001, 8, 64, 48, state=True, ld=small,
                  dtype=torch.bfloat16, seed=8),
    ]
    for t, h, dk, chunk in ((64, 2, 32, 16), (32, 4, 16, 8), (48, 1, 64, 48)):
        cases.append(wkv6_case(card, f"sweep_t{t}_h{h}_dk{dk}_q{chunk}", 2, t, h, dk, chunk,
                               state=True, ld=small, seed=6))
    # the narrower heads' instantiations at the chunk's extremes
    for dk, chunk in ((16, 1), (16, 64), (32, 1), (32, 64)):
        cases.append(wkv6_case(card, f"dk{dk}_q{chunk}", 2, 200, 3, dk, chunk, state=True,
                               ld=small, seed=9))
    # the general form at the longest chunk in float32 (218 KB of shared
    # memory), where the heads leave SMs free (B 1) and where they do not (B 4)
    for b in (1, 4):
        cases.append(wkv6_case(card, f"dk64_q64_b{b}", b, 300, 64, 64, 64, state=True,
                               ld=small, seed=10))
    torch.cuda.empty_cache()
    return cases


def _print_wkv6_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library=none "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']})")
    print(f"wkv6 {c['case']}: B={c['B']} T={c['T']} H={c['H']} dk={c['dk']} chunk={c['chunk']} "
          f"state={c['state']} {c['dtype']} max_abs_err={c['max_abs_err']:.3g} "
          f"(max |out| {c['max_abs_out']:.4g}){times}", flush=True)


# bf16 kernel vs plain version.  An output row averages up to S value rows, so
# at S = 1024..8192 its entries are about 0.02..0.06: the reference's test
# tolerance (5e-2) would pass a kernel that drops a KV tile.  Here each entry
# is held within 1e-2 + 1e-2 |want| (one bf16 step at |out| ~ 3 is 0.0156), and
# the whole output within 1e-2 of the plain version's norm.
FLASH_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FLASH_REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LIBRARY_BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # SDPA, the yardstick, as tests/test_kernels.py


def check_flash(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Hold a flash output to the plain version's: every entry (float32
    ``TOL``, bf16 ``FLASH_BF16_TOL``) and the relative norm of the
    difference (``FLASH_REL_NORM``).  Returns the errors."""
    g, w = got.float(), want.float()
    check(got.dtype == want.dtype and bool(torch.isfinite(g).all()), f"{what} finite")
    tol = TOL if got.dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{what}: {m}")
    rel = rel_norm(g, w)
    check(rel < FLASH_REL_NORM[got.dtype],
          f"{what}: relative norm error {rel} >= {FLASH_REL_NORM[got.dtype]}")
    return {"max_abs_err": float((g - w).abs().max()), "rel_norm_err": rel,
            "max_abs": float(w.abs().max())}


def flash_live_pairs(s: int, *, causal: bool, window: int | None) -> int:
    """(q, k) pairs with key k visible to query q, for one (batch row, head)."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, np.int64)
    hi = q if causal else np.full(s, s - 1)
    return int((hi - lo + 1).sum())


def flash_work(b, s, h, kh, d, *, causal, window, elem_bytes):
    """(bytes, FLOP) one flash call needs: q, k, v read once, o written once;
    4 D operations (two multiply-adds of D) per live (q, k) pair."""
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elem_bytes
    return nbytes, 4 * d * b * h * flash_live_pairs(s, causal=causal, window=window)


def visible_mask(s: int, *, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, S) bool, True where the key is visible: SDPA's ``attn_mask``."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = (ki <= qi) if causal else torch.ones(s, s, dtype=torch.bool, device=device)
    return mask & ((qi - ki) < window) if window else mask


def flash_case(card, name, b, s, h, kh, d, *, causal=True, window=None, dtype=torch.bfloat16,
               timed=False, transposed=False, want_route=None, seed=0):
    """flash_attention kernel vs its plain version on the card at one shape
    (q (B, S, H, D), k and v (B, S, Kh, D), normal draws); ``timed`` also
    times kernel, plain version and SDPA (``is_causal`` without a window, a
    boolean mask with one) in turns, SDPA's output checked first, and the
    host's cost of one launch (the tensor maps included).  ``transposed``
    enters through ``flash_attention``'s (B, H, S, D) layout.  The route
    (``ops.kernel_route``) must be the kernel library's own, and
    ``want_route`` where given."""
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    route = ops.kernel_route(dtype, d)
    check(route == ops.ROUTES[ops.load_kernel().lib.flash_attention_route(
        ops.DTYPE_CODES[dtype], d)], f"flash {name}: the wrapper's route {route} is the kernel's")
    check(want_route is None or route == want_route, f"flash {name}: route {route}, "
          f"want {want_route}")
    if transposed:  # the reference kernel's (B, H, S, D) entry, read in place
        bhsd = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
        got = ops.flash_attention(*bhsd, causal=causal, window=window).transpose(1, 2)
        views = [x.transpose(1, 2) for x in bhsd]
        check(all(ops._kernel_operand(x) is x for x in views),
              f"flash {name}: the transposed views are read in place, not copied")
        del bhsd, views
    else:
        got = ops.gqa_flash_attention(q, k, v, causal=causal, window=window)
    want = ref.gqa_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    case = {"case": name, "B": b, "S": s, "H": h, "Kh": kh, "D": d, "causal": causal,
            "window": window, "dtype": str(dtype).removeprefix("torch."), "route": route,
            **check_flash(got, want, f"flash {name}")}
    if timed:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            library = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
        else:
            mask = visible_mask(s, causal=causal, window=window, device=dev)
            library = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_out = library().transpose(1, 2).float()
        torch.testing.assert_close(lib_out, want.float(),
                                   **(TOL if dtype == torch.float32 else LIBRARY_BF16_TOL),
                                   msg=lambda m: f"flash {name} SDPA: {m}")
        case["library_max_abs_err"] = float((lib_out - want.float()).abs().max())
        del lib_out
        out = torch.empty_like(q)
        scale = d**-0.5
        kern = lambda: ops.launch(q, k, v, out, causal=causal, window=window,  # noqa: E731
                                  scale=scale)
        plain = lambda: ref.gqa_attention_ref(q, k, v, causal=causal, window=window)  # noqa: E731
        case.update(in_turns(plain, kern, library))
        torch.cuda.synchronize()
        start, reps = time.perf_counter(), 20
        for _ in range(reps):
            kern()
        case["host_us_per_launch"] = (time.perf_counter() - start) / reps * 1e6
        torch.cuda.synchronize()
        case.update(card.bound(*flash_work(b, s, h, kh, d, causal=causal, window=window,
                                           elem_bytes=q.element_size()),
                               bf16=dtype == torch.bfloat16))
    del q, k, v, got, want
    return case


def flash_cases(card: Card) -> list[dict]:
    """``flash_attention`` at the decoder prefill's shapes and at its edges."""
    f32 = torch.float32
    wg = "wgmma"
    cases = [
        flash_case(card, "main_minitron", 4, 1024, 32, 8, 128, timed=True, want_route=wg),
        flash_case(card, "phi4_group3", 1, 2048, 24, 8, 128, want_route=wg, seed=1),
        flash_case(card, "long_window4096", 1, 8192, 32, 8, 128, window=4096, timed=True,
                   want_route=wg, seed=2),
        flash_case(card, "ragged_s1000", 2, 1000, 32, 8, 128, want_route=wg, seed=3),
        flash_case(card, "tiny_s5", 1, 5, 32, 8, 128, want_route=wg, seed=4),
        flash_case(card, "noncausal_f32", 2, 512, 4, 4, 64, causal=False, dtype=f32, seed=5),
        flash_case(card, "smollm", 2, 512, 9, 3, 64, want_route="mma_sync", seed=6),
        flash_case(card, "zamba2_d80", 4, 1024, 32, 32, 80, timed=True, want_route=wg, seed=7),
        flash_case(card, "qwen3moe_group16", 4, 1024, 64, 4, 128, timed=True, want_route=wg,
                   seed=19),
        flash_case(card, "reduced_d32_f32", 2, 128, 4, 2, 32, dtype=f32, seed=8),
        # the wgmma design's edges: rows ragged against 128-row tiles, a
        # window that is a multiple of no tile, both served widths at the
        # prefill's shape, the (B, H, S, D) entry
        flash_case(card, "ragged_s129", 2, 129, 32, 8, 128, want_route=wg, seed=10),
        flash_case(card, "ragged_s1000_d80", 2, 1000, 32, 32, 80, want_route=wg, seed=11),
        flash_case(card, "tiny_s5_d80", 1, 5, 32, 32, 80, want_route=wg, seed=12),
        flash_case(card, "window4000_s8192", 1, 8192, 32, 8, 128, window=4000, want_route=wg,
                   seed=13),
        flash_case(card, "group3_d80", 1, 1024, 24, 8, 80, want_route=wg, seed=14),
        flash_case(card, "noncausal_d128", 2, 1000, 8, 2, 128, causal=False, want_route=wg,
                   seed=15),
        flash_case(card, "d128_b4_s1024_mha", 4, 1024, 32, 32, 128, want_route=wg, seed=16),
        flash_case(card, "transposed_bhsd_d128", 2, 1024, 32, 8, 128, transposed=True,
                   want_route=wg, seed=17),
        flash_case(card, "transposed_bhsd_d80", 2, 1000, 32, 32, 80, transposed=True,
                   want_route=wg, seed=18),
    ]
    for s, d in ((128, 32), (256, 64), (64, 128)):  # test_flash_attention_sweep's grid
        for causal, window in ((True, None), (True, 64), (False, None)):
            for dtype in (f32, torch.bfloat16):
                mode = "noncausal" if not causal else f"window{window}" if window else "causal"
                cases.append(flash_case(card, f"sweep_s{s}_d{d}_{mode}_{str(dtype)[6:]}", 1, s,
                                        2, 2, d, causal=causal, window=window, dtype=dtype,
                                        seed=9))
    torch.cuda.empty_cache()
    return cases


def _print_flash_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms "
                 f"library(SDPA)={c['library_ms']:.4f} ms bound={c['bound_ms']:.4f} ms "
                 f"({c['bound_by']}; {c['bound_card']})")
    if "host_us_per_launch" in c:
        times += f" host={c['host_us_per_launch']:.1f} us/launch"
    print(f"flash_attention {c['case']}: B={c['B']} S={c['S']} H={c['H']} Kh={c['Kh']} "
          f"D={c['D']} causal={c['causal']} window={c['window']} {c['dtype']} "
          f"route={c['route']} "
          f"max_abs_err={c['max_abs_err']:.3g} rel_norm_err={c['rel_norm_err']:.3g} "
          f"(max |out| {c['max_abs']:.4g}){times}", flush=True)


# The kernel and its plain version compute in float32 from the same values
# (bf16 x, B and C widened as they are read), so every ssd output is float32
# and held at the float32 tolerance, and the difference's norm within 1e-5 of
# the plain version's.
SSD_REL_NORM = 1e-5


def ssd_work(b, t, h, g, p, n, q, *, state: bool, in_bytes: int):
    """(bytes, FLOP, TF32 FLOP) one ssd call needs: x, B and C (in their
    type), dt, a and the state in (when given) read once, y (float32) and
    the final state written once; per (b, h) and chunk of m real steps the
    operations of the chunk form on the float32 pipes (an exp counts as
    one): C B^T and att x below the diagonal, C S^T and the state update in
    full; and the same four products as the kernel's TF32 passes make them
    on the tensor cores: each float32 operand split in two parts, so C B^T
    takes 1 pass with bf16 inputs and 3 with float32, the others 2 and 3
    (the exps and scalings left on the float32 pipes are under 1% of it)."""
    nbytes = (b * t * h * p + 2 * b * t * g * n) * in_bytes + b * t * h * 4 + h * 4
    nbytes += b * t * h * p * 4 + (2 if state else 1) * b * h * p * n * 4
    cbt_passes, passes = (1, 2) if in_bytes == 2 else (3, 3)
    flops = tf32 = 0
    for start in range(0, t, q):
        m = min(q, t - start)
        pairs = m * (m + 1) // 2
        flops += (2 * m  # dt * a and the prefix sum
                  + pairs * (2 * n + 4)  # C . B, exp(cum_t - cum_s) times it and dt
                  + pairs * 2 * p  # att x
                  + 2 * m * n * p + 2 * m * p + 2 * m  # C S^T, times exp(cum) and added
                  + p * n + 2 * m * n * p + 3 * m + m * n)  # the state update
        tf32 += (pairs * 2 * n * cbt_passes  # C B^T
                 + (pairs * 2 * p + 2 * 2 * m * n * p) * passes)  # att x, C S^T, dS
    return nbytes, b * h * flops, b * h * tf32


def ssd_case(card, name, b, t, h, p, n, chunk, *, g=1, state=False, dt_range=(0.01, 1.0),
             dt_a=None, dtype=torch.float32, timed=False, want_split=None, seed=0):
    """ssd kernel vs its plain version on the card at one shape: x, B and C
    normal, dt uniform in ``dt_range``, a = -U(0.5, 2) (tests/test_kernels.py's
    draws; ``dt_a`` fixes dt = 1 and a = dt_a instead), B/C in ``g`` groups;
    output and final state compared.  The route (``ops.kernel_route``) and
    the split of P (``ops.kernel_split``) must be the kernel library's own,
    and the split ``want_split`` where given."""
    from repro_torch.kernels.mamba2 import ops, ref

    dev = torch.device("cuda")
    lib = ops.load_kernel().lib
    code, sms = ops.DTYPE_CODES[dtype], torch.cuda.get_device_properties(dev).multi_processor_count
    route, split = ops.kernel_route(dtype), ops.kernel_split(b * h, p, dtype, sms)
    check(route == ops.ROUTES[lib.ssd_route(code)], f"ssd {name}: route {route} is the kernel's")
    check(route == ("tf32x2" if dtype == torch.bfloat16 else "tf32x3"),
          f"ssd {name}: {dtype} takes the tensor-core route, not {route}")
    check(split == lib.ssd_split(b * h, p, code, sms), f"ssd {name}: split {split} is the kernel's")
    check(want_split is None or split == want_split, f"ssd {name}: split {split}, want {want_split}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    bm, cm = (torch.randn(b, t, g, n, generator=gen, device=dev).to(dtype) for _ in range(2))
    low, high = dt_range
    dt = low + (high - low) * torch.rand(b, t, h, generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand(h, generator=gen, device=dev))
    if dt_a is not None:
        dt, a = torch.ones(b, t, h, device=dev), torch.full((h,), dt_a, device=dev)
    s0 = torch.randn(b, h, p, n, generator=gen, device=dev) if state else None

    got, got_s = ops.ssd(x, bm, cm, dt, a, state=s0, chunk=chunk)
    want, want_s = ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=chunk)
    torch.cuda.synchronize()
    case = {"case": name, "B": b, "T": t, "H": h, "G": g, "P": p, "N": n, "chunk": min(chunk, t),
            "state": state, "dtype": str(dtype).removeprefix("torch."), "route": route,
            "split": split, "max_abs_out": float(want.abs().max())}
    errs, rels = [], []
    for gv, wv, what in ((got, want, "y"), (got_s, want_s, "final state")):
        check(gv.dtype == torch.float32 and bool(torch.isfinite(gv).all()),
              f"ssd {name} {what} float32 and finite")
        torch.testing.assert_close(gv, wv, **TOL, msg=lambda m: f"ssd {name} {what}: {m}")
        errs.append(float((gv - wv).abs().max()))
        rels.append(float(torch.linalg.vector_norm(gv - wv) / torch.linalg.vector_norm(wv)))
        check(rels[-1] < SSD_REL_NORM, f"ssd {name} {what}: relative norm error {rels[-1]}")
    case.update(max_abs_err=max(errs), rel_norm_err=max(rels))
    if state:  # the state in must matter here: a zero state gives another result
        zero_s = ops.ssd(x, bm, cm, dt, a, chunk=chunk)[1]
        case["state_effect"] = float((zero_s - got_s).abs().max())
        check(case["state_effect"] > 1e-2, f"ssd {name}: the initial state reaches the end")
    if timed:
        q = min(chunk, t)
        y = torch.empty(b, t, h, p, device=dev)
        final = torch.empty(b, h, p, n, device=dev)
        kern = lambda: ops.launch(x, bm, cm, dt, a, s0, q, y, final)  # noqa: E731
        plain = lambda: ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=q)  # noqa: E731
        case.update(in_turns(plain, kern, None))
        case.update(ssd_bounds(card, *ssd_work(b, t, h, g, p, n, q, state=state,
                                               in_bytes=x.element_size())))
    del x, bm, cm, dt, got, got_s, want, want_s
    return case


def ssd_bounds(card: Card, nbytes: float, flops: float, tf32: float) -> dict:
    """Both bounds of an ssd call, on the float32 pipes and on the tensor
    cores in the kernel's TF32 passes; the headline (``bound_ms``) is the
    smaller, the least time the card could take."""
    fma, tensor = card.bound(nbytes, flops), card.bound(nbytes, tf32, tf32=True)
    return {**min(fma, tensor, key=lambda bd: bd["bound_ms"]),
            **{f"{key}_{kind}": bd[key] for kind, bd in (("fma", fma), ("tensor", tensor))
               for key in ("bound_ms", "bound_by")}}


def ssd_cases(card: Card) -> list[dict]:
    """``ssd`` at the hybrid prefill's shape (B 4, T 1024, 80 heads of
    P = N = 64, one B/C group, chunk 64) and at its edges: the reference's,
    then the tensor-core design's (each split of P and the B * H where the
    rule changes, a row into a second chunk, chunks under 64 rows, one row,
    the narrowest (P, N)), each asserting its route and split."""
    small = (1e-4, 2e-3)  # decays summing to about -1 over 1024 steps: the state survives
    main = (4, 1024, 80, 64, 64, 64)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        ssd_case(card, "main_b4_t1024", *main, timed=True, want_split=2),
        ssd_case(card, "main_b4_t1024_state", *main, state=True, dt_range=small, seed=1),
        ssd_case(card, "main_b4_t1024_bf16", *main, dtype=bf16, timed=True, want_split=1,
                 seed=2),
        ssd_case(card, "ragged_t1000", 4, 1000, 80, 64, 64, 64, state=True, dt_range=small,
                 seed=3),
        ssd_case(card, "short_t5", 4, 5, 80, 64, 64, 64, state=True, seed=4),
        ssd_case(card, "short_t1", 4, 1, 80, 64, 64, 64, state=True, seed=5),
        ssd_case(card, "b1_t8192", 1, 8192, 80, 64, 64, 64, state=True, dt_range=(1e-5, 2e-4),
                 want_split=2, seed=6),
        ssd_case(card, "strong_decay", 4, 1024, 80, 64, 64, 64, dt_a=-50.0, seed=7),
        ssd_case(card, "groups_g2_h4", 2, 256, 4, 64, 64, 64, g=2, state=True, dt_range=small,
                 seed=8),
    ]
    for t, h, p, n, chunk in ((64, 2, 32, 16, 16), (32, 3, 16, 8, 8), (48, 1, 64, 32, 48)):
        for dtype in (torch.float32, torch.bfloat16):  # tests/test_kernels.py's sweep
            cases.append(ssd_case(card, f"sweep_t{t}_h{h}_p{p}_n{n}_q{chunk}_{str(dtype)[6:]}",
                                  2, t, h, p, n, chunk, g=h, seed=9, dtype=dtype))
    # bf16 splits P in 1, 2 or 4 at B * H >= 2 SMs, >= 1 SM, below; float32 in 2
    for bh, split in ((2 * sms - 1, 2), (2 * sms, 1), (sms - 1, 4), (sms, 2)):
        cases.append(ssd_case(card, f"split{split}_bh{bh}_bf16", 1, 130, bh, 64, 64, 64,
                              state=True, dt_range=small, dtype=bf16, want_split=split,
                              seed=10))
    cases += [
        ssd_case(card, f"split2_bh{2 * sms}_f32", 1, 130, 2 * sms, 64, 64, 64, state=True,
                 dt_range=small, want_split=2, seed=11),
        ssd_case(card, "b1_h80_bf16", 1, 1024, 80, 64, 64, 64, state=True, dt_range=small,
                 dtype=bf16, want_split=4, seed=12),
        ssd_case(card, "p64_n32_split4_bf16", 1, 130, 4, 64, 32, 64, state=True,
                 dt_range=small, dtype=bf16, want_split=4, seed=13),
    ]
    for dtype in (torch.float32, bf16):
        tag = str(dtype)[6:]
        cases += [
            ssd_case(card, f"t65_{tag}", 2, 65, 8, 64, 64, 64, state=True, dt_range=small,
                     dtype=dtype, seed=14),
            ssd_case(card, f"t17_{tag}", 2, 17, 8, 64, 64, 64, state=True, dt_range=small,
                     dtype=dtype, seed=15),
            ssd_case(card, f"chunk48_t200_{tag}", 2, 200, 8, 64, 64, 48, state=True,
                     dt_range=small, dtype=dtype, seed=16),
            ssd_case(card, f"chunk1_t40_{tag}", 2, 40, 8, 64, 64, 1, state=True,
                     dt_range=small, dtype=dtype, seed=17),
            ssd_case(card, f"p16_n8_g3_{tag}", 2, 100, 6, 16, 8, 64, g=3, state=True,
                     dt_range=small, dtype=dtype, want_split=1, seed=18),
        ]
    torch.cuda.empty_cache()
    return cases


def _print_ssd_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library=none "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']}; "
                 f"float32 pipes {c['bound_ms_fma']:.4f} ms by {c['bound_by_fma']}, "
                 f"TF32 tensor cores {c['bound_ms_tensor']:.4f} ms by {c['bound_by_tensor']})")
    print(f"ssd {c['case']}: B={c['B']} T={c['T']} H={c['H']} G={c['G']} P={c['P']} N={c['N']} "
          f"chunk={c['chunk']} state={c['state']} {c['dtype']} route={c['route']} "
          f"split={c['split']} max_abs_err={c['max_abs_err']:.3g} "
          f"rel_norm_err={c['rel_norm_err']:.3g} (max |y| {c['max_abs_out']:.4g}){times}",
          flush=True)


def check_kernels(card: Card) -> dict[str, list[dict]]:
    """Build the six kernels and hold each against its plain version at its
    shapes; the three consensus kernels' mass mode under "<kernel> mass",
    ``consensus_mix``'s snapshot mode under "consensus_mix snapshot", and
    adaptive rounds' dense operands under "<kernel> dense"."""
    from repro_torch.core.p2p import layout_of

    build_kernels()
    layout = layout_of("mnist_mlp")
    row = layout.row  # 199,210 parameters -> 199,212
    cases = {"consensus_mix": consensus_cases(card, row),
             "dequant_mix": dequant_cases(card, layout), "segment_mix": segment_cases(card),
             "wkv6": wkv6_cases(card), "flash_attention": flash_cases(card),
             "ssd": ssd_cases(card)}
    for kernel, kcases in mass_cases(card).items():
        cases[f"{kernel} mass"] = kcases
    cases["consensus_mix snapshot"] = snapshot_cases(card)
    for kernel, kcases in dense_cases(card).items():
        cases[f"{kernel} dense"] = kcases
    for kernel, kcases in cases.items():
        for c in kcases:
            if kernel == "wkv6":
                _print_wkv6_case(c)
            elif kernel == "flash_attention":
                _print_flash_case(c)
            elif kernel == "ssd":
                _print_ssd_case(c)
            else:
                _print_case(kernel, c)
            if "sparse_d1_ms" in c:
                print(f"{kernel} {c['case']}: the same matching on D = 1 sparse operands "
                      f"{c['sparse_d1_ms']:.4f} ms against the dense D = {c['D']} "
                      f"{c['dense_ms_same_call']:.4f} ms (same call)", flush=True)
    return cases


def recheck_consensus(name: str, exp, state, data, *, mix_mode=None) -> None:
    """One more round's consensus phase through the kernel, held against the
    plain version on the same post-local state (S = 1); ``mix_mode``
    "segment" rechecks the one-slice hierarchical runtime's phase.  A
    push-sum run is held to the plain versions of the mass mode, its new
    mass included; a bounded-staleness run to the snapshot mode's, on the
    round's delivery and age-decayed operands, its published buffer and ages
    included; an adaptive run on the round's dense operands, selected from
    the state as the round step selects them."""
    from repro_torch import compression
    from repro_torch.core import p2p, protocols, task as task_lib
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
    after_local, _ = p2p.local_phase(state, task, batches, cfg, steps_k=p2p.steps_budget(cfg))
    if cfg.schedule == "adaptive":
        sparse, _ = p2p.adaptive_operands(
            state.adaptive, cfg, p2p.round_operands(cfg, sizes, device="cuda")[0])
        check(sparse.nbr_idx.shape[1] == cfg.num_peers - 1, f"{name}: dense operands")
    else:
        ops_s = p2p.schedule_operands(cfg, sizes, device="cuda")
        sparse = cm_ops.select_round(ops_s, after_local.round_idx)
    comp = compression.from_config(cfg)
    push_sum = cfg.protocol == "push_sum"
    # push-sum: the plain versions of the mass mode take the mass after x
    mass = (after_local.protocol.mass,) if push_sum else ()
    if mix_mode == "segment":
        after_cons = p2p.consensus_phase_hier(after_local, cfg, ops_s, mix_mode=mix_mode)
        plain = ref.segment_mix_push_sum_stacked_ref if push_sum else ref.segment_mix_stacked_ref
        out = plain(after_local.params, *mass, *sparse, cfg.local_steps)
    elif cfg.staleness_bound > 0:
        pick, _ = p2p.round_picker(cfg, sizes, device="cuda")
        stale = pick(after_local.round_idx)
        after_cons = p2p.consensus_phase(after_local, cfg, stale)
        st = after_local.staleness
        delivered, age, decay = p2p.staleness_delivery(cfg, stale.scheduled, st.age)
        published = torch.where(delivered[:, None], after_local.params, st.published)
        a_ops = protocols.age_decayed_operands(
            stale, decay, protocols.get_protocol(cfg.protocol).stochasticity)
        plain = (ref.consensus_mix_push_sum_stacked_ref if push_sum
                 else ref.consensus_mix_stacked_ref)
        out = plain(after_local.params, *mass, *a_ops, cfg.local_steps, published=published)
        check(torch.equal(after_cons.staleness.published, published)
              and torch.equal(after_cons.staleness.age, age), f"{name}: published buffer")
        check(int(age.max()) <= cfg.staleness_bound, f"{name}: ages within the bound")
    elif comp.identity:
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        plain = (ref.consensus_mix_push_sum_stacked_ref if push_sum
                 else ref.consensus_mix_stacked_ref)
        out = plain(after_local.params, *mass, *sparse, cfg.local_steps)
    else:
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        layout = p2p.layout_of(cfg.model)
        payload = comp.ef_flat(after_local.params, after_local.compression, layout)
        plain = (ref.dequant_mix_push_sum_stacked_ref if push_sum
                 else ref.dequant_mix_stacked_ref)
        out = plain(after_local.params, payload.est, payload.q, payload.scale,
                    layout.leaf_offsets, *mass, *sparse, cfg.local_steps)
        torch.testing.assert_close(after_cons.compression, out[2], **TOL)
    mixed, d_bias = out[0], out[1]
    if push_sum:
        torch.testing.assert_close(after_cons.protocol.mass, out[-1], **TOL)
    torch.testing.assert_close(after_cons.params, mixed, **TOL)
    if cfg.use_affinity_d:
        torch.testing.assert_close(after_cons.d_bias, d_bias, **TOL)
    print(f"{name}: consensus of one more round matches the plain version")


def launch_counters() -> dict:
    from repro_torch.kernels.consensus_mix import dequant, ops, segment
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops

    return {"consensus_mix": ops.launches, "dequant_mix": dequant.launches,
            "segment_mix": segment.launches, "wkv6": wkv6_ops.launches,
            "flash_attention": flash_ops.launches, "ssd": ssd_ops.launches}


@contextlib.contextmanager
def count_plain_calls():
    """Counts the calls of the consensus kernels' plain versions (every
    ``*_ref`` function of ``kernels.consensus_mix.ref``) while active:
    yields a dict name -> calls."""
    from repro_torch.kernels.consensus_mix import ref

    calls: dict[str, int] = {}
    names = [n for n in dir(ref) if n.endswith("_ref") and callable(getattr(ref, n))]
    real = {n: getattr(ref, n) for n in names}

    def counted(n):
        def call(*args, **kwargs):
            calls[n] = calls.get(n, 0) + 1
            return real[n](*args, **kwargs)
        return call

    for n in names:
        setattr(ref, n, counted(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(ref, n, real[n])


def drive(name: str, exp, rounds: int, data, *, recheck: bool, mix_mode: str | None = None,
          **run_kw) -> dict:
    """Train ``exp`` for ``rounds`` rounds through ``run_paper_experiment`` on
    the card (its default scan driver, evaluating every round), every launch
    count set to 0 just before and read just after;
    checks that the path's kernel launched rounds x S times, the others and
    every plain version none, and that the run's numbers are sane.
    ``mix_mode`` "segment" with ``peer_axis="pod"`` runs the one-slice
    hierarchical runtime.  A push-sum run also checks after every round that
    the mass sums to K within 1e-5 K and stays positive."""
    from repro_torch.launch import train

    push_sum = exp.p2p.protocol == "push_sum"
    sums = []

    def watch_mass(r, state):
        mass = state.protocol.mass
        k = mass.shape[0]
        total = float(mass.double().sum())
        sums.append(total)
        check(abs(total - k) <= 1e-5 * k, f"{name} round {r}: sum y = {total}, want {k}")
        check(bool((mass > 0).all()), f"{name} round {r}: y > 0")

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
    with count_plain_calls() as plain_calls:
        log, state = train.run_paper_experiment(
            exp, rounds=rounds, data=data, device="cuda", verbose=True, return_state=True,
            on_round=watch_mass if push_sum else None, **run_kw)
    launches = {key: counter.count for key, counter in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == want, f"{name} launched {launches}, want {want}")
    check(not plain_calls, f"{name} called plain versions {plain_calls}")
    check(len(sums) == (rounds if push_sum else 0), f"{name}: mass watched every round")
    check(all(math.isfinite(v) for v in log.train_loss), f"{name} losses finite")
    acc = log.series("all").mean(axis=1)
    check(bool(np.all((acc >= 0) & (acc <= 1))), f"{name} accuracies in [0, 1]")
    check(bool(torch.isfinite(state.params).all()), f"{name} parameters finite")
    if recheck:
        recheck_consensus(name, exp, state, data, mix_mode=mix_mode)
    print(f"{name}: launches {launches}, plain-version calls {plain_calls}, seconds per round "
          f"{log.seconds}, peak memory {peak_gb:.3f} GB"
          + (f", sum of the mass after each round {sums}" if push_sum else ""))
    return {"launches": {kernel: launches[kernel]}, "peak_gb": peak_gb, "seconds": log.seconds,
            "mode": "mass" if push_sum else "gossip", "mass_sums": sums}


def compare_drivers(card: Card, name: str, exp, rounds: int, eval_every: int, data, *,
                    kernel: str, **run_kw) -> dict:
    """``run_paper_experiment`` of ``exp`` under both drivers, the python one
    first, from the same seed and rounds, every launch count set to 0 just
    before and read just after each run and every plain version's calls
    counted (none allowed): the final state (params, momentum, d, b,
    push-sum's mass, the compressed wire's estimate) equal bit for bit, the
    logged losses and accuracies equal, and the same launches (the scan
    driver's counted on replay: ``repro_torch.capture``), ``kernel``'s
    rounds x S.  Prints seconds per round both ways over the eval periods
    after the first (the scan driver's first holds its warm-up round and
    capture), the capture seconds and the peak memory both ways."""
    from repro_torch.core import p2p
    from repro_torch.launch import train

    counters = launch_counters()
    want = {key: 0 for key in counters} | {kernel: rounds * exp.p2p.consensus_steps}
    runs = {}
    for driver in ("python", "scan"):
        print(f"main path: {name}, {rounds} rounds, eval every {eval_every}, driver {driver}",
              flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for counter in counters.values():
            counter.reset()
        with count_plain_calls() as plain_calls:
            log, state = train.run_paper_experiment(
                exp, rounds=rounds, data=data, eval_every=eval_every, device="cuda",
                driver=driver, return_state=True, **run_kw)
        launches = {key: counter.count for key, counter in counters.items()}
        check(launches == want, f"{name} ({driver}) launched {launches}, want {want}")
        check(not plain_calls, f"{name} ({driver}) called plain versions {plain_calls}")
        check(all(math.isfinite(v) for v in log.train_loss), f"{name} ({driver}) losses finite")
        runs[driver] = {"log": log, "state": state, "launches": launches,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    python, scan = runs["python"], runs["scan"]
    final = scan["state"]
    if exp.p2p.protocol == "push_sum":
        total = float(final.protocol.mass.double().sum())
        check(abs(total - exp.p2p.num_peers) <= 1e-5 * exp.p2p.num_peers,
              f"{name}: sum y = {total}")
    if exp.p2p.staleness_bound > 0:
        check(int(final.staleness.age.max()) <= exp.p2p.staleness_bound,
              f"{name}: ages within the bound")
    leaves = list(zip(p2p.state_leaves(python["state"]), p2p.state_leaves(scan["state"])))
    check(len(p2p.state_leaves(python["state"])) == len(p2p.state_leaves(scan["state"])),
          f"{name}: state structure")
    for i, (a, b) in enumerate(leaves):
        check(torch.equal(a, b), f"{name}: state leaf {i} differs between the drivers, max "
                                 f"|diff| {float((a - b).abs().max())}")
    check(python["state"].round_idx == scan["state"].round_idx == rounds, f"{name}: rounds")
    check(python["log"].train_loss == scan["log"].train_loss, f"{name}: logged losses differ")
    for group in python["log"].after_local:
        for phase in ("local", "consensus"):
            check(np.array_equal(python["log"].series(group, phase),
                                 scan["log"].series(group, phase)),
                  f"{name}: logged {phase} accuracies of {group} differ")
    out = {"card": card.line, "rounds": rounds, "eval_every": eval_every,
           "state_leaves_equal": len(leaves), "launches_per_round": {
               d: runs[d]["launches"][kernel] / rounds for d in runs},
           "s_per_round_after_first_period": {
               d: float(np.mean(runs[d]["log"].seconds[1:])) for d in runs},
           "first_period_s_per_round": {d: runs[d]["log"].seconds[0] for d in runs},
           "capture_s": scan["log"].capture_seconds,
           "peak_gb": {d: runs[d]["peak_gb"] for d in runs}}
    if exp.p2p.num_peers == 100 and not run_kw and exp.p2p.compressor == "none" \
            and not exp.p2p.use_async:
        # what the body's copy of the round's state into the carried buffers
        # costs at most: every (K, row) leaf copied once
        src = p2p.state_leaves(scan["state"])
        dst = [t.clone() for t in src]
        out["carry_copy_all_leaves_ms"] = cuda_ms(
            lambda: [d.copy_(t) for d, t in zip(dst, src)])
        del dst
    print(f"drivers {name} ({card.line}): {json.dumps(out)}", flush=True)
    return {"launches": {kernel: scan["launches"][kernel]}, **out}


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
    runtime: ``rounds`` rounds through the python driver's round function,
    no evaluation (as the reference's K = 4096 test drives its round step;
    the rounds are device-bound at about 2 s), launch counts
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
    want = {key: 0 for key in counters} | {"segment_mix": rounds * cfg.consensus_steps}
    check(launches == want, f"K={k} launched {launches}, want {want}")
    check(all(math.isfinite(v) for v in losses), f"K={k} losses finite")
    for field in ("params", "momentum", "d_bias", "b_bias"):
        check(bool(torch.isfinite(getattr(state, field)).all()), f"K={k} {field} finite")
    check(state.round_idx == rounds, f"K={k} ran {state.round_idx} rounds")
    print(f"K={k}: launches {launches}, set-up {setup_s:.3f} s, seconds per round {seconds}, "
          f"losses {losses}, peak memory {peak_gb:.3f} GB against {state_gb:.3f} GB for the "
          f"four (K, {state.params.shape[1]}) state buffers", flush=True)
    return {"launches": {"segment_mix": launches["segment_mix"]}, "peak_gb": peak_gb,
            "state_gb": state_gb, "seconds": seconds, "setup_s": setup_s}


SEQMNIST = "rwkv6_seqmnist"
SEQMNIST_ROUNDS = 3


def seqmnist_params(k: int, seed: int = 0) -> dict[str, torch.Tensor]:
    """``k`` draws of the classifier's parameters, stacked, on the CPU."""
    from repro_torch.core import task as task_lib

    task = task_lib.get_task(SEQMNIST)
    gen = torch.Generator().manual_seed(seed)
    peers = [task.init_params(gen) for _ in range(k)]
    return {name: torch.stack([p[name] for p in peers]) for name in task.param_shapes}


def check_classifier_on_card() -> dict:
    """The task's K-batched loss (``torch.func.vmap`` of the classifier, the
    RNN form) and its per-leaf gradients on the card against the same
    function on the CPU, from the same parameters and one (K, B, 196) token
    batch, TF32 off; at atol 5e-5 / rtol 1e-4 (``TOL``).  The RNN form
    reaches no kernel: no launch may be counted."""
    from repro_torch.core import task as task_lib

    task = task_lib.get_task(SEQMNIST)
    k, b = 8, 10  # seqmnist_k8's peers and batch: one local step's
    params = seqmnist_params(k)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 16, (k, b, 196)))
    labels = torch.as_tensor(rng.integers(0, 10, (k, b)))
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()

    def loss_and_grads(dev):
        leaves = {n: t.to(dev).requires_grad_(True) for n, t in params.items()}
        losses = task.loss_fn(leaves, (tokens.to(dev), labels.to(dev)))
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        return losses.detach().cpu(), [g.cpu() for g in grads]

    (cpu_l, cpu_g), (card_l, card_g) = loss_and_grads("cpu"), loss_and_grads("cuda")
    launched = {key: c.count for key, c in counters.items() if c.count}
    check(not launched, f"the classifier's RNN form launched {launched}")
    torch.testing.assert_close(card_l, cpu_l, **TOL, msg=lambda m: f"classifier losses: {m}")
    for name, got, want in zip(params, card_g, cpu_g):
        torch.testing.assert_close(got, want, **TOL,
                                   msg=lambda m, n=name: f"classifier grad {n}: {m}")
    out = {"K": k, "B": b, "T": 196,
           "loss_max_abs_diff": float((card_l - cpu_l).abs().max()),
           "grad_max_abs_diff": max(float((g - w).abs().max()) for g, w in zip(card_g, cpu_g)),
           "tolerance": TOL}
    print(f"classifier on the card against the CPU: {json.dumps(out)}", flush=True)
    return out


def check_seqmnist_wkv6(card: Card) -> dict:
    """``rwkv6_features(chunked=True)`` on the card (each layer's WKV through
    ``wkv6``: 2 launches) against ``chunked=False`` (the token loop) at the
    task's shape, B = 256 as the chunked eval's chunks (``WKV6_TOL``); then
    one ``wkv6`` call at B 256, T 196, H 4, dk 16, chunk 49, from a zero and
    from a random state, against its plain version, the first timed in
    turns."""
    from repro_torch.core import task as task_lib
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.models import transformer as tf

    cfg = task_lib.seqmnist_model_config()
    params = {n: t[0].cuda() for n, t in seqmnist_params(1, seed=1).items()}
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 16, (256, 196)),
                             device="cuda")
    wkv6_ops.launches.reset()
    with torch.no_grad():
        chunked = tf.rwkv6_features(params, cfg, tokens, chunked=True)
        launched = wkv6_ops.launches.count
        loop = tf.rwkv6_features(params, cfg, tokens, chunked=False)
    check(launched == cfg.num_layers, f"rwkv6_features(chunked=True) launched wkv6 {launched} "
                                      f"times, want {cfg.num_layers}")
    check(wkv6_ops.launches.count == launched, "the token loop launched wkv6")
    torch.testing.assert_close(chunked, loop, **WKV6_TOL,
                               msg=lambda m: f"features, wkv6 against the token loop: {m}")
    features_err = float((chunked - loop).abs().max())
    del chunked, loop
    cases = [wkv6_case(card, "seqmnist_b256_t196_q49", 256, 196, 4, 16, 49, timed=True, seed=11),
             wkv6_case(card, "seqmnist_b256_t196_q49_state", 256, 196, 4, 16, 49, state=True,
                       ld=(1e-4, 2e-2), seed=12)]
    for c in cases:
        _print_wkv6_case(c)
    print(f"features at B=256 T=196: wkv6 against the token loop, max |diff| "
          f"{features_err:.3g} (atol = rtol = 1e-3)", flush=True)
    return {"features_max_abs_diff": features_err, "cases": cases}


def check_backward_raises() -> dict:
    """Autograd through a forward-only kernel on the card raises
    ``NotImplementedError`` (``kernels.build.check_no_grad``) and launches
    nothing: ``wkv6`` called directly and under ``rwkv6_loss_fn``, ``ssd`` and
    ``flash_attention`` directly; under ``torch.no_grad`` the same calls run."""
    from repro_torch.core import task as task_lib
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    r, k, v = (rnd(2, 98, 4, 16).requires_grad_(True) for _ in range(3))
    logd, u = -torch.rand(2, 98, 4, 16, generator=gen, device=dev), rnd(4, 16)
    x, bm, cm = rnd(2, 64, 4, 32).requires_grad_(True), rnd(2, 64, 1, 16), rnd(2, 64, 1, 16)
    dt, a = torch.rand(2, 64, 4, generator=gen, device=dev), -torch.ones(4, device=dev)
    q, kk, vv = (rnd(1, 64, 2, 32).requires_grad_(True) for _ in range(3))
    cfg = task_lib.seqmnist_model_config()
    trunk = {n: t[0].to(dev).requires_grad_(True) for n, t in seqmnist_params(1).items()
             if not n.startswith("cls_head.")}
    toks = torch.randint(0, 16, (2, 196), generator=gen, device=dev)
    calls = {
        "wkv6": lambda: wkv6_ops.wkv6(r, k, v, logd, u, chunk=49),
        "wkv6 under rwkv6_loss_fn": lambda: tf.rwkv6_loss_fn(
            trunk, cfg, {"tokens": toks, "labels": toks}),
        "ssd": lambda: ssd_ops.ssd(x, bm, cm, dt, a, chunk=32),
        "flash_attention": lambda: flash_ops.gqa_flash_attention(q, kk, vv),
    }
    counters = launch_counters()
    out = {}
    for name, call in calls.items():
        for counter in counters.values():
            counter.reset()
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
        else:
            raise RuntimeError(f"check failed: autograd through {name} on the card did not "
                               "raise")
        launched = {key: c.count for key, c in counters.items() if c.count}
        check(not launched, f"{name}: launched {launched} before raising")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    print(f"backward through the forward-only kernels raises: {json.dumps(out)}", flush=True)
    return out


def profile_seqmnist_round(card: Card, exp, data) -> dict:
    """One ``exp`` round both ways under torch.profiler: an eager round of
    the python driver's round function, and a replay of the scan driver's
    captured round (``ScanDriver.captured``, after one chunk of 2 rounds):
    kernels, device time, wall seconds, and the graph's capture seconds
    (warm-up round included).  A replay launches only what the capture
    recorded: the eager round's matmuls, one for one.  The total counts
    differ by a few tens either way (the graph's static-buffer copies, the
    eager round's batch upload and the one-time work of its first calls,
    whose count falls from call to call), so they are reported, not
    compared."""
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    round_fn = p2p.make_round_fn(task, cfg, sizes, device=dev)
    batches = batcher.round_batches_on(cfg.local_steps, dev)
    round_fn(state, batches)  # warm-up: cuBLAS handles, allocator, autograd
    torch.cuda.synchronize()
    eager = profile_once(lambda: round_fn(state, batches))
    drive_fn = p2p.make_scan_driver(task, cfg, sizes, device=dev, donate=False)
    drive_fn(state, batcher.chunk_batches_on(cfg.local_steps, 2, dev))
    replay = profile_once(drive_fn.captured.replay)
    replay_ms = cuda_ms(drive_fn.captured.replay, target_s=0.5)
    out = {"card": card.line, "capture_s": drive_fn.capture_seconds,
           "eager_round": {key: eager[key] for key in ("wall_s", "device_busy_s", "kernels")},
           "replay": {key: replay[key] for key in ("wall_s", "device_busy_s", "kernels")},
           "replay_ms_cuda_events": replay_ms,
           "replay_by_category": replay["by_category_launches_ms"],
           "replay_top_kernels_ms": replay["top_kernels_ms"]}
    print(f"seqmnist round profile ({card.line}): {json.dumps(out)}", flush=True)
    matmuls = {name: p["by_category_launches_ms"].get("matmul", [0])[0]
               for name, p in (("eager", eager), ("replay", replay))}
    check(matmuls["replay"] == matmuls["eager"] > 0,
          f"a replay ran {matmuls['replay']} matmuls, the eager round {matmuls['eager']}")
    return out


def seqmnist_phase(card: Card, data, cases: dict, paths: dict) -> dict:
    """RWKV6 on sequential MNIST (``seqmnist_k8``, K = 8, T = 4, 31 leaves,
    N = 100,236): the classifier on the card against the CPU, ``wkv6`` at
    the task's shape, the backward guard, ``consensus_mix`` (and its mass
    mode) and ``dequant_mix`` held and timed at the task's row, three
    training runs through ``run_paper_experiment`` (gossip static, push-sum
    static, gossip round robin over qint8; launches counted, no plain
    version, the mass watched, one consensus phase rechecked), both drivers
    on gossip and push-sum, and one round's kernels both ways.  Adds its
    cases and paths to ``cases`` and ``paths``; returns its own results and
    seconds."""
    from repro_torch.configs.p2pl_mnist import seqmnist_k8
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    start = time.perf_counter()
    out = {"classifier": check_classifier_on_card()}
    wkv6 = check_seqmnist_wkv6(card)
    cases["wkv6"].extend(wkv6["cases"])
    out["features_max_abs_diff"] = wkv6["features_max_abs_diff"]
    out["backward_raises"] = check_backward_raises()
    layout = layout_of(SEQMNIST)
    check((len(layout.shapes), layout.size, layout.row) == (31, 100_234, 100_236),
          f"seqmnist layout {len(layout.shapes)} leaves, {layout.size} -> {layout.row}")
    ring, sizes = graph_lib.build_graph("ring", 8), np.full(8, 100)
    new = {"consensus_mix": consensus_case(card, "seqmnist_k8_ring", ring, sizes, layout.row,
                                           want_path="gather", seed=13),
           "consensus_mix mass": consensus_mass_case(card, "seqmnist_k8_ring_push_sum", ring,
                                                     sizes, layout.row, want_path="gather",
                                                     seed=14),
           "dequant_mix": dequant_case(card, "seqmnist_k8_ring_qint8", ring, sizes,
                                       layout.leaf_offsets, layout.row, seed=15)}
    for kernel, c in new.items():
        cases[kernel].append(c)
        _print_case(kernel, c)
    gossip, push = seqmnist_k8(), seqmnist_k8(protocol="push_sum")
    rr = seqmnist_k8(schedule="round_robin")
    rr_qint8 = dataclasses.replace(rr, p2p=dataclasses.replace(rr.p2p, compressor="qint8"))
    paths |= {
        "seqmnist_k8": drive("seqmnist_k8", gossip, SEQMNIST_ROUNDS, data, recheck=True),
        "seqmnist_k8_push_sum": drive("seqmnist_k8_push_sum", push, SEQMNIST_ROUNDS, data,
                                      recheck=True),
        "seqmnist_k8_round_robin_qint8": drive("seqmnist_k8_round_robin_qint8", rr_qint8,
                                               SEQMNIST_ROUNDS, data, recheck=True),
    }
    for label, exp in (("seqmnist_k8", gossip), ("seqmnist_k8_push_sum", push)):
        result = compare_drivers(card, label, exp, 6, 3, data, kernel="consensus_mix")
        result["mode"] = "mass" if exp.p2p.protocol == "push_sum" else "gossip"
        paths[f"{label}_both_drivers"] = result
    out["round_profile"] = profile_seqmnist_round(card, gossip, data)
    out["seconds"] = time.perf_counter() - start
    print(f"seqmnist phase ({card.line}): {out['seconds']:.1f} s", flush=True)
    return out


SERVE_ARCH = "rwkv6-7b"
DECODER_ARCH = "minitron-8b"
HYBRID_ARCH = "zamba2-2.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 16
FLEET_PEERS = 2
LONG_PROMPT, LONG_GEN = 8192, 4
# the MoE decoders at published widths, depth cut to fit one 80 GB card (bf16
# parameters 42.5 and 42.3 GB): deepseek's dense layer 0 and 5 MoE layers,
# qwen3-moe's first 8 layers; (arch, layers, launches a prefill, rechecked calls)
MOE_SERVED = (("deepseek-v2-236b", 6, {}, {}),
              ("qwen3-moe-235b-a22b", 8, {"flash_attention": 8}, {"flash_attention": (0, 7)}))
MOE_REL_NORM = 1e-2  # bf16: the dispatch against the dense oracle, absorbed MLA against expanded
MOE_DENSE_TOKENS = 128  # of each prompt row: 512 tokens through every expert in the oracle


def _serving_launches(counters: dict, want: dict, name: str) -> dict:
    launches = {key: counter.count for key, counter in counters.items()}
    want = {key: 0 for key in counters} | want
    check(launches == want, f"{name} launched {launches}, want {want}")
    return launches


def served_config(arch: str, layers: int | None = None):
    """``arch``'s published config, its depth cut to ``layers`` if given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def drive_serve_batch(card: Card, arch: str, per_prefill: dict[str, int], *,
                      layers: int | None = None) -> dict:
    """``serve_batch`` of ``arch`` at full width and depth (bf16, random init
    from seed 0 on the card), or, with ``layers``, ``serve_model`` (the
    helper ``serve_batch`` runs) on the published config cut to that depth;
    launch counts set to 0 just before and read just after each call: first
    with ``gen_tokens=1`` (prefill only, the explicit empty decode), where
    each kernel of ``per_prefill`` launches the number given and every other
    kernel none; then prefill plus 15 decode steps, where they launch the
    same numbers in all, so the decode launched none."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = served_config(arch, layers)
    depth = "full" if layers is None else f"full width, {layers} of " \
        f"{served_config(arch).num_layers} layers"
    counters = launch_counters()
    runs = {}
    for label, gen in (("prefill_only", 1), ("prefill_decode", SERVE_GEN)):
        print(f"main path: serve_batch {arch} {depth}, batch {SERVE_BATCH}, prompt "
              f"{SERVE_PROMPT}, gen {gen}", flush=True)
        torch.cuda.empty_cache()
        for counter in counters.values():
            counter.reset()
        kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen_tokens=gen, seed=0,
                  verbose=True, device="cuda")
        if layers is None:
            out = serve.serve_batch(arch, use_reduced=False, **kw)
        else:
            out = serve.serve_model(build_model(cfg), **kw)
        launches = _serving_launches(counters, per_prefill, f"serve_batch {arch} gen={gen}")
        tokens = out["tokens"]
        check(tuple(tokens.shape) == (SERVE_BATCH, gen), f"serve_batch tokens {tokens.shape}")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              "serve_batch tokens in the vocab")
        for name, leaf in out["cache"].items():
            check(bool(torch.isfinite(leaf.float()).all()), f"serve_batch cache {name} finite")
        for name in ("main.pos_ids", "first.pos_ids", "attn.pos_ids"):  # KV caches' positions
            if name in out["cache"]:  # 0 .. prompt + gen - 2
                want_pos = torch.arange(SERVE_PROMPT + gen, device="cuda", dtype=torch.int32)
                want_pos[SERVE_PROMPT + gen - 1:] = -1
                check(bool((out["cache"][name] == want_pos).all()),
                      f"serve_batch cache positions {name}")
        runs[label] = {key: out[key] for key in ("prefill_s", "decode_steps",
                                                 "decode_s_per_token", "tokens_per_s",
                                                 "peak_memory_gb", "params_gb")}
        runs[label]["launches"] = {k: launches[k] for k in per_prefill}
        runs[label]["tokens"] = tokens[0].tolist()
        del out
    check(runs["prefill_only"]["tokens"][0] == runs["prefill_decode"]["tokens"][0],
          "the prefill token does not depend on the decode length")
    print(f"serve_batch {arch} ({card.line}): {json.dumps(runs)}", flush=True)
    print(f"serve_batch {arch}: peak memory {runs['prefill_decode']['peak_memory_gb']:.3f} GB "
          f"beside {runs['prefill_decode']['params_gb']:.3f} GB of parameters", flush=True)
    return {"launches": {k: sum(r["launches"][k] for r in runs.values()) for k in per_prefill},
            "runs": runs,
            "launches_by_phase": {k: {"prefill": runs["prefill_only"]["launches"][k],
                                      "decode": runs["prefill_decode"]["launches"][k]
                                      - runs["prefill_only"]["launches"][k]}
                                  for k in per_prefill}}


def time_and_profile_serving(model, params, prompt, cache0) -> dict:
    """One warm prefill and one warm decode step (after a warm-up step),
    timed by host clocks around device synchronizes, then each profiled."""
    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(model)
    decode = steps.make_serve_step(model)
    out = {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    tok, cache = prefill(params, prompt, cache0)
    torch.cuda.synchronize()
    out["warm_prefill_s"] = time.perf_counter() - start
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int64, device="cuda")
    decode(params, cache, tok, pos)  # warm-up step
    torch.cuda.synchronize()
    start = time.perf_counter()
    decode(params, cache, tok, pos)
    torch.cuda.synchronize()
    out["warm_decode_step_s"] = time.perf_counter() - start
    for phase, fn in (("prefill", lambda: prefill(params, prompt, cache0)),
                      ("decode_step", lambda: decode(params, cache, tok, pos))):
        out[phase] = profile_once(fn)
    return out


def _compare_wkv6(args, kwargs, got, want, what) -> dict:
    rec = {"logdecay_range": [float(args[3].min()), float(args[3].max())],
           "o_max_abs": float(want[0].abs().max())}
    rec["o_dtype"] = str(got[0].dtype).removeprefix("torch.")
    for g, w, part in ((got[0], want[0], "o"), (got[1], want[1], "state")):
        tol = WKV6_BF16_TOL if g.dtype == torch.bfloat16 else WKV6_TOL
        torch.testing.assert_close(g.float(), w, **tol, msg=lambda m: f"{what} {part}: {m}")
        rec[f"{part}_max_abs_err"] = float((g.float() - w).abs().max())
    return rec


def _compare_flash(args, kwargs, got, want, what) -> dict:
    return {**check_flash(got, want, what), "q_max_abs": float(args[0].float().abs().max())}


def _compare_ssd(args, kwargs, got, want, what) -> dict:
    x, dt = args[0], args[3]
    rec = {"x_dtype": str(x.dtype), "x_strides": list(x.stride()),
           "y_max_abs": float(want[0].abs().max()),
           "dt_range": [float(dt.min()), float(dt.max())]}
    for g, w, part in ((got[0], want[0], "y"), (got[1], want[1], "state")):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{what} {part}: {m}")
        rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
        check(rel < SSD_REL_NORM, f"{what} {part}: relative norm error {rel}")
        rec[f"{part}_max_abs_err"] = float((g - w).abs().max())
        rec[f"{part}_rel_norm_err"] = rel
    return rec


def _recheck_wrappers() -> dict:
    """kernel -> (wrapper's module, wrapper's name, plain version with the
    wrapper's signature, comparison)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.kernels.rwkv6 import ref as wkv6_ref

    def wkv6_plain(r, k, v, ld, u, *, state=None, chunk=16):
        return wkv6_ref.wkv6_chunked_ref(r, k, v, ld, u, state, chunk=chunk)

    return {"wkv6": (wkv6_ops, "wkv6", wkv6_plain, _compare_wkv6),
            "flash_attention": (flash_ops, "gqa_flash_attention", flash_ref.gqa_attention_ref,
                                _compare_flash),
            "ssd": (ssd_ops, "ssd", ssd_ref.ssd_chunked_ref, _compare_ssd)}


@contextlib.contextmanager
def recheck_calls(picks: dict[str, tuple[int, ...]], log: dict):
    """Wrap the kernel wrappers named in ``picks`` while the block runs: the
    calls numbered there (in the order the block makes them) also go through
    the plain version on the very same operands, views and strides as given,
    and are compared; the readings go to ``log[kernel][f"call{i}"]``."""
    wrappers = _recheck_wrappers()
    saved = []
    for kernel, numbers in picks.items():
        module, name, plain, compare = wrappers[kernel]
        real = getattr(module, name)
        calls = itertools.count()
        log[kernel] = {}

        def wrapped(*args, _real=real, _plain=plain, _compare=compare, _kernel=kernel,
                    _numbers=numbers, _calls=calls, **kwargs):
            i = next(_calls)
            got = _real(*args, **kwargs)
            if i in _numbers:
                want = _plain(*args, **kwargs)
                torch.cuda.synchronize()
                rec = _compare(args, kwargs, got, want, f"{_kernel} call {i}")
                log[_kernel][f"call{i}"] = rec
                print(f"{_kernel} call {i} of the prefill at full width: kernel vs plain "
                      f"version {json.dumps(rec)}", flush=True)
            return got

        saved.append((module, name, real))
        setattr(module, name, wrapped)
    try:
        yield log
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    for kernel, numbers in picks.items():
        check(sorted(log[kernel]) == sorted(f"call{i}" for i in numbers),
              f"{kernel}: rechecked {sorted(log[kernel])}, want calls {numbers}")


def compare_decode(card: Card, name: str, model, params, prompt, per_prefill: dict[str, int],
                   *, gen: int = SERVE_GEN) -> dict:
    """One prefill of ``prompt``, then its ``gen - 1`` decode steps both ways
    from the prefill's cache: the python loop (``make_decode_loop``, which
    leaves the cache as it was), then the scanned decode
    (``make_decode_scan``: one captured CUDA graph of the step, replayed per
    token, consuming the cache).  Launch counts set to 0 just before and
    read just after each: the prefill's kernels as ``per_prefill``, none in
    either decode.  Tokens and every leaf of the final cache must be equal.
    Prints decode s/token both ways, the capture seconds, a warm replay's
    seconds (the replays' wall time over their count), the CUDA kernels of
    one step both ways (torch.profiler: an eager step, one replay) and the
    peak memory both ways."""
    from repro_torch.launch import steps

    dev = prompt["tokens"].device
    batch, prompt_len = prompt["tokens"].shape
    counters = launch_counters()
    torch.cuda.empty_cache()
    for counter in counters.values():
        counter.reset()
    tok, cache = steps.make_prefill_step(model)(
        params, prompt, model.init_cache(batch, prompt_len + gen, dev))
    torch.cuda.synchronize()
    _serving_launches(counters, per_prefill, f"{name} prefill")
    pos = torch.full((batch,), prompt_len, dtype=torch.int64, device=dev)
    out, toks, caches = {"card": card.line}, {}, {}
    for impl in ("python", "scan"):
        make = steps.make_decode_loop if impl == "python" else steps.make_decode_scan
        decode = make(model, gen - 1)
        for counter in counters.values():
            counter.reset()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        toks[impl], caches[impl] = decode(params, cache, tok, pos)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        _serving_launches(counters, {}, f"{name} decode ({impl})")
        out.setdefault("decode_s_per_token", {})[impl] = seconds / (gen - 1)
        out.setdefault("peak_gb", {})[impl] = torch.cuda.max_memory_allocated() / 1e9
        if impl == "scan":
            out["capture_s"] = decode.capture_seconds
            out["replay_s_per_step"] = (seconds - decode.capture_seconds) / (gen - 2)
    check(torch.equal(toks["python"], toks["scan"]),
          f"{name}: decode tokens differ: {toks['python'].tolist()} vs {toks['scan'].tolist()}")
    for leaf in caches["python"]:
        a, b = caches["python"][leaf], caches["scan"][leaf]
        check(torch.equal(a, b), f"{name}: final cache {leaf} differs, max |diff| "
                                 f"{float((a.float() - b.float()).abs().max())}")
    out["tokens"] = [int(tok[0])] + toks["scan"][0].tolist()
    # one more step each way from the final cache, profiled
    last = toks["scan"][:, -1].clone()
    at = pos + gen - 1
    eager = steps.make_serve_step(model)
    captured = steps.make_decode_scan(model, 2).capture_step(params, caches["scan"],
                                                            last.clone(), at.clone())
    profiles = {"python": profile_once(lambda: eager(params, caches["python"], last, at)),
                "scan": profile_once(captured.replay)}
    del captured
    out["kernels_per_step"] = {impl: p["kernels"] for impl, p in profiles.items()}
    out["profiled_step"] = {impl: {k: p[k] for k in ("wall_s", "device_busy_s",
                                                     "device_busy_share")}
                            for impl, p in profiles.items()}
    print(f"decode both ways {name} ({card.line}): {json.dumps(out)}", flush=True)
    del cache, caches
    torch.cuda.empty_cache()
    return out


def recheck_and_break_down(card: Card, arch: str, picks: dict[str, tuple[int, ...]],
                           per_prefill: dict[str, int], *, layers: int | None = None,
                           extra=None) -> dict:
    """The served ``arch`` again (seed 0: the same parameters and prompt as
    ``serve_batch``; with ``layers``, its depth cut so): one prefill through
    ``model.prefill`` in which the
    kernel calls of ``picks`` (call i is layer i's, or the shared block's
    i-th application) are rerun through the plain version on the operands
    the served path gives them (``recheck_calls``); then one warm prefill
    and one warm decode step timed, and each profiled for its kernels; then,
    on the same parameters, the decode both ways (``compare_decode``, the
    prefill launching ``per_prefill``); then ``extra(card, model, params,
    prompt)`` where given, its result under ``"checks"``."""
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model = build_model(served_config(arch, layers))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    prompt = model.make_batch(gen, SERVE_BATCH, SERVE_PROMPT)
    out = {"recheck": {}}
    with torch.no_grad():
        cache0 = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev)
        with recheck_calls(picks, out["recheck"]):
            model.prefill(params, prompt, cache0)
        torch.cuda.empty_cache()
        out.update(time_and_profile_serving(model, params, prompt, cache0))
    print(f"serving breakdown {arch} ({card.line}): {json.dumps(out)}", flush=True)
    del cache0
    out["decode_both_ways"] = compare_decode(card, arch, model, params, prompt, per_prefill)
    if extra is not None:
        out["checks"] = extra(card, model, params, prompt)
    del params
    torch.cuda.empty_cache()
    return out


def mla_absorbed_vs_expanded(model, params, tok, cache) -> dict:
    """One decode step from ``cache`` (the prefill's) under ``mla_absorb``
    against the expanded step.  Layer by layer, the absorbed MLA on the very
    input and cache the expanded step gives that layer, each within
    ``MOE_REL_NORM``: there the two forms differ only by the expanded
    form's bf16 K and V (the reference's), the absorbed form being float32
    throughout.  The whole step's logits are compared and reported (their
    error grows through the layers and the MoE blocks of random weights).
    Both steps timed in turns."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import build_model

    cfg = model.cfg
    absorbed_attn = dataclasses.replace(cfg.attention, mla_absorb=True)
    absorbed = build_model(cfg.replace(attention=absorbed_attn))
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int64, device=tok.device)
    step = {"expanded": lambda: model.decode_step(params, tok, pos, cache),
            "absorbed": lambda: absorbed.decode_step(params, tok, pos, cache)}
    layer_errs = []
    real_mla = attn_lib.mla_apply

    def mla(p, acfg, x, positions, **kw):
        o, c = real_mla(p, acfg, x, positions, **kw)
        layer_errs.append(rel_norm(real_mla(p, absorbed_attn, x, positions, **kw)[0], o))
        return o, c

    with torch.no_grad():
        attn_lib.mla_apply = mla
        try:
            expanded_logits = step["expanded"]()[0]
        finally:
            attn_lib.mla_apply = real_mla
        absorbed_logits = step["absorbed"]()[0]
        torch.cuda.synchronize()
        check(len(layer_errs) == cfg.num_layers, f"{len(layer_errs)} MLA layers compared")
        for i, err in enumerate(layer_errs):
            check(err < MOE_REL_NORM, f"{cfg.name}: absorbed MLA at layer {i}, relative norm "
                                      f"error {err}")
        out = {"layer_rel_norm_err": layer_errs,
               "logits_rel_norm_err": rel_norm(absorbed_logits, expanded_logits),
               "logits_max_abs_err": float((absorbed_logits - expanded_logits).abs().max()),
               "same_argmax": bool(torch.equal(absorbed_logits.argmax(-1),
                                               expanded_logits.argmax(-1)))}
        times = {"expanded": [], "absorbed": []}
        for name in ("expanded", "absorbed", "absorbed", "expanded"):
            times[name].append(cuda_ms(step[name]))
    return {**out, **{f"{name}_step_ms": sum(v) / len(v) for name, v in times.items()}}


def moe_checks(card: Card, model, params, prompt) -> dict:
    """On a MoE decoder at published widths: one prefill in which every MoE
    layer's input is routed once more to count the share of assignments
    dropped at the config's capacity factor (1.25); the first MoE layer's
    dispatch, on the first ``MOE_DENSE_TOKENS`` tokens of each prompt row of
    its real input, at a capacity factor that drops nothing (E / top_k)
    against ``apply_dense_reference`` (every expert on every token), within
    a relative norm error of ``MOE_REL_NORM``, and at 1.25 beside it; with
    MLA, one decode step from the prefill's cache under ``mla_absorb`` against
    the expanded step (logits within ``MOE_REL_NORM``), both timed in turns."""
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    cfg, dev = model.cfg, prompt["tokens"].device
    seen: dict = {"drops": []}
    real = moe_lib.apply

    def wrapped(p, mcfg, x, *, act="silu"):
        seen["drops"].append(float(moe_lib.dropped_share(p, mcfg, x)))
        if "x" not in seen:
            seen["p"], seen["x"] = p, x[:, :MOE_DENSE_TOKENS].clone()
        return real(p, mcfg, x, act=act)

    moe_lib.apply = wrapped
    try:
        tok, cache = steps.make_prefill_step(model)(
            params, prompt, model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev))
    finally:
        moe_lib.apply = real
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    check(len(seen["drops"]) == n_moe, f"{cfg.name}: {len(seen['drops'])} MoE calls, want {n_moe}")
    check(all(0.0 <= d < 1.0 for d in seen["drops"]), f"{cfg.name}: drop shares {seen['drops']}")
    out = {"card": card.line, "capacity_factor": cfg.moe.capacity_factor,
           "tokens": SERVE_BATCH * SERVE_PROMPT,
           "capacity": moe_lib.capacity(cfg.moe, SERVE_BATCH * SERVE_PROMPT),
           "dropped_share_by_layer": seen["drops"],
           "dropped_share_mean": sum(seen["drops"]) / n_moe}
    p, x = seen["p"], seen["x"]
    no_drop = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    with torch.no_grad():
        check(float(moe_lib.dropped_share(p, no_drop, x)) == 0.0, f"{cfg.name}: no drops")
        want, want_aux = moe_lib.apply_dense_reference(p, cfg.moe, x)
        got, got_aux = moe_lib.apply(p, no_drop, x)
        at_cf, _ = moe_lib.apply(p, cfg.moe, x)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{cfg.name}: dispatch finite")
    rel = rel_norm(got, want)
    check(rel < MOE_REL_NORM, f"{cfg.name}: dispatch vs dense oracle, relative norm error {rel}")
    out["dispatch_vs_dense"] = {
        "tokens": x.shape[0] * x.shape[1], "capacity": moe_lib.capacity(no_drop, x.shape[0] *
                                                                        x.shape[1]),
        "rel_norm_err": rel, "max_abs_err": float((got.float() - want.float()).abs().max()),
        "aux": float(got_aux), "aux_dense": float(want_aux),
        "dropped_share_at_cf": float(moe_lib.dropped_share(p, cfg.moe, x)),
        "rel_norm_err_at_cf": rel_norm(at_cf, want)}
    del seen, p, x, want, got, at_cf
    if cfg.attention.kind == "mla":
        out["mla_absorbed_vs_expanded"] = mla_absorbed_vs_expanded(model, params, tok, cache)
    del cache
    torch.cuda.empty_cache()
    print(f"moe checks {cfg.name} ({card.line}): {json.dumps(out)}", flush=True)
    return out


def drive_long_context(card: Card) -> dict:
    """minitron-8b's long-context variant (``for_shape(..., long_500k)``: a
    4096-slot ring) at full width and depth through ``build_model`` and
    ``launch/steps.py``: batch 1, a prompt of 8192 tokens, 4 tokens, the 3
    decode steps both ways (the python loop, then the scanned decode from
    the same prefill's cache; tokens and the final rings equal); launch
    counts set to 0 just before and read just after: one flash launch per
    layer in the prefill, none in either decode."""
    from repro_torch.configs import INPUT_SHAPES, for_shape, get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = for_shape(get_config(DECODER_ARCH), INPUT_SHAPES["long_500k"])
    window = cfg.attention.sliding_window
    check(window == 4096, f"long_500k window {window}")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    prompt = model.make_batch(gen, 1, LONG_PROMPT)
    cache = model.init_cache(1, LONG_PROMPT + LONG_GEN, dev)
    check(cache["main.k"].shape[2] == window, f"a ring of {window} slots")
    decode = steps.make_decode_loop(model, LONG_GEN - 1)
    counters = launch_counters()
    print(f"main path: {DECODER_ARCH} long_500k variant (window {window}), batch 1, prompt "
          f"{LONG_PROMPT}, gen {LONG_GEN}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():
        counter.reset()
    start = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, prompt, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - start
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size), f"long-context logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "long-context logits finite")
    tok = torch.argmax(logits[:, -1], dim=-1)
    pos = torch.full((1,), LONG_PROMPT, dtype=torch.int64, device=dev)
    start = time.perf_counter()
    toks, python_cache = decode(params, cache, tok, pos)  # leaves the prefill's cache
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - start
    scan = steps.make_decode_scan(model, LONG_GEN - 1)
    start = time.perf_counter()
    scan_toks, cache = scan(params, cache, tok, pos)  # consumes it, written in place
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - start
    launches = _serving_launches(counters, {"flash_attention": cfg.num_layers}, "long context")
    check(torch.equal(toks, scan_toks), f"long-context decode tokens differ: {toks.tolist()} "
                                        f"vs {scan_toks.tolist()}")
    for leaf in cache:
        check(torch.equal(python_cache[leaf], cache[leaf]),
              f"long-context final cache {leaf} differs between the decodes")
    del python_cache
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "long-context tokens in the vocab")
    last = LONG_PROMPT + LONG_GEN - 2  # the last position written
    held = torch.sort(cache["main.pos_ids"][:, 0].long(), dim=-1).values
    check(bool((held == torch.arange(last - window + 1, last + 1, device=dev)).all()),
          "every layer's ring holds the last 4096 positions")
    run = {"prefill_s": prefill_s, "decode_s_per_token": decode_s / (LONG_GEN - 1),
           "scan_decode_s_per_token": scan_s / (LONG_GEN - 1), "capture_s": scan.capture_seconds,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params_gb": sum(t.numel() * t.element_size() for t in params.values()) / 1e9,
           "launches": launches["flash_attention"], "tokens": [int(tok[0])] + toks[0].tolist()}
    print(f"long context {DECODER_ARCH} ({card.line}): {json.dumps(run)}", flush=True)
    del params, cache, logits
    torch.cuda.empty_cache()
    return {**run, "launches": {"flash_attention": run["launches"]}}


def kernel_category(name: str) -> str:
    """The group a device kernel's time is reported under."""
    if "flash_" in name:
        return "flash_attention"
    if "wkv6" in name:
        return "wkv6"
    if "ssd_kernel" in name:
        return "ssd"
    if any(tag in name for tag in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if "copy" in name:
        return "copies and casts"
    return "other elementwise and reductions"


def profile_once(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall seconds, device busy
    seconds and share, device milliseconds by kernel category, and the
    kernels that took the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    by_category: dict[str, list] = {}
    for e in kernels:
        entry = by_category.setdefault(kernel_category(e.key), [0, 0.0])
        entry[0] += e.count
        entry[1] += e.self_device_time_total / 1e3
    return {"wall_s": wall_s, "device_busy_s": device_s,
            "device_busy_share": device_s / wall_s if device_s > 0 else None,
            "kernels": sum(e.count for e in kernels),
            "by_category_launches_ms": by_category,
            "top_kernels_ms": [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                               for e in top[:8]]}


def drive_serve_fleet(card: Card) -> dict:
    """``serve_fleet`` of rwkv6-7b at full width and depth, K = 2 peers of
    different seeds stacked (bf16), one request group per peer, launch counts
    set to 0 just before and read just after: wkv6 launches once per layer
    and group."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    layers = get_config(SERVE_ARCH).num_layers
    counters = launch_counters()
    print(f"main path: serve_fleet {SERVE_ARCH} full, {FLEET_PEERS} peers, batch {SERVE_BATCH}, "
          f"prompt {SERVE_PROMPT}, gen {SERVE_GEN}", flush=True)
    torch.cuda.empty_cache()
    for counter in counters.values():
        counter.reset()
    out = serve.serve_fleet(SERVE_ARCH, num_peers=FLEET_PEERS, batch=SERVE_BATCH,
                            prompt_len=SERVE_PROMPT, gen_tokens=SERVE_GEN, use_reduced=False,
                            seed=0, verbose=True, device="cuda")
    launches = _serving_launches(counters, {"wkv6": FLEET_PEERS * layers}, "serve_fleet")
    tokens = out["tokens"]
    check(tuple(tokens.shape) == (FLEET_PEERS, SERVE_BATCH, SERVE_GEN), "fleet tokens shape")
    check(bool(((tokens >= 0) & (tokens < 65536)).all()), "fleet tokens in the vocab")
    check(not torch.equal(tokens[0], tokens[1]), "two peers' models answer differently")
    run = {key: out[key] for key in ("serve_s", "capture_s", "tokens_per_s", "peak_memory_gb",
                                     "params_gb")}
    del out
    run["groups_both_ways"] = fleet_both_ways(tokens)
    print(f"serve_fleet ({card.line}): {json.dumps(run)}", flush=True)
    torch.cuda.empty_cache()
    return {"launches": {"wkv6": launches["wkv6"]}, **run}


def fleet_both_ways(fleet_tokens: torch.Tensor, seed: int = 0) -> dict:
    """The K = 2 fleet's parameters and prompts drawn again as ``serve_fleet``
    draws them (peer p from seed + 1 + p, the prompts from ``seed``); each
    group prefilled once, then decoded with the python loop and with the
    scanned decode (its own capture: the group's parameter views sit
    elsewhere).  Both must give ``serve_fleet``'s tokens; decode s/token and
    capture seconds per group, both ways."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model, common
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    model = build_model(get_config(SERVE_ARCH))
    torch.cuda.empty_cache()
    stacked = tf.stacked_init(
        FLEET_PEERS, lambda p: model.init(torch.Generator(device=dev).manual_seed(seed + 1 + p)))
    prompt_gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = tf.stacked_init(FLEET_PEERS,
                              lambda _p: model.make_batch(prompt_gen, SERVE_BATCH, SERVE_PROMPT))
    caches = serve.stack_request_caches(
        model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev), FLEET_PEERS)
    prefill = steps.make_prefill_step(model)
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int64, device=dev)
    out = {}
    for g in range(FLEET_PEERS):
        params = common.row(stacked, g)
        tok, cache = prefill(params, common.row(prompts, g), common.row(caches, g))
        run = {}
        for impl in ("python", "scan"):
            make = steps.make_decode_loop if impl == "python" else steps.make_decode_scan
            decode = make(model, SERVE_GEN - 1)
            torch.cuda.synchronize()
            start = time.perf_counter()
            toks, _ = decode(params, cache, tok, pos)
            torch.cuda.synchronize()
            run[f"decode_s_per_token_{impl}"] = (time.perf_counter() - start) / (SERVE_GEN - 1)
            check(torch.equal(torch.cat([tok[:, None], toks], dim=1), fleet_tokens[g]),
                  f"fleet group {g}: the {impl} decode's tokens differ from serve_fleet's")
            if impl == "scan":
                run["capture_s"] = decode.capture_seconds
        out[f"group{g}"] = run
    del stacked, caches, cache
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.p2pl_mnist import (directed_k8, iid_k100, noniid_k2, straggler_k8,
                                                timevarying_k8)
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    card = Card(card_line())
    print(f"card: {card.line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}",
          flush=True)

    cases = check_kernels(card)
    matching = check_matching_on_card()
    paths = {"serve_batch": drive_serve_batch(card, SERVE_ARCH, {"wkv6": 32})}
    serving = {SERVE_ARCH: recheck_and_break_down(card, SERVE_ARCH, {"wkv6": (0, 31)},
                                                  {"wkv6": 32})}
    paths["serve_fleet_k2"] = drive_serve_fleet(card)
    paths["serve_batch_minitron"] = drive_serve_batch(card, DECODER_ARCH,
                                                      {"flash_attention": 32})
    serving[DECODER_ARCH] = recheck_and_break_down(card, DECODER_ARCH,
                                                   {"flash_attention": (0, 31)},
                                                   {"flash_attention": 32})
    paths["long_context_minitron"] = drive_long_context(card)
    # zamba2: 54 Mamba2 layers through ssd, 9 shared-block applications through
    # flash_attention in every prefill
    paths["serve_batch_zamba2"] = drive_serve_batch(card, HYBRID_ARCH,
                                                    {"ssd": 54, "flash_attention": 9})
    serving[HYBRID_ARCH] = recheck_and_break_down(card, HYBRID_ARCH,
                                                  {"ssd": (0, 53), "flash_attention": (0, 8)},
                                                  {"ssd": 54, "flash_attention": 9})
    # the MoE decoders at published widths and cut depth: deepseek-v2 (MLA, no
    # kernel: 0 launches), qwen3-moe (8 flash_attention launches a prefill)
    for arch, layers, per_prefill, picks in MOE_SERVED:
        paths[f"serve_batch_{arch}"] = drive_serve_batch(card, arch, per_prefill, layers=layers)
        serving[arch] = recheck_and_break_down(card, arch, picks, per_prefill, layers=layers,
                                               extra=moe_checks)
    data = synthetic.mnist_like()
    noniid = noniid_k2(algorithm="p2pl_affinity", local_steps=10)
    iid = iid_k100()
    iid_qint8 = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p, compressor="qint8"))
    paths |= {
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
    # push-sum: directed_k8 (K = 8, the gather design; qint8 through
    # dequant_mix) and iid_k100 with --protocol push_sum (the tile design,
    # then the one-slice segment runtime), each kernel in its mass mode
    directed = directed_k8()
    iid_push = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p, protocol="push_sum"))
    paths |= {
        "directed_k8": drive("directed_k8", directed, DIRECTED_ROUNDS, data, recheck=True),
        "directed_k8_one_way_matching": drive(
            "directed_k8_one_way_matching", directed_k8(schedule="one_way_matching"),
            DIRECTED_ROUNDS, data, recheck=False),
        "directed_k8_link_dropout_qint8": drive(
            "directed_k8_link_dropout_qint8",
            dataclasses.replace(directed_k8(schedule="link_dropout"), p2p=dataclasses.replace(
                directed_k8(schedule="link_dropout").p2p, compressor="qint8")),
            DIRECTED_ROUNDS, data, recheck=True),
        "iid_k100_push_sum": drive("iid_k100_push_sum", iid_push, IID_ROUNDS, data,
                                   recheck=False),
        "iid_k100_push_sum_pod_segment": drive(
            "iid_k100_push_sum_pod_segment", iid_push, IID_POD_ROUNDS, data, recheck=True,
            mix_mode="segment", peer_axis="pod", peers_per_device=iid.p2p.num_peers),
    }
    # asynchronous rounds: straggler_k8 (K = 8, the snapshot mode's gather
    # design), and iid_k100 with per-peer step budgets alone (linear: the
    # synchronous consensus) and with a staleness bound (the snapshot mode's
    # tile); their both-driver runs follow
    iid_linear = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p,
                                                                  steps_profile="linear"))
    iid_stale = dataclasses.replace(iid, p2p=dataclasses.replace(
        iid.p2p, steps_profile="straggler", staleness_bound=3))
    straggler_push = straggler_k8(schedule="round_robin", protocol="push_sum")
    paths |= {
        "iid_k100_linear": drive("iid_k100_linear", iid_linear, IID_ROUNDS, data,
                                 recheck=False),
        "straggler_k8": drive("straggler_k8", straggler_k8(), STRAGGLER_ROUNDS, data,
                              recheck=True),
        "straggler_k8_round_robin_push_sum": drive(
            "straggler_k8_round_robin_push_sum", straggler_push, STRAGGLER_ROUNDS, data,
            recheck=True),
    }
    for label in ("straggler_k8", "straggler_k8_round_robin_push_sum"):
        paths[label]["mode"] = "snapshot"
    # adaptive partner selection: each round's matching chosen on the card
    # from the previous losses, mixed through the dense operands of
    # consensus_mix (gossip; push-sum's mass mode for directed_k8) and of
    # dequant_mix (qint8); eps_greedy at eps 0.5 explores in round 0 only
    tv_adaptive = timevarying_k8(schedule="adaptive")
    tv_eps_greedy = timevarying_k8(schedule="adaptive", partner_rule="eps_greedy",
                                   adaptive_eps=0.5)
    directed_adaptive = directed_k8(schedule="adaptive")
    paths |= {
        "timevarying_k8_adaptive": drive("timevarying_k8_adaptive", tv_adaptive,
                                         ADAPTIVE_ROUNDS, data, recheck=True),
        "timevarying_k8_adaptive_eps_greedy": drive(
            "timevarying_k8_adaptive_eps_greedy", tv_eps_greedy, ADAPTIVE_ROUNDS, data,
            recheck=True),
        "directed_k8_adaptive": drive("directed_k8_adaptive", directed_adaptive,
                                      ADAPTIVE_ROUNDS, data, recheck=True),
        "timevarying_k8_adaptive_qint8": drive(
            "timevarying_k8_adaptive_qint8",
            timevarying_k8(schedule="adaptive", compressor="qint8"), ADAPTIVE_ROUNDS, data,
            recheck=True),
    }
    for label in ("timevarying_k8_adaptive", "timevarying_k8_adaptive_eps_greedy",
                  "directed_k8_adaptive", "timevarying_k8_adaptive_qint8"):
        paths[label]["mode"] = "dense"
    # RWKV6 on sequential MNIST: 31 leaves, N = 100,236, through consensus_mix
    # (gossip and mass mode) and dequant_mix (qint8)
    seqmnist = seqmnist_phase(card, data, cases, paths)
    # both round drivers from the same seed and rounds, bit for bit
    pod = dict(peer_axis="pod", peers_per_device=iid.p2p.num_peers, mix_mode="segment")
    for label, exp, rounds, every, kernel, run_kw in (
        ("noniid_affinity", noniid, 15, 5, "consensus_mix", {}),
        ("iid_k100", iid, 10, 5, "consensus_mix", {}),
        ("iid_k100_qint8", iid_qint8, 10, 5, "dequant_mix", {}),
        ("timevarying_k8_round_robin_qint8",
         timevarying_k8(schedule="round_robin", compressor="qint8"), 9, 3, "dequant_mix", {}),
        ("directed_k8", directed, 15, 5, "consensus_mix", {}),
        ("iid_k100_pod_segment", iid, 10, 5, "segment_mix", pod),
        ("straggler_k8", straggler_k8(), 15, 5, "consensus_mix", {}),
        ("straggler_k8_round_robin_push_sum", straggler_push, 15, 5, "consensus_mix", {}),
        ("iid_k100_straggler_b3", iid_stale, 10, 5, "consensus_mix", {}),
        ("timevarying_k8_adaptive", tv_adaptive, 15, 5, "consensus_mix", {}),
        ("timevarying_k8_adaptive_eps_greedy", tv_eps_greedy, 15, 5, "consensus_mix", {}),
        ("directed_k8_adaptive", directed_adaptive, 15, 5, "consensus_mix", {}),
    ):
        result = compare_drivers(card, label, exp, rounds, every, data, kernel=kernel, **run_kw)
        result["mode"] = ("dense" if exp.p2p.schedule == "adaptive" else
                          "snapshot" if exp.p2p.staleness_bound > 0 else
                          "mass" if exp.p2p.protocol == "push_sum" else "gossip")
        paths[f"{label}_both_drivers"] = result
    for label, exp in (("noniid_affinity", noniid), ("iid_k100", iid),
                       ("iid_k100_qint8", iid_qint8), ("directed_k8", directed)):
        print(f"breakdown {label} ({card.line}): {json.dumps(phase_breakdown(exp, data))}",
              flush=True)
    selection = selection_profile(card, tv_adaptive, data)
    ring = iid_k100(topology="ring")
    large_k = dataclasses.replace(ring, p2p=dataclasses.replace(ring.p2p, num_peers=LARGE_K))
    paths[f"ring_k{LARGE_K}"] = drive_large_k(large_k, LARGE_K_ROUNDS, data)

    entries = []
    for kernel, source, replaces, main_case in (
        ("consensus_mix", "consensus_mix/csrc/consensus_mix.cu",
         "consensus_mix/consensus_mix.py:72", "iid_k100"),
        ("dequant_mix", "consensus_mix/csrc/dequant_mix.cu", "consensus_mix/dequant.py:117",
         "iid_k100_qint8"),
        ("segment_mix", "consensus_mix/csrc/segment_mix.cu", "consensus_mix/segment.py:124",
         f"ring_k{LARGE_K}"),
        ("wkv6", "rwkv6/csrc/wkv6.cu", "rwkv6/rwkv6.py:94", "main_b4_t1024_bf16"),
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "flash_attention/flash_attention.py:124", "main_minitron"),
        ("ssd", "mamba2/csrc/ssd.cu", "mamba2/mamba2.py:98", "main_b4_t1024_bf16"),
    ):
        main = next(c for c in cases[kernel] if c["case"] == main_case)
        by_path = {name: p["launches"][kernel] for name, p in paths.items()
                   if kernel in p["launches"]}
        mass_entry = {}
        if f"{kernel} dense" in cases:
            dense = cases[f"{kernel} dense"]
            dense_main = dense[0]  # timevarying_k8's adaptive round
            dense_paths = {name: n for name, n in by_path.items()
                           if paths[name].get("mode") == "dense"}
            mass_entry["dense_operands"] = {
                "launches": sum(dense_paths.values()), "launches_by_path": dense_paths,
                "max_abs_err": max(c["max_abs_err"] for c in dense),
                **{key: dense_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "bound_card")},
                "shape": f"{dense_main['case']}: K={dense_main['K']} D={dense_main['D']} "
                         f"N={dense_main['N']}",
                "shapes": dense,
                **({"matching_on_card": matching, "selection": selection}
                   if kernel == "consensus_mix" else {})}
        if f"{kernel} snapshot" in cases:
            snap = cases[f"{kernel} snapshot"]
            snap_main = snap[0]  # straggler_k8's shape
            snap_paths = {name: n for name, n in by_path.items()
                          if paths[name].get("mode") == "snapshot"}
            mass_entry["snapshot_mode"] = {
                "launches": sum(snap_paths.values()), "launches_by_path": snap_paths,
                "max_abs_err": max(c["max_abs_err"] for c in snap),
                **{key: snap_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card")},
                "shape": f"{snap_main['case']}: K={snap_main['K']} D={snap_main['D']} "
                         f"N={snap_main['N']}",
                "shapes": snap}
        if f"{kernel} mass" in cases:
            mass_main = cases[f"{kernel} mass"][0]  # the push-sum main path's shape
            mass_paths = {name: n for name, n in by_path.items()
                          if paths[name].get("mode") == "mass"}
            mass_entry["mass_mode"] = {
                "launches": sum(mass_paths.values()), "launches_by_path": mass_paths,
                "max_abs_err": max(c["max_abs_err"] for c in cases[f"{kernel} mass"]),
                **{key: mass_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card")},
                "shape": f"{mass_main['case']}: K={mass_main['K']} D={mass_main['D']} "
                         f"N={mass_main['N']}",
                "shapes": cases[f"{kernel} mass"]}
        if kernel == "wkv6":
            shape = (f"B={main['B']} T={main['T']} H={main['H']} dk={main['dk']} "
                     f"chunk={main['chunk']} {main['dtype']}")
            seq = next(c for c in cases[kernel] if c["case"] == "seqmnist_b256_t196_q49")
            mass_entry["seqmnist_shape"] = {
                **{key: seq[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "bound_card", "max_abs_err")},
                "shape": "B=256 T=196 H=4 dk=16 chunk=49 float32 (rwkv6_features, chunked)",
                "features_max_abs_diff": seqmnist["features_max_abs_diff"]}
        elif kernel == "flash_attention":
            shape = (f"B={main['B']} S={main['S']} H={main['H']} Kh={main['Kh']} D={main['D']} "
                     f"causal {main['dtype']}")
            g16 = next(c for c in cases[kernel] if c["case"] == "qwen3moe_group16")
            mass_entry["qwen3moe_shape"] = {
                **{key: g16[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "bound_card", "max_abs_err",
                                             "rel_norm_err")},
                "shape": "B=4 S=1024 H=64 Kh=4 D=128 causal bfloat16 (qwen3-moe's prefill, "
                         "group 16)",
                "launches": sum(n for name, n in by_path.items() if "qwen3-moe" in name)}
        elif kernel == "ssd":
            shape = (f"B={main['B']} T={main['T']} H={main['H']} G={main['G']} P={main['P']} "
                     f"N={main['N']} chunk={main['chunk']} {main['dtype']}")
        else:
            shape = f"K={main['K']} D={main['D']} N={main['N']}"
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases[kernel]),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "bound_card")},
            "shape": shape,
            **({key: main[key] for key in ("bound_ms_fma", "bound_by_fma", "bound_ms_tensor",
                                          "bound_by_tensor", "route", "split")}
               if kernel == "ssd" else {}),
            "shapes": cases[kernel],
            **mass_entry,
        })
    for entry in entries:
        kernel = entry["name"]
        rechecks = {arch: out["recheck"][kernel] for arch, out in serving.items()
                    if kernel in out["recheck"]}
        if rechecks:
            entry["launches_by_phase"] = {name: p["launches_by_phase"][kernel]
                                          for name, p in paths.items()
                                          if kernel in p.get("launches_by_phase", {})}
            entry["serving_recheck"] = rechecks
    print(f"seqmnist phase: {seqmnist['seconds']:.1f} s of {time.perf_counter() - started:.1f} s "
          f"of the run ({card.line})", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

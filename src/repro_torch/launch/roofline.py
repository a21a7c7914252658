"""Roofline terms of a step, reckoned from the dry run's counts (the
counterpart of the reference's ``repro.launch.roofline``).

The reference derives its terms per (arch x shape x mesh) from compiled HLO.
The port has no HLO: ``launch.op_cost`` counts the step's operations as
they are dispatched, on fake tensors (``launch.dryrun_lib``), and each hand
kernel by its own work (``kernel_work``).  Per card:

    compute term    = the step's FLOPs at the rate of their type         [s]
                      (bf16 tensor FLOPs at the dense bf16 rate; float32
                      at the float32 pipes' rate, since TF32 stays off as
                      the port runs; a hand kernel at the smaller of its
                      counts' times, ``mesh.Card.seconds``)
    memory term     = bytes moved / memory rate                          [s]
    collective term = the peer exchange's bytes / NVLink rate out of a   [s]
                      card (one direction)

against the peaks of ``mesh.Card`` (the H100's, never a TPU's).  These are
reckonings, not measurements.

``kernel_work(name, **shapes)`` gives one hand-kernel call's bytes and
operations: each input read once and each output written once, and the
operations of the kernel's form for the shapes given.  ``chip_smoke.py``
bounds its kernel cases with it and the fake route of every kernel wrapper
(``kernels.fake``) records it, so the kernel table and the dry run read the
same work.  Where a count depends on the data (the real slots of a
consensus round), the caller gives it (``real``); without it every slot
counts.

``model_flops``, ``fmt_seconds``, ``markdown_table``, ``save_reports`` and
``load_reports`` are the reference's, unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.launch import mesh as mesh_lib

# the exchanges of the port's peer group (``core.peer_group.PeerGroup``)
COLLECTIVE_KINDS = ("exchange", "all_gather", "ring_shift", "all_reduce")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    step_kind: str  # train | prefill | decode | consensus
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_wire_bytes_per_chip: float
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_chip: float
    useful_flop_ratio: float
    param_bytes_per_chip: float
    arg_bytes: float
    temp_bytes: float
    extra: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def build_report(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    step_kind: str,
    cost,
    card: mesh_lib.Card,
    state_bytes: float,
    peak_bytes: float,
    model_flops_total: float,
    param_bytes_total: float,
    coll_breakdown: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> Roofline:
    """The roofline of one step from its ``op_cost.OpCost`` (``cost``), the
    bytes of its state (parameters, optimizer state, d, batch, cache) and
    its peak of live bytes, all for the ``chips`` cards together, and the
    exchange's ``coll_breakdown`` ({kind: {"count", "wire_bytes"}}, per
    card)."""
    flops = cost.flops / chips
    hbm_bytes = cost.bytes / chips
    coll_breakdown = {k: v for k, v in (coll_breakdown or {}).items() if v["count"]}
    if not set(coll_breakdown) <= set(COLLECTIVE_KINDS):
        raise ValueError(f"collectives {sorted(coll_breakdown)} outside {COLLECTIVE_KINDS}")
    wire = float(sum(v["wire_bytes"] for v in coll_breakdown.values()))

    compute_s = cost.compute_seconds(card) / chips
    memory_s = hbm_bytes / card.bytes_per_s
    collective_s = wire / card.link_bytes_per_s
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)

    model_flops_per_chip = model_flops_total / chips
    useful = model_flops_per_chip / flops if flops else 0.0
    peak = peak_bytes / chips
    extra = {"part": card.part, "card": card.line, "flops_by_type": cost.flops_by_kind(),
             "kernel_calls": dict(cost.kernel_calls), "peak_bytes": peak,
             "fits": peak <= card.memory_bytes, **(extra or {})}
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        step_kind=step_kind,
        flops_per_chip=flops,
        hbm_bytes_per_chip=hbm_bytes,
        coll_wire_bytes_per_chip=wire,
        coll_breakdown=coll_breakdown,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_per_chip=model_flops_per_chip,
        useful_flop_ratio=useful,
        param_bytes_per_chip=param_bytes_total / chips,
        arg_bytes=state_bytes / chips,
        temp_bytes=peak - state_bytes / chips,
        extra=extra,
    )


# ---------------------------------------------------------------------------
# The hand kernels' work
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel call's bytes (each input read once, each output written
    once) and operations: ``flops`` at the rate of ``kind`` ("float32", the
    float32 pipes; "bf16" or "tf32", the dense tensor rates), or, where the
    kernel can run them on the tensor cores instead, ``tensor_flops`` at
    ``tensor_kind``'s rate (``mesh.Card.work_bound`` takes the smaller
    time)."""

    bytes: float
    flops: float
    kind: str = "float32"
    tensor_flops: float = 0.0
    tensor_kind: str | None = None


def flash_live_pairs(s: int, *, causal: bool, window: int | None) -> int:
    """(q, k) pairs with key k visible to query q, for one (batch row, head)."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, np.int64)
    hi = q if causal else np.full(s, s - 1)
    return int((hi - lo + 1).sum())


def _mix(k, n, d, real=None, elem_bytes=4, mass=False, snapshot=False, rows=None) -> Work:
    """consensus_mix and segment_mix (every mode): 4 operations a real slot
    and element (two multiply-adds), 3 a row and element (the self scale
    and d), a scale a row and element and a divide and y' a slot in the
    mass mode; x (and the snapshot P) read once, mixed and d written once,
    the slot operands (and the mass) read once.  A row range (``rows`` rows)
    reads its slots' rows and its own and writes its two rows, counted as
    the gossip mode's in every mode."""
    e = elem_bytes
    kind = "bf16" if e == 2 else "float32"  # the kernel table bounds bf16 storage so
    if rows is not None:
        real = rows * d if real is None else real
        return Work((real + rows) * n * e + 2 * rows * n * e + 3 * rows * d * 4 + 4 * k,
                    n * (4 * real + 3 * rows), kind)
    real = k * d if real is None else real
    flops = n * (4 * real + (4 if mass else 3) * k) + (2 * (real + k) if mass else 0)
    nbytes = (4 if snapshot else 3) * k * n * e + k * 4 + 3 * k * d * 4 + (2 * k * 4 if mass else 0)
    return Work(nbytes, flops, kind)


def _dequant(k, n, d, real=None, elem_bytes=4, mass=False, leaves=0) -> Work:
    """dequant_mix: the mix's work on the advanced estimates, plus the
    advance (2 operations an element) with a payload of ``leaves`` leaves;
    x and the estimates read, mixed and d written, and with a payload the
    int8 q and the (K, leaves) scales read and the new estimates written."""
    e, payload = elem_bytes, leaves > 0
    real = k * d if real is None else real
    flops = (n * (4 * real + (5 if payload else 3) * k + (k if mass else 0))
             + (2 * (real + k) if mass else 0))
    nbytes = (4 * k * n * e + (k * n + k * leaves * 4 + k * n * e if payload else 0)
              + k * 4 + 3 * k * d * 4 + (2 * k * 4 if mass else 0))
    return Work(nbytes, flops, "bf16" if e == 2 else "float32")


def _slots(p, n, d, real=None, mass=False) -> Work:
    """segment_mix's slot form (float32): a block of p rows and its (p, D,
    N) slots read, mixed and d written, the block's operands (and masses)
    read."""
    real = p * d if real is None else real
    flops = n * (4 * real + (4 if mass else 3) * p) + (2 * (real + p) if mass else 0)
    nbytes = ((p + p * d) * n * 4 + 2 * p * n * 4 + (p + 2 * p * d) * 4
              + ((p + p * d + p) * 4 if mass else 0))
    return Work(nbytes, flops)


def _segment(form="rows", **shapes) -> Work:
    """segment_mix: the gossip kernel's count, or its slot form's."""
    return _slots(**shapes) if form == "slots" else _mix(**shapes)


def _wkv6(b, t, h, dk, q, state, in_bytes=4, out_bytes=4) -> Work:
    """r, k, v (``in_bytes`` each) and the float32 log-decays, u and the
    state in (when given) read once, the output and the final state written
    once; per (b, h) and chunk of n real tokens the operations of the chunk
    form (an exp counts as one), on the float32 pipes."""
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
    return Work(nbytes, b * h * flops)


def _wkv6_bwd(b, t, h, dk, in_bytes, u_rows, state, dstate, dstate_out=True) -> Work:
    """r, k, v, the output's gradient (``in_bytes`` each) and the float32
    log-decays read once, u and the states given read once; dr, dk, dv
    (``in_bytes``), dlogdecay and du (float32) and the initial state's
    gradient (``dstate_out``) written once.  Operations: 12 dk^2 a token and
    head (the forward pass's S do and state update, the reverse pass's G v,
    G^T k and G update) and 34 dk for the per-token dots, exps and
    epilogues (an exp counts as one), on the float32 pipes or, counted
    alike, on the tensor cores at the operands' rate."""
    n = b * t * h * dk
    nbytes = n * (4 * in_bytes + 4) + n * (3 * in_bytes + 4) + 2 * u_rows * h * dk * 4
    nbytes += (int(state) + int(dstate) + int(dstate_out)) * b * h * dk * dk * 4
    flops = b * t * h * (12 * dk * dk + 34 * dk)
    return Work(nbytes, flops, "float32", flops, "bf16" if in_bytes == 2 else "tf32")


def _ssd(b, t, h, g, p, n, q, state, in_bytes) -> Work:
    """x, B and C (in their type), dt, a and the state in (when given) read
    once, y (float32) and the final state written once; per (b, h) and
    chunk of m real steps the operations of the chunk form on the float32
    pipes (an exp counts as one): C B^T and att x below the diagonal, C S^T
    and the state update in full; and the same four products as the
    kernel's TF32 passes make them on the tensor cores: each float32
    operand split in two parts, so C B^T takes 1 pass with bf16 inputs and
    3 with float32, the others 2 and 3 (the exps and scalings left on the
    float32 pipes are under 1% of it)."""
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
    return Work(nbytes, b * h * flops, "float32", b * h * tf32, "tf32")


def _ssd_bwd(b, t, h, g, p, n, in_bytes, a_rows, state, dstate, dstate_out=True) -> Work:
    """x, B and C (``in_bytes`` each), dt and the float32 output gradient
    read once, a and the states given read once; dx, dB, dC (``in_bytes``),
    ddt and da (float32) and the initial state's gradient (``dstate_out``)
    written once.  Operations: 12 P N a token and head (the forward pass's
    state update and S^T dy, the reverse pass's G update, G B, G^T x and
    decay) and 20 (P + N) for the per-token sums, scalings and epilogues (an
    exp counts as one), on the float32 pipes or, counted alike, on the
    tensor cores at the operands' rate."""
    nbytes = 2 * (b * t * h * p + 2 * b * t * g * n) * in_bytes + b * t * h * p * 4
    nbytes += 2 * b * t * h * 4 + 2 * a_rows * h * 4
    nbytes += (int(state) + int(dstate) + int(dstate_out)) * b * h * p * n * 4
    flops = b * t * h * (12 * p * n + 20 * (p + n))
    return Work(nbytes, flops, "float32", flops, "bf16" if in_bytes == 2 else "tf32")


def _flash(b, s, h, kh, d, causal, window, elem_bytes) -> Work:
    """q, k, v read once, o written once; 4 D operations (two multiply-adds
    of D) per live (q, k) pair, at the dense bf16 rate for bf16 operands."""
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elem_bytes
    flops = 4 * d * b * h * flash_live_pairs(s, causal=causal, window=window)
    return Work(nbytes, flops, "bf16" if elem_bytes == 2 else "float32")


def _flash_bwd(b, s, h, kh, d, causal, window, elem_bytes) -> Work:
    """q, k, v, o and do read once, the float32 lse read once, dq, dk and dv
    written once; the five products (s, dp, dv, dq, dk) are 10 D operations
    a live (q, k) pair, 2.5 times the forward's."""
    nbytes = (4 * b * s * h * d + 4 * b * s * kh * d) * elem_bytes + b * h * s * 4
    flops = 10 * d * b * h * flash_live_pairs(s, causal=causal, window=window)
    return Work(nbytes, flops, "bf16" if elem_bytes == 2 else "float32")


FORMS = {"consensus_mix": _mix, "dequant_mix": _dequant, "segment_mix": _segment,
         "wkv6": _wkv6, "wkv6_bwd": _wkv6_bwd, "ssd": _ssd, "ssd_bwd": _ssd_bwd,
         "flash_attention": _flash, "flash_attention_bwd": _flash_bwd}
KERNELS = tuple(FORMS)


def kernel_work(name: str, **shapes) -> Work:
    """One call of hand kernel ``name`` at ``shapes``:

    - ``consensus_mix``: k, n, d, real=None (the real slots; every slot),
      elem_bytes=4, mass=False, snapshot=False, rows=None (a row range's
      row count);
    - ``dequant_mix``: k, n, d, real=None, elem_bytes=4, mass=False,
      leaves=0 (the payload's leaves; 0 without a payload);
    - ``segment_mix``: as consensus_mix (no snapshot, no rows), or
      form="slots" with p, n, d, real=None, mass=False;
    - ``wkv6``: b, t, h, dk, q, state, in_bytes=4, out_bytes=4;
    - ``wkv6_bwd``: b, t, h, dk, in_bytes, u_rows, state, dstate,
      dstate_out=True;
    - ``ssd``: b, t, h, g, p, n, q, state, in_bytes;
    - ``ssd_bwd``: b, t, h, g, p, n, in_bytes, a_rows, state, dstate,
      dstate_out=True;
    - ``flash_attention`` and ``flash_attention_bwd``: b, s, h, kh, d,
      causal, window, elem_bytes.
    """
    if name not in FORMS:
        raise ValueError(f"unknown kernel {name!r}; one of {KERNELS}")
    return FORMS[name](**shapes)


# ---------------------------------------------------------------------------
# The reference's, unchanged
# ---------------------------------------------------------------------------


def model_flops(cfg, shape_cfg, *, peers: int = 1) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D decode/prefill (fwd only);
    N = active params (MoE), D = tokens processed this step (all peers)."""
    n_active = cfg.active_param_count()
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_active * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence (global_batch tokens), at least `peers`
    tokens = max(shape_cfg.global_batch, peers)
    return 2.0 * n_active * tokens


def fmt_seconds(s: float) -> str:
    if s == 0:
        return "0"
    if s < 1e-6:
        return f"{s*1e9:.1f}ns"
    if s < 1e-3:
        return f"{s*1e6:.1f}us"
    if s < 1:
        return f"{s*1e3:.2f}ms"
    return f"{s:.2f}s"


def markdown_table(reports: list[Roofline]) -> str:
    hdr = (
        "| arch | shape | mesh | step | compute | memory | collective | dominant "
        "| useful FLOP ratio | params/chip | coll GiB/chip |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in reports:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.step_kind} "
            f"| {fmt_seconds(r.compute_s)} | {fmt_seconds(r.memory_s)} "
            f"| {fmt_seconds(r.collective_s)} | **{r.dominant}** "
            f"| {r.useful_flop_ratio:.2f} | {r.param_bytes_per_chip/2**30:.2f} GiB "
            f"| {r.coll_wire_bytes_per_chip/2**30:.3f} |"
        )
    return hdr + "\n".join(rows) + "\n"


def save_reports(path: str, reports: list[Roofline]) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in reports], f, indent=1)


def load_reports(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)

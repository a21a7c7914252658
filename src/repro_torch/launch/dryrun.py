"""Dry run of every case: each (arch x input shape x layout) step on fake
tensors, reckoned against the card's peaks (the counterpart of the
reference's ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --out results/dryrun_torch.json --markdown results/dryrun_torch.md

Nothing is allocated and no card is needed: the steps run on
``FakeTensorMode`` stand-ins (``dryrun_lib``), so every figure is reckoned,
not measured.  ``--part`` names the card whose peaks the roofline uses
(``mesh.PEAKS``).  The reference's XLA-only flags are refused.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES
from repro_torch.launch import dryrun_lib, mesh as mesh_lib, roofline

# the reference's flags that only mean something to XLA, and why
XLA_ONLY = {
    "--dump-hlo": "the port is not compiled to HLO: its steps run eagerly, op by op",
    "--cache-layout": "the KV cache sits whole on the one card of its peer (the port does "
                      "not shard a peer over cards)",
    "--consensus-impl": "the consensus step is the consensus_mix kernel; there is no XLA "
                        "lowering to choose",
    "--seq-parallel": "the port does not split a peer over cards (no model axis to shard "
                      "the sequence over)",
}


def _refuse_xla_flags(argv: list[str]) -> None:
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in XLA_ONLY:
            raise SystemExit(f"dryrun: {flag} is refused: {XLA_ONLY[flag]}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    _refuse_xla_flags(argv)
    ap = argparse.ArgumentParser(
        description="Dry run on fake tensors: every case's step, reckoned on the card's peaks")
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"],
                    help="single: one card, one peer; multi: two peers of a card each")
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adamw"])
    ap.add_argument("--algorithm", default="p2pl_affinity",
                    choices=["p2pl_affinity", "local_dsgd"])
    ap.add_argument("--part", default=mesh_lib.DEFAULT_PART, choices=sorted(mesh_lib.PEAKS),
                    help="the card whose published peaks the roofline uses")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--markdown", default="")
    args = ap.parse_args(argv)

    archs = list(ARCHITECTURES) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    layouts = []
    if args.mesh in ("single", "both"):
        layouts.append(mesh_lib.make_production_mesh())
    if args.mesh in ("multi", "both"):
        layouts.append(mesh_lib.make_production_mesh(multi_pod=True))
    card = mesh_lib.Card.for_part(args.part)
    device = dryrun_lib.fake_device()
    print(f"dryrun: fake tensors on {device!r} (no allocation, nothing launched); "
          f"reckoned on {card.part} peaks: {card.bytes_per_s / 1e12} TB/s, "
          f"{card.bf16_flop_per_s / 1e12} TFLOP/s bf16, {card.flop_per_s / 1e12} TFLOP/s "
          f"float32, {card.link_bytes_per_s / 1e9} GB/s NVLink out, "
          f"{card.memory_bytes / 1e9} GB", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results, reports = [], []
    n_fail = 0
    for layout in layouts:
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                res = dryrun_lib.run_case(arch, shape, layout, optimizer=args.optimizer,
                                          algorithm=args.algorithm, card=card)
                dt = time.time() - t0
                if res.ok:
                    r = res.report
                    print(
                        f"[ok]   {arch:22s} {shape:12s} {layout.name:8s} "
                        f"{r.step_kind:8s} comp={roofline.fmt_seconds(r.compute_s)} "
                        f"mem={roofline.fmt_seconds(r.memory_s)} "
                        f"coll={roofline.fmt_seconds(r.collective_s)} "
                        f"dom={r.dominant} peak={r.extra['peak_bytes'] / 2**30:.1f}GiB "
                        f"fits={res.fits} ({dt:.1f}s)",
                        flush=True,
                    )
                    reports.append(r)
                    if res.consensus_report:
                        reports.append(res.consensus_report)
                else:
                    n_fail += 1
                    print(f"[FAIL] {arch:22s} {shape:12s} {layout.name}\n{res.error}",
                          flush=True)
                results.append({
                    "arch": arch, "shape": shape, "mesh": layout.name, "ok": res.ok,
                    "seconds": res.seconds, "fits": res.fits,
                    "kernel_calls": res.kernel_calls, "state_bytes": res.state_bytes,
                    "fake_device": device, "part": card.part,
                    "report": res.report.to_dict() if res.report else None,
                    "consensus": (res.consensus_report.to_dict() if res.consensus_report
                                  else None),
                    "error": res.error,
                })
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(f"Reckoned on fake tensors for the {card.part}'s published peaks "
                    "(not measured).\n\n")
            f.write(roofline.markdown_table(reports))
    print(f"\n{len(results) - n_fail}/{len(results)} cases ran", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())

"""Markdown tables of dry-run sweeps (the counterpart of the reference's
``repro.launch.report``), from the JSON ``launch.dryrun`` writes:

    PYTHONPATH=src python -m repro_torch.launch.report \\
        --single results/dryrun_torch.json [--multi results/dryrun_torch_multi.json] \\
        [--baseline results/an_earlier_sweep.json] --out results/tables_torch.md

The record's fields are the reference's (``roofline.Roofline``), so these
tables read either package's sweeps; the port's peak of live bytes and
whether it fits the card are shown where the sweep has them.  Every figure
is reckoned on fake tensors, not measured.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.roofline import fmt_seconds


def _load(path):
    with open(path) as f:
        return json.load(f)


def _fmt_gib(b):
    return f"{b/2**30:.2f}"


def _peak(p) -> str:
    peak = p.get("extra", {}).get("peak_bytes")
    if peak is None:
        return " | "
    return f"{_fmt_gib(peak)} | {'yes' if p['extra'].get('fits') else 'no'}"


def roofline_table(results, *, title):
    out = [f"### {title}\n"]
    out.append(
        "| arch | shape | step | compute | memory | collective | dominant | "
        "useful FLOPs | params/chip GiB | coll wire GiB/chip | peak GiB/chip | fits |"
    )
    out.append("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in results:
        if not r["ok"]:
            out.append(f"| {r['arch']} | {r['shape']} | FAILED | | | | | | | | | |")
            continue
        p = r["report"]
        out.append(
            f"| {p['arch']} | {p['shape']} | {p['step_kind']} "
            f"| {fmt_seconds(p['compute_s'])} | {fmt_seconds(p['memory_s'])} "
            f"| {fmt_seconds(p['collective_s'])} | **{p['dominant']}** "
            f"| {p['useful_flop_ratio']:.2f} | {_fmt_gib(p['param_bytes_per_chip'])} "
            f"| {_fmt_gib(p['coll_wire_bytes_per_chip'])} | {_peak(p)} |"
        )
    return "\n".join(out) + "\n"


def case_grid(results):
    """One row an architecture, one column an input shape: each case's
    dominant term and its time, its peak of live bytes a card and whether
    that fits the card (the sweep's record of it)."""
    shapes = list(dict.fromkeys(r["shape"] for r in results))
    cells: dict = {}
    for r in results:
        if not r["ok"]:
            cells[r["arch"], r["shape"]] = "FAILED"
            continue
        p = r["report"]
        term = p[f"{p['dominant']}_s"]
        peak = p.get("extra", {}).get("peak_bytes")
        fit = "" if peak is None else (
            f", {_fmt_gib(peak)} GiB{' fits' if p['extra'].get('fits') else ''}")
        cells[r["arch"], r["shape"]] = f"{p['dominant']} {fmt_seconds(term)}{fit}"
    out = ["| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for arch in dict.fromkeys(r["arch"] for r in results):
        out.append(f"| {arch} | " + " | ".join(cells.get((arch, s), "") for s in shapes) + " |")
    return "\n".join(out) + "\n"


def comparison_table(baseline, opt):
    """Baseline vs another sweep: the cases whose collective or memory term
    differs by 1.25x or more."""
    base = {(r["arch"], r["shape"]): r for r in baseline if r["ok"]}
    out = [
        "| arch | shape | term | baseline | optimized | x |",
        "|---|---|---|---|---|---|",
    ]
    for r in opt:
        if not r["ok"]:
            continue
        key = (r["arch"], r["shape"])
        if key not in base:
            continue
        b, o = base[key]["report"], r["report"]
        for term in ("collective_s", "memory_s"):
            bv, ov = b[term], o[term]
            if bv > 0 and (bv / max(ov, 1e-12) >= 1.25 or ov / max(bv, 1e-12) >= 1.25):
                out.append(
                    f"| {r['arch']} | {r['shape']} | {term[:-2]} "
                    f"| {fmt_seconds(bv)} | {fmt_seconds(ov)} "
                    f"| {bv/max(ov,1e-12):.1f}x |"
                )
    return "\n".join(out) + "\n"


def consensus_table(multi):
    out = [
        "| arch | impl | collective | wire GiB/chip | amortized by T=60 |",
        "|---|---|---|---|---|",
    ]
    for r in multi:
        c = r.get("consensus")
        if not c:
            continue
        out.append(
            f"| {c['arch']} | {c['extra'].get('impl','?')} "
            f"| {fmt_seconds(c['collective_s'])} "
            f"| {_fmt_gib(c['coll_wire_bytes_per_chip'])} "
            f"| {fmt_seconds(c['collective_s']/60)}/step |"
        )
    return "\n".join(out) + "\n"


def summarize(results):
    ok = [r for r in results if r["ok"]]
    doms = {}
    for r in ok:
        doms[r["report"]["dominant"]] = doms.get(r["report"]["dominant"], 0) + 1
    fits = sum(1 for r in ok if r.get("fits"))
    return f"{len(ok)}/{len(results)} ran; {fits} fit the card; dominant terms: {doms}"


def _part(results) -> str:
    parts = {r.get("part") for r in results if r.get("part")}
    return ", ".join(sorted(parts)) or "the sweep's"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", required=True, help="a --mesh single sweep")
    ap.add_argument("--multi", default="", help="a --mesh multi sweep")
    ap.add_argument("--baseline", default="", help="an earlier single sweep to compare with")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    single = _load(args.single)
    part = _part(single)
    parts = [
        "## Dry-run / roofline summaries\n",
        f"Reckoned on fake tensors for the {part} peaks (not measured).\n",
        f"- one card: {summarize(single)}",
    ]
    multi = _load(args.multi) if args.multi else None
    if multi is not None:
        parts.append(f"- two peers, a card each: {summarize(multi)}")
    parts.append("")
    parts.append(case_grid(single))
    parts.append(roofline_table(single, title="One card, one peer"))
    if multi is not None:
        parts.append(roofline_table(multi, title="Two peers, a card each (the sharded runtime)"))
        parts += ["### Consensus step across the peers\n", consensus_table(multi)]
    if args.baseline:
        parts += ["### Baseline vs this sweep (>=1.25x deltas)\n",
                  comparison_table(_load(args.baseline), single)]
    with open(args.out, "w") as f:
        f.write("\n".join(parts))
    print("wrote", args.out)


if __name__ == "__main__":
    main()

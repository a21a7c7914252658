"""Time the smollm-135m P2P LM round of two trees in turns on one card.

Runs ``drive_p2p_lm`` of each tree's ``chip_smoke.py`` at smollm-135m (K = 4
peers, batch 4, seq 1024, T = 4, bf16, the first step's gradient check
included) in a process of its own, in turns old, new, new, old, once with the
CUDA caching allocator's fixed segments and once with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``.  Prints each run's
seconds a round, its local and consensus phases, its launches a round, its
peak memory and its profiled round's device time, then the medians by tree
and allocator setting, and writes everything as JSON to ``--out``.

    python tools/lm_round_ab.py --old <an unpacked copy of the old tree>
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = {"fixed": None, "expandable": "expandable_segments:True"}
KEEP = ("seconds", "local_s", "consensus_s", "peak_gb", "launches_per_round", "losses",
        "final_drift")


def child(tree: Path) -> int:
    """One run of ``tree``'s ``drive_p2p_lm`` at smollm-135m; prints its
    numbers as a ``RESULT`` JSON line."""
    import torch

    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke  # for its dataclasses
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.Card(smoke.card_line())
    smoke.build_kernels()
    if "run" in inspect.signature(smoke.drive_p2p_lm).parameters:
        out = smoke.drive_p2p_lm(card, smoke.LM_RUNS[0])
    else:
        out = smoke.drive_p2p_lm(card)
    profile = out["round_profile"]
    result = {key: out[key] for key in KEEP} | {
        "card": card.line, "device_busy_s": profile["device_busy_s"],
        "profiled_wall_s": profile["wall_s"], "kernels": profile["kernels"],
        "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    print("RESULT " + json.dumps(result), flush=True)
    return 0


def run_child(tree: Path, setting: str) -> dict:
    env = dict(os.environ)
    env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    if SETTINGS[setting]:
        env["PYTORCH_CUDA_ALLOC_CONF"] = SETTINGS[setting]
    proc = subprocess.run([sys.executable, __file__, "--child", str(tree)], env=env,
                          capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"the run of {tree} ({setting}) failed: rc {proc.returncode}")
    return json.loads(lines[-1].removeprefix("RESULT "))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, help="an unpacked copy of the old tree")
    parser.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "lm_round_ab.json")
    args = parser.parse_args()
    if args.child:
        return child(args.child.resolve())
    if args.old is None:
        parser.error("--old is required")
    trees = {"old": args.old.resolve(), "new": ROOT}
    runs = []
    for setting in SETTINGS:
        for tag in ("old", "new", "new", "old"):
            res = run_child(trees[tag], setting)
            runs.append({"tree": tag, "setting": setting, **res})
            print(f"{tag} {setting}: seconds a round {res['seconds']}, local "
                  f"{res['local_s']:.4f} s, consensus {res['consensus_s']:.4f} s, device busy "
                  f"{res['device_busy_s']:.4f} s of {res['profiled_wall_s']:.4f} s profiled, "
                  f"{res['kernels']} kernels, peak {res['peak_gb']:.3f} GB, launches a round "
                  f"{res['launches_per_round'][0]} ({res['card']})", flush=True)
    summary = {}
    for setting in SETTINGS:
        for tag in ("old", "new"):
            mine = [r for r in runs if r["tree"] == tag and r["setting"] == setting]
            rounds = [s for r in mine for s in r["seconds"]]
            summary[f"{tag} {setting}"] = {
                "median_s_per_round": statistics.median(rounds), "min": min(rounds),
                "max": max(rounds),
                "median_local_s": statistics.median(r["local_s"] for r in mine),
                "median_device_busy_s": statistics.median(r["device_busy_s"] for r in mine),
                "peak_gb": max(r["peak_gb"] for r in mine)}
    for key, val in summary.items():
        print(f"{key}: {json.dumps(val)}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

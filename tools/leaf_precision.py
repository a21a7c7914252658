"""Measure whether a bf16 model's float32 leaves keep their updates in one
local phase of P2P LM training on the port's flat buffers.

``core.p2p.ParamLayout`` keeps a bf16 rwkv6 or hybrid model's float32 leaves
(rwkv6's ``decay_base`` and ``bonus_u``, the Mamba2 layers' ``dt_bias``,
``A_log`` and ``D``) in a float32 block beside the bf16 buffer, as the
reference keeps them float32.  For each architecture this runs the first
round's local phase (T momentum-SGD steps of K peers, ``run_p2p_lm``'s step
sizes and token draws, seed 0) twice from the same draw: through
``p2p.local_phase_stats`` on the flat buffers, and in a loop over named
leaves, each in its own type, with the same update.  Prints both phases'
per-step losses and, for each float32 leaf, how far it moved in each and the
share of its entries whose update the flat buffers lost (0 where the leaf is
held in float32).

    python tools/leaf_precision.py                      # on the card, LM_RUNS depths
    python tools/leaf_precision.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (arch, layers) as chip_smoke.py's LM_RUNS trains them on one card
DEPTHS = {"rwkv6-7b": 6, "zamba2-2.7b": 42}


def named_phase(task, pcfg, leaves: dict, batches) -> tuple[list, dict]:
    """T momentum-SGD steps on named (K, ...) leaves, each in its own type:
    ``local_phase_stats``'s update (d is 0 in the first round)."""
    x, y = batches
    mom = {name: torch.zeros_like(v) for name, v in leaves.items()}
    losses = []
    for t in range(pcfg.local_steps):
        live = {name: v.detach().requires_grad_(True) for name, v in leaves.items()}
        loss = task.loss_fn(live, (x[t], y[t]))
        grads = torch.autograd.grad(loss.sum(), list(live.values()), materialize_grads=True)
        for (name, v), g in zip(leaves.items(), grads):
            mom[name] = pcfg.momentum * mom[name] + g
            leaves[name] = v - pcfg.lr * mom[name]
        losses.append(loss.detach().float().cpu().tolist())
    return losses, leaves


def measure(arch: str, *, layers: int | None, reduced: bool, peers: int, batch: int, seq: int,
            device: torch.device) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs import reduced as reduce_cfg
    from repro_torch.core import consensus as consensus_lib
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg).replace(dtype="bfloat16")
    elif layers is not None:
        cfg = cfg.replace(num_layers=layers)
    task = task_lib.from_model(build_model(cfg))
    pcfg = train.lm_config(num_peers=peers, local_steps=4, algorithm="p2pl_affinity", lr=1e-2,
                           momentum=0.5, eta_d=0.25)
    tokens, labels = train.lm_token_batches(np.random.default_rng(0), cfg.vocab_size,
                                            num_peers=peers, local_steps=4, batch=batch,
                                            seq=seq)
    batches = tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                    for a in (tokens, labels))
    layout = p2p.ParamLayout.of(task)

    # the reference's types: init_state's draw, each leaf as the model made it
    gen = torch.Generator(device).manual_seed(0)
    init = p2p.resolve_init_fn(task)
    draws = [init(gen) for _ in range(peers)]
    leaves = {name: torch.stack([d[name] for d in draws]) for name in task.param_shapes}
    del draws
    if pcfg.use_max_norm_init:  # as init_state syncs the draw, before the flat buffer's cast
        leaves = consensus_lib.max_norm_sync(leaves)
    wide = [name for name, v in leaves.items() if v.dtype == torch.float32]
    init_wide = {name: leaves[name].clone() for name in wide}

    # the port's flat buffers, from the same draw
    state = p2p.init_state(task, pcfg, seed=0, device=device)
    for name, view in layout.views(*p2p.param_blocks(state)).items():
        if not torch.equal(view, leaves[name]):
            raise RuntimeError(f"{arch}: the two draws of {name} differ")
    # the named leaves wait on the host while the flat buffers' phase runs
    leaves = {name: v.cpu() for name, v in leaves.items()}
    state, flat_losses = p2p.local_phase_stats(state, task, batches, pcfg)
    flat_wide = {name: view.float() for name, view in
                 layout.views(*p2p.param_blocks(state)).items() if name in wide}
    flat_losses = flat_losses.float().cpu().tolist()
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    leaves = {name: v.to(device) for name, v in leaves.items()}
    named_losses, leaves = named_phase(task, pcfg, leaves, batches)
    by_leaf = {}
    for name in wide:
        moved = leaves[name] - init_wide[name]  # float32, as the reference holds it
        moved_flat = flat_wide[name] - init_wide[name].to(layout.dtype_of(name)).float()
        lost = (moved_flat == 0) & (moved != 0)
        by_leaf[name] = {
            "entries": moved.numel(),
            "dtype_in_the_flat_buffers": str(layout.dtype_of(name)),
            "max_abs_moved_float32": float(moved.abs().max()),
            "max_abs_moved_flat": float(moved_flat.abs().max()),
            "share_of_updates_lost": float(lost.float().mean()),
            "rel_err_of_the_move": float(torch.linalg.vector_norm(moved_flat - moved)
                                         / torch.linalg.vector_norm(moved).clamp_min(1e-30)),
            "max_abs_diff_after": float((flat_wide[name] - leaves[name]).abs().max())}
    diff = np.abs(np.asarray(flat_losses) - np.asarray(named_losses))
    span = float(np.ptp(np.asarray(named_losses)[:, 0]))
    return {"arch": arch, "layers": cfg.num_layers, "reduced": reduced, "peers": peers,
            "batch": batch, "seq": seq, "dtype": str(layout.dtype), "float32_leaves": wide,
            "losses_flat": flat_losses, "losses_named_float32_leaves": named_losses,
            "max_abs_loss_diff": float(diff.max()), "loss_change_over_the_phase_peer0": span,
            "by_leaf": by_leaf}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reduced", action="store_true",
                        help="the reference's reduced configs, in bf16 (for the CPU)")
    parser.add_argument("--arch", nargs="*", default=list(DEPTHS), choices=list(DEPTHS))
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "leaf_precision.json")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        import subprocess

        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = "cpu"
    results = []
    for arch in args.arch:
        # chip_smoke.py's LM_RUNS shapes on the card; run_p2p_lm's defaults reduced
        peers, batch, seq = (2, 2 if arch == "rwkv6-7b" else 1, 1024)
        if args.reduced:
            batch, seq = 4, 32
        res = measure(arch, layers=DEPTHS[arch], reduced=args.reduced, peers=peers, batch=batch,
                      seq=seq, device=device) | {"device": card}
        results.append(res)
        print(json.dumps(res), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

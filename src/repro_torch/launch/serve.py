"""Serving: single-model batched decode and the stacked K-model fleet (the
port's ``repro.launch.serve``).

``serve_batch`` serves ONE model: prefill a prompt batch, then greedy-decode
(``serve_model``, which takes a built ``Model``: a config cut in depth, as
``chip_smoke.py`` serves the MoE decoders, goes through the same code).
``decode_impl="scan"`` (the default, as in the reference) decodes through
``launch/steps.py:make_decode_scan``: one decode step captured as a CUDA
graph over the cache, written in place, and replayed once per token;
``decode_impl="python"`` is the Python loop of functional decode steps
(``make_decode_loop``).  Both give the same tokens.  Every prefill runs
eagerly, one hand-written kernel per layer: the dense decoders' attention
through ``flash_attention``, RWKV6's chunked WKV through ``wkv6``, the
hybrid's Mamba2 SSD through ``ssd`` and its shared block's attention through
``flash_attention``, qwen3-moe's and internvl2's GQA attention (the image
prefix and the text, causal) through ``flash_attention``, seamless-m4t's
encoder (non-causal) and decoder self-attention through ``flash_attention``
(deepseek-v2's MLA, both MoE decoders' expert dispatch and the
encoder-decoder's cross-attention have no TPU kernel and run in plain
PyTorch); the decode steps (attention over the KV cache, or the
token-sequential recurrences) launch no kernel.

``serve_fleet`` is the personalized-fleet path: P2PL's product is K
*divergent* models, stacked along a leading K axis as the trainer keeps them
(``core/p2p.py:serving_params``).  ``make_fleet_generate_fn`` serves request
group g under peer ``peer_ids[g]``'s weights.  The reference gathers the
groups' parameter rows and vmaps one generate over them; here the groups
run in turn, each on views ``stacked[peer_id]`` of the stacked leaves, so no
(G, ...) copy of the parameters is made (at RWKV6-7B a row is 15.2 GB, at
minitron-8b 19.8 GB, at zamba2-2.7b 4.7 GB); each group's decode is scanned
(``steps.make_generate_fn``), with its own capture, since each group's
parameter views sit at other addresses.  The
result is the reference's invariant: the fleet is bit-identical to serving
each peer's model separately.  ``peer_axis="pod"`` is the reference's pod
layout, one device per peer: K processes (``core.peer_group.spawn_peers``,
on one card or on the CPU), rank k building peer k's parameters from the
stacked fleet's seed and drawing the stacked fleet's prompts, keeping its
own group's, and serving it through ``steps.make_generate_fn``
(``fleet_rank``): the same tokens as the stacked fleet.

Entry points run on ``cuda`` unless given ``device="cpu"``; times are taken
after ``torch.cuda.synchronize()`` on the card.

CLI:  python -m repro_torch.launch.serve --arch smollm-135m --batch 4 --gen 8
      python -m repro_torch.launch.serve --decode-impl python   # the eager loop
      python -m repro_torch.launch.serve --peers 2        # the stacked fleet
      python -m repro_torch.launch.serve --peers 2 --peer-axis pod   # a process a peer
      python -m repro_torch.launch.serve --arch zamba2-2.7b --full --batch 4 \
          --prompt-len 1024 --gen 16                      # the hybrid, full size
      python -m repro_torch.launch.serve --arch internvl2-2b --full   # 256 patches + text
      python -m repro_torch.launch.serve --arch seamless-m4t-medium --full  # encoder-decoder
      (add --device cpu to run the reduced model on the CPU, --full for the
      full-size model)
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model, common
from repro_torch.models import transformer as tf


def route_params(stacked_params: dict, peer_ids: torch.Tensor) -> dict:
    """Gather each request group's parameter rows: (K, ...) -> (G, ...) copies."""
    return {name: p.index_select(0, peer_ids.to(p.device)) for name, p in stacked_params.items()}


def make_fleet_generate_fn(model, gen_tokens: int) -> Callable:
    """The stacked K-model serving step.

    (stacked_params (K, ...), prompts (G, B, ...), caches (G, ...),
    peer_ids (G,)) -> (tokens (G, B, gen_tokens), caches)

    Request group g decodes under peer ``peer_ids[g]``'s weights; the groups
    run in turn on views of the stacked leaves (``steps.make_generate_fn``
    on ``stacked[peer_ids[g]]``).  The returned function's ``decode`` is
    the groups' shared ``steps.DecodeScan`` (its ``capture_seconds`` sum
    every group's capture), None for ``gen_tokens == 1``.
    """
    generate = steps_lib.make_generate_fn(model, gen_tokens)

    def fleet(stacked_params, prompts, caches, peer_ids):
        toks, new = [], []
        for g, peer in enumerate(peer_ids.tolist()):
            t, c = generate(common.row(stacked_params, peer), common.row(prompts, g),
                            common.row(caches, g))
            toks.append(t)
            new.append(c)
        return torch.stack(toks), {name: torch.stack([c[name] for c in new]) for name in caches}

    fleet.decode = generate.decode
    return fleet


def make_fleet_classify_fn(apply_fn: Callable) -> Callable:
    """Stacked fleet serving for classifier models (the paper's 2NN MLP).

    (stacked_params (K, ...), inputs (G, N, ...), peer_ids (G,)) -> logits
    (G, N, C).  The port's classifiers take the peer axis written out
    (``models.mlp.apply_2nn``), so the routed rows go through one stacked
    forward.
    """

    @torch.no_grad()
    def fleet(stacked_params, inputs, peer_ids):
        return apply_fn(route_params(stacked_params, peer_ids), inputs)

    return fleet


def stack_request_caches(cache: dict, num_groups: int) -> dict:
    """Replicate one fresh decode cache into the (G, ...) group layout: every
    leaf, whatever the family's cache holds (KV caches, recurrent states)."""
    return {name: x.unsqueeze(0).repeat(num_groups, *([1] * x.dim()))
            for name, x in cache.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def _nbytes_gb(tree: dict) -> float:
    return sum(t.numel() * t.element_size() for t in tree.values()) / 1e9


def _model_of(arch: str, use_reduced: bool):
    cfg = get_config(arch)
    return build_model(reduced(cfg) if use_reduced else cfg)


def serve_batch(
    arch: str = "smollm-135m",
    *,
    batch: int = 4,
    prompt_len: int = 16,
    gen_tokens: int = 8,
    use_reduced: bool = True,
    seed: int = 0,
    verbose: bool = False,
    decode_impl: str = "scan",
    device: str | torch.device | None = None,
) -> dict:
    """Single-model serving of the registered ``arch`` (its reduced config
    unless ``use_reduced=False``): ``serve_model`` on the built model."""
    return serve_model(_model_of(arch, use_reduced), batch=batch, prompt_len=prompt_len,
                       gen_tokens=gen_tokens, seed=seed, verbose=verbose,
                       decode_impl=decode_impl, device=device)


def serve_model(
    model,
    *,
    batch: int = 4,
    prompt_len: int = 16,
    gen_tokens: int = 8,
    seed: int = 0,
    verbose: bool = False,
    decode_impl: str = "scan",
    device: str | torch.device | None = None,
) -> dict:
    """Single-model serving of a built ``Model``: prefill, then greedy-decode
    ``gen_tokens - 1``.

    Parameters and prompts are drawn from ``seed`` on the device.  Times are
    host clocks around work that ends in a device synchronize; each step runs
    once, so the first call's one-time costs (cuBLAS handles, the kernel's
    build) are in ``prefill_s``.  ``decode_s_per_token`` is the whole
    decode over its steps; under ``decode_impl="scan"`` that includes the
    warm-up step and the capture, whose time is also ``capture_s`` (None
    under "python" and without a decode).  ``peak_memory_gb`` is the
    device's peak from the prefill on (parameters included), ``None`` on the
    CPU.

    ``gen_tokens=1`` is the EXPLICIT empty decode: zero serve steps run, the
    prefill-sampled token is the only output (``tokens`` is (B, 1)),
    ``decode_steps`` is 0 and ``decode_s_per_token`` is None.
    """
    if gen_tokens < 1:
        raise ValueError(f"need gen_tokens >= 1, got {gen_tokens}")
    if decode_impl not in ("scan", "python"):
        raise ValueError(f"decode_impl must be 'scan' or 'python', got {decode_impl!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    prompt = model.make_batch(gen, batch, prompt_len)
    cache = model.init_cache(batch, prompt_len + gen_tokens, dev)
    prefill = steps_lib.make_prefill_step(model)

    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    tok, cache = prefill(params, prompt, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    decode_steps = gen_tokens - 1
    decode_s = 0.0
    capture_s = None
    if decode_steps == 0:
        out = tok[:, None]
        decode_s_per_token = None
    else:
        pos = torch.full((batch,), steps_lib.prompt_dec_len(prompt), dtype=torch.int64,
                         device=dev)
        if decode_impl == "scan":
            decode = steps_lib.make_decode_scan(model, decode_steps)
        else:
            decode = steps_lib.make_decode_loop(model, decode_steps)
        t0 = time.perf_counter()
        gen_toks, cache = decode(params, cache, tok, pos)
        _sync(dev)
        decode_s = time.perf_counter() - t0
        if decode_impl == "scan":
            capture_s = decode.capture_seconds
        out = torch.cat([tok[:, None], gen_toks], dim=1)
        decode_s_per_token = decode_s / decode_steps

    result = {
        "tokens": out,  # (B, gen_tokens)
        "cache": cache,
        "prefill_s": prefill_s,
        "decode_steps": decode_steps,
        "decode_s_per_token": decode_s_per_token,
        "capture_s": capture_s,
        "tokens_per_s": out.numel() / (prefill_s + decode_s),
        "peak_memory_gb": _peak_gb(dev),
        "params_gb": _nbytes_gb(params),
    }
    if verbose:
        print(f"arch={model.cfg.name} layers={model.cfg.num_layers} batch={batch} "
              f"prompt={prompt_len} gen={gen_tokens} decode_impl={decode_impl} device={dev} params={result['params_gb']:.3f} GB")
        decode_msg = (
            "decode: (empty — gen_tokens=1 samples only the prefill token)"
            if decode_s_per_token is None
            else f"decode: {decode_s_per_token * 1e3:.2f} ms/token"
            + (f" (capture {capture_s * 1e3:.1f} ms included)" if capture_s is not None else "")
        )
        print(f"prefill: {prefill_s * 1e3:.1f} ms; {decode_msg}; "
              f"{result['tokens_per_s']:.1f} tokens/s")
        if result["peak_memory_gb"] is not None:
            print(f"peak memory: {result['peak_memory_gb']:.3f} GB")
        print("sample tokens:", out[0].tolist())
    return result


def serve_fleet(
    arch: str = "smollm-135m",
    *,
    num_peers: int = 8,
    batch: int = 4,
    prompt_len: int = 16,
    gen_tokens: int = 8,
    use_reduced: bool = True,
    seed: int = 0,
    peer_axis: str = "vmap",
    verbose: bool = False,
    device: str | torch.device | None = None,
) -> dict:
    """Serve ``num_peers`` personalized models from ONE stacked process.

    Builds K per-peer parameter sets (independent seeds standing in for a
    trained ``P2PState``'s stacked rows), one request group per peer, and
    runs the whole fleet through ``make_fleet_generate_fn`` (each group's
    decode scanned; ``capture_s`` sums the groups' warm-up steps and
    captures, which ``serve_s`` includes).  ``peer_axis`` "vmap" is the
    stacked layout on one device; "pod" runs one process a peer
    (``fleet_rank``; ``serve_s`` is the slowest rank's, ``peak_memory_gb``
    and ``params_gb`` are a rank's, the largest, and ``ranks`` holds each
    rank's numbers and kernel launches).
    """
    if peer_axis not in ("vmap", "pod"):
        raise ValueError(f"peer_axis must be 'vmap' or 'pod', got {peer_axis!r}")
    dev = resolve_device(device)
    if peer_axis == "pod":
        return _serve_fleet_pod(arch, num_peers, batch, prompt_len, gen_tokens, use_reduced, seed,
                                verbose, dev)
    model = _model_of(arch, use_reduced)
    stacked_params = tf.stacked_init(
        num_peers, lambda p: model.init(torch.Generator(device=dev).manual_seed(seed + 1 + p)))
    prompt_gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = tf.stacked_init(num_peers,
                              lambda _p: model.make_batch(prompt_gen, batch, prompt_len))
    caches = stack_request_caches(model.init_cache(batch, prompt_len + gen_tokens, dev),
                                  num_peers)
    peer_ids = torch.arange(num_peers)
    fleet = make_fleet_generate_fn(model, gen_tokens)

    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    tokens, caches = fleet(stacked_params, prompts, caches, peer_ids)
    _sync(dev)
    serve_s = time.perf_counter() - t0

    result = {
        "tokens": tokens,  # (K, B, gen_tokens)
        "serve_s": serve_s,
        "capture_s": None if fleet.decode is None else fleet.decode.capture_seconds,
        "tokens_per_s": tokens.numel() / serve_s,
        "peak_memory_gb": _peak_gb(dev),
        "params_gb": _nbytes_gb(stacked_params),
    }
    if verbose:
        print(f"arch={arch} fleet: {num_peers} personalized models x {batch} requests x "
              f"{gen_tokens} tokens, peer_axis={peer_axis}, device={dev}, stacked params "
              f"{result['params_gb']:.3f} GB")
        print(f"fleet: {serve_s * 1e3:.1f} ms ({result['tokens_per_s']:.1f} tokens/s)")
        if result["peak_memory_gb"] is not None:
            print(f"peak memory: {result['peak_memory_gb']:.3f} GB")
        print("peer 0 tokens:", tokens[0, 0].tolist())
    return result


def _launch_counts() -> dict[str, int]:
    """The serving kernels' launch counts in this process."""
    from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: PLC0415
    from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: PLC0415
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: PLC0415

    return {"wkv6": wkv6_ops.launches.count, "flash_attention": flash_ops.launches.count,
            "ssd": ssd_ops.launches.count}


def fleet_rank(group, arch: str, use_reduced: bool, batch: int, prompt_len: int,
               gen_tokens: int, seed: int, stacked_params: dict | None = None,
               prompts: dict | None = None) -> dict:
    """A rank of ``serve_fleet(peer_axis="pod")``: peer ``group.rank``'s
    model from ``seed + 1 + rank`` (the stacked fleet's draw), the stacked
    fleet's K prompt groups drawn in peer order from ``seed`` and its own
    kept, served through ``steps.make_generate_fn`` on the rank's device.
    ``stacked_params`` / ``prompts`` (K, ...) leaves, where given, are
    served in place of the draws (e.g. a trained fleet's
    ``p2p.serving_params``), the rank's row of each.  Returns its (B, gen)
    tokens, seconds from a common barrier, capture seconds, peak memory,
    parameter size and kernel launches."""
    dev, me = group.device, group.rank
    model = _model_of(arch, use_reduced)
    if stacked_params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 1 + me))
    else:
        params = {name: t[me].to(dev) for name, t in stacked_params.items()}
    if prompts is None:
        prompt_gen = torch.Generator(device=dev).manual_seed(seed)
        prompts = tf.stacked_init(group.size,
                                  lambda _p: model.make_batch(prompt_gen, batch, prompt_len))
    prompt = {name: t[me].to(dev).clone() for name, t in prompts.items()}
    del prompts
    cache = model.init_cache(batch, prompt_len + gen_tokens, dev)
    generate = steps_lib.make_generate_fn(model, gen_tokens)
    counts = _launch_counts()
    group.barrier()
    _reset_peak(dev)
    t0 = time.perf_counter()
    tokens, _ = generate(params, prompt, cache)
    _sync(dev)
    serve_s = time.perf_counter() - t0
    return {"tokens": tokens, "serve_s": serve_s,
            "capture_s": None if generate.decode is None else generate.decode.capture_seconds,
            "peak_memory_gb": _peak_gb(dev), "params_gb": _nbytes_gb(params),
            "launches": {key: n - counts[key] for key, n in _launch_counts().items()}}


def _serve_fleet_pod(arch, num_peers, batch, prompt_len, gen_tokens, use_reduced, seed,
                     verbose, dev) -> dict:
    """``serve_fleet(peer_axis="pod")``: ``num_peers`` ranks of
    ``fleet_rank`` on ``dev`` (a card's ranks share it; they exchange
    nothing)."""
    from repro_torch.core import peer_group  # noqa: PLC0415

    if dev.type == "cuda":  # built once, here, rather than by every rank
        from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: PLC0415
        from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: PLC0415
        from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: PLC0415
        for module in (wkv6_ops, flash_ops, ssd_ops):
            module.load_kernel()
    ranks = peer_group.spawn_peers(
        fleet_rank, num_peers, dev, args=(arch, use_reduced, batch, prompt_len, gen_tokens, seed),
        inbox_bytes=16)
    tokens = torch.stack([r["tokens"] for r in ranks])
    serve_s = max(r["serve_s"] for r in ranks)
    peaks = [r["peak_memory_gb"] for r in ranks]
    result = {
        "tokens": tokens,  # (K, B, gen_tokens)
        "serve_s": serve_s,
        "capture_s": None if ranks[0]["capture_s"] is None else
        sum(r["capture_s"] for r in ranks),
        "tokens_per_s": tokens.numel() / serve_s,
        "peak_memory_gb": None if peaks[0] is None else max(peaks),
        "params_gb": max(r["params_gb"] for r in ranks),
        "ranks": [{key: r[key] for key in ("serve_s", "capture_s", "peak_memory_gb", "launches")}
                  for r in ranks],
    }
    if verbose:
        print(f"arch={arch} fleet: {num_peers} personalized models x {batch} requests x "
              f"{gen_tokens} tokens, peer_axis=pod ({num_peers} processes), device={dev}, "
              f"params {result['params_gb']:.3f} GB a process")
        print(f"fleet: {serve_s * 1e3:.1f} ms ({result['tokens_per_s']:.1f} tokens/s)")
        print("peer 0 tokens:", tokens[0, 0].tolist())
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    help="a registered architecture: smollm-135m, minitron-8b, phi4-mini-3.8b, "
                         "qwen1.5-32b, rwkv6-7b, zamba2-2.7b, internvl2-2b, "
                         "seamless-m4t-medium, deepseek-v2-236b or qwen3-moe-235b-a22b (the "
                         "last two do not fit one 80 GB card with --full)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--peers", type=int, default=0,
                    help="serve this many personalized models from one "
                         "stacked process (0 = single-model serve_batch)")
    ap.add_argument("--peer-axis", default="vmap", choices=["vmap", "pod"],
                    help="with --peers: 'vmap' stacks the fleet on one device; 'pod' runs "
                         "one process a peer, each serving its own request group (on one "
                         "card, or on the CPU with --device cpu)")
    ap.add_argument("--decode-impl", default="scan", choices=["scan", "python"],
                    help="single-model decode driver: 'scan' replays one captured CUDA "
                         "graph of the decode step per token (the reference's fused "
                         "decode); 'python' is the per-token eager loop (parity baseline)")
    ap.add_argument("--full", action="store_true", help="use the full (non-reduced) config")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.peers:
        serve_fleet(
            args.arch,
            num_peers=args.peers,
            batch=args.batch,
            prompt_len=args.prompt_len,
            gen_tokens=args.gen,
            use_reduced=not args.full,
            peer_axis=args.peer_axis,
            verbose=True,
            device=args.device,
        )
        return
    serve_batch(
        args.arch,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen_tokens=args.gen,
        use_reduced=not args.full,
        verbose=True,
        decode_impl=args.decode_impl,
        device=args.device,
    )


if __name__ == "__main__":
    main()

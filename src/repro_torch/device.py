"""Device selection shared by the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  Without a CUDA device and without an
explicit ``"cpu"`` it raises: a run meant for the GPU never carries on, and
never reports its numbers, on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev

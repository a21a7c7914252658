"""PyTorch/CUDA port of the P2PL-with-Affinity system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``data``, ``core``, ``models``, ``configs``, ``kernels``, ``launch``)
and runs the same algorithm on an NVIDIA GPU.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; see ``repro_torch.device``.
"""

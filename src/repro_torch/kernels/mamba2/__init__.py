"""Chunked Mamba2 SSD: CUDA kernel (``csrc/``), plain version (``ref.py``) and
the dispatching wrapper (``ops.py``)."""

"""Fused gossip mix + affinity bias: CUDA kernel (``csrc/``), plain version
(``ref.py``) and the dispatching wrapper (``ops.py``)."""

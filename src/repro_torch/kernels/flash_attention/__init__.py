"""Flash attention forward: CUDA kernel (``csrc/``), plain versions
(``ref.py``) and the dispatching wrapper (``ops.py``)."""

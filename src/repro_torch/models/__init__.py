"""Models of the port: the paper's 2NN MLP, the dense GQA decoders and the
RWKV6 language model.

``build_model`` re-exports ``registry.build_model``, as the reference's
``repro.models`` does."""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]

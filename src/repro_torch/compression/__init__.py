"""Consensus-payload compression (top-k + int8 with error feedback)."""

from repro_torch.compression.compressors import (
    Compressor,
    FlatPayload,
    NoneCompressor,
    QInt8Compressor,
    QInt8Payload,
    RawPayload,
    TopKCompressor,
    TopKPayload,
    compressor_names,
    ef_compress_leaf,
    ef_compress_tree,
    from_config,
    get_compressor,
    register_compressor,
)

__all__ = [
    "Compressor",
    "FlatPayload",
    "NoneCompressor",
    "QInt8Compressor",
    "QInt8Payload",
    "RawPayload",
    "TopKCompressor",
    "TopKPayload",
    "compressor_names",
    "ef_compress_leaf",
    "ef_compress_tree",
    "from_config",
    "get_compressor",
    "register_compressor",
]

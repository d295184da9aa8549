"""repro_torch.compress: quantized, error-feedback gossip payloads (the
port of ``repro.compress``, DESIGN.md Sec. 13).

Codecs (int8 and fp8 stochastic-rounding quantizers with per-chunk
scales, int4 nibble packing, top-k sparsification, identity) paired with
EF21 error feedback, the frozen :class:`CompressionConfig`, and the
chunk-row plumbing of the simulation engine's dense compressed mix.
"""
from .codecs import CODECS, Codec, get_codec, register_codec
from .config import (CODEC_NAMES, UNCOMPRESSED_BYTES_PER_PARAM,
                     CompressionConfig, resolve)
from .mixing import (compressed_dense_mix, flat_to_rows, init_ef,
                     leaf_to_rows, reference_leaves, rows_to_flat,
                     rows_to_leaf)

__all__ = [
    "CompressionConfig", "CODEC_NAMES", "UNCOMPRESSED_BYTES_PER_PARAM",
    "resolve",
    "Codec", "CODECS", "get_codec", "register_codec",
    "compressed_dense_mix", "init_ef", "reference_leaves",
    "flat_to_rows", "rows_to_flat", "leaf_to_rows", "rows_to_leaf",
]

"""Frozen, hashable compression policy for gossip payloads (the port's
copy of ``repro/compress/config.py``, DESIGN.md Sec. 13).

A :class:`CompressionConfig` names a codec and its parameters.  It
round-trips through JSON and has a CLI form (``int8`` or an inline JSON
object).  :func:`resolve` maps None, ``"none"``, ``""`` and the identity
codec to None, the uncompressed method, before ``make_method`` builds
anything.

Byte accounting lives here too: :meth:`wire_bytes` is the exact
on-wire payload size of one node's gossip message in the padded
chunk-row layout.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass

# registered codec names; the implementations live in
# repro_torch.compress.codecs
CODEC_NAMES = ("identity", "int8", "fp8", "int4", "topk")

# f32 is the uncompressed wire format: the reference's distributed gossip
# casts every mixed leaf to f32 work buffers before it sends them
UNCOMPRESSED_BYTES_PER_PARAM = 4


@dataclass(frozen=True)
class CompressionConfig:
    """Gossip payload compression policy.

    codec:  ``identity`` (no-op, the uncompressed baseline) | ``int8`` |
            ``fp8`` (e4m3) | ``int4`` (two values packed per byte) |
            ``topk`` (per-chunk magnitude sparsification).
    chunk:  elements per scale group — every leaf is raveled per node,
            zero-padded to a chunk multiple and reshaped to (rows,
            chunk) with one f32 scale per row.
    topk_frac: fraction of each chunk kept by the ``topk`` codec.
    error_feedback: carry the EF21 residual in method state (compress
            ``x + e``, keep ``e' = (x + e) - dequant(payload)``).
    seed:   stochastic-rounding hash seed (payload bits are a pure
            function of (seed, step, element index) — no PRNG state).
    """
    codec: str = "identity"
    chunk: int = 256
    topk_frac: float = 0.05
    error_feedback: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.codec not in CODEC_NAMES:
            raise ValueError(f"codec must be one of {CODEC_NAMES}, got "
                             f"{self.codec!r}")
        if self.chunk < 2:
            raise ValueError(f"chunk must be >= 2, got {self.chunk}")
        if self.codec == "int4" and self.chunk % 2:
            raise ValueError("int4 packs two values per byte: chunk must "
                             f"be even, got {self.chunk}")
        if self.codec == "topk" and not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got "
                             f"{self.topk_frac}")

    @property
    def is_identity(self) -> bool:
        return self.codec == "identity"

    @property
    def topk_m(self) -> int:
        """Values kept per chunk row by the topk codec."""
        return max(1, int(round(self.topk_frac * self.chunk)))

    # -- byte accounting ---------------------------------------------------

    def rows(self, n_params: int) -> int:
        """Chunk rows of one node's n_params-element payload."""
        return max(1, math.ceil(n_params / self.chunk))

    def wire_bytes(self, n_params: int) -> int:
        """Exact on-wire bytes of one node's gossip message: payload
        values in the padded chunk-row layout plus one f32 scale per
        row (identity/topk carry no scale; topk sends an int32 index
        per kept value instead)."""
        if self.is_identity:
            return UNCOMPRESSED_BYTES_PER_PARAM * n_params
        r = self.rows(n_params)
        if self.codec == "int8":
            return r * self.chunk + 4 * r
        if self.codec == "fp8":
            return r * self.chunk + 4 * r
        if self.codec == "int4":
            return r * (self.chunk // 2) + 4 * r
        if self.codec == "topk":
            return r * self.topk_m * (4 + 4)
        raise AssertionError(self.codec)

    def compression_ratio(self, n_params: int) -> float:
        """Uncompressed (f32 work buffer) bytes over compressed wire
        bytes for one n_params-element message."""
        return UNCOMPRESSED_BYTES_PER_PARAM * n_params \
            / self.wire_bytes(n_params)

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionConfig":
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CompressionConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_cli(cls, s: "str | CompressionConfig | None"
                 ) -> "CompressionConfig | None":
        """CLI form: a codec name (``int8``), an inline JSON object
        (``{"codec": "topk", "topk_frac": 0.1}``), an existing config
        (passed through) or None/"none"/"" (no compression)."""
        if s is None or isinstance(s, CompressionConfig):
            return s
        s = s.strip()
        if not s or s.lower() == "none":
            return None
        if s.startswith("{"):
            return cls.from_json(s)
        return cls(codec=s)


def resolve(compression) -> CompressionConfig | None:
    """Canonicalize: ``None`` and the identity codec both mean "run the
    uncompressed code path" and map to ``None``, so an identity-codec
    run IS the uncompressed method.  CLI strings are accepted."""
    cfg = CompressionConfig.from_cli(compression) \
        if not isinstance(compression, CompressionConfig) else compression
    if cfg is None or cfg.is_identity:
        return None
    return cfg

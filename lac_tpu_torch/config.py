"""Configuration of the byte and LM coding paths.

Ports ``ByteCodingConfig`` and ``LMCodingConfig`` of
``lac_tpu/config.py:18-75``. Every field serialises to the container's
config, so the two packages must agree on them. The mesh config comes with
the multi-device slice (ROADMAP A13).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ByteCodingConfig", "LMCodingConfig"]


@dataclass(frozen=True)
class ByteCodingConfig:
    """Byte-alphabet coding (turbo or scan codecs); ``rate`` reaches the
    turbo models only, as in ``lac_tpu``."""

    model_id: str = "order0n"     # order0n/order1n/order2n/order0c (turbo) | order0 | markov1 ...
    block_size: int = 1 << 12     # bytes per independent block
    prob_bits: int = 16           # CDF quantization precision (2**prob_bits)
    rate: int = 4                 # adaptation rate base (turbo model)

    def engine_kwargs(self) -> dict:
        kw = {"model_id": self.model_id, "block_size": self.block_size,
              "prob_bits": self.prob_bits}
        if self.model_id in ("order0c", "order0n", "order1n", "order2n"):
            kw["rate"] = self.rate
        return kw


@dataclass(frozen=True)
class LMCodingConfig:
    """LM-predictor coding (the transformer's forward feeds the coder)."""

    model_ref: str = "prng:byte-12l:0"  # prng:<preset>:<seed> | file:<path> (hf: is A11)
    block_tokens: int = 512             # tokens per independent block
    lanes: int = 64                     # batched streams per wave
    prob_bits: int = 16
    window: int | None = None           # context window cap in tokens
    overlap: int = 2                    # window keep fraction denominator
    det8: bool = False                  # integer-reduction forward
    kv8: bool = False                   # int8 KV cache
    w8: bool = False                    # int8 weights
    cache_grow: int = 128               # KV-cache growth bucket (0 = fixed)
    window_mode: str = "auto"           # "auto" | "reprime" | "slide"; the
                                        # container records the resolved mode
    slide_seg: int | None = None        # float slide scan-segment length

    def engine_kwargs(self) -> dict:
        """Keyword mapping for ``runtime.lm_api.lm_compress_bytes``;
        ``window`` caps the model context (``max_seq``)."""
        return {
            "model_ref": self.model_ref,
            "block_tokens": self.block_tokens,
            "lanes": self.lanes,
            "prob_bits": self.prob_bits,
            "overlap": self.overlap,
            "max_seq": self.window,
            "det8": self.det8,
            "kv8": self.kv8,
            "w8": self.w8,
            "cache_grow": self.cache_grow,
            "window_mode": self.window_mode,
            "slide_seg": self.slide_seg,
        }

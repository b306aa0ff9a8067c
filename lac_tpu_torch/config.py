"""Configuration of the byte and LM coding paths.

Ports ``ByteCodingConfig``, ``LMCodingConfig``, ``MeshConfig`` and
``from_dict`` of ``lac_tpu/config.py:18-100``. Every coding field
serialises to the container's config, so the two packages must agree on
them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ByteCodingConfig", "LMCodingConfig", "MeshConfig", "from_dict"]


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

    model_ref: str = "prng:byte-12l:0"  # prng:<preset>:<seed> | hf:<path> | file:<path>
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


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh geometry for the distributed entry points: ``data`` x ``model``
    ranks of the process group (``parallel/mesh.py``)."""

    data: int = -1    # -1: every rank the model dim leaves
    model: int = 1    # tensor-parallel span

    def make(self, devices=None, device=None):
        """The mesh (``parallel.mesh.make_mesh``): ``devices`` one a rank,
        or this rank's ``device``."""
        from .parallel.mesh import make_mesh

        return make_mesh(data=self.data, model=self.model, devices=devices, device=device)


def from_dict(cls, d: dict):
    """Build a config dataclass from a (container or CLI) dict, ignoring
    unknown keys; ``LMCodingConfig`` takes its ``window`` from the wire's
    ``max_seq`` when ``window`` is absent, so it round-trips from a
    container header's config."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in d.items() if k in names}
    if cls is LMCodingConfig and "window" not in d and d.get("max_seq") is not None:
        kw["window"] = d["max_seq"]
    return cls(**kw)

"""Configuration of the byte coding path.

Ports ``ByteCodingConfig`` of ``lac_tpu/config.py:18-33``. Every field
serialises to the container's config, so the two packages must agree on
them. The LM and mesh configs come with later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ByteCodingConfig"]


@dataclass(frozen=True)
class ByteCodingConfig:
    """Byte-alphabet coding (turbo codecs)."""

    model_id: str = "order0n"     # order0n | order1n | order2n | order0c
    block_size: int = 1 << 12     # bytes per independent block
    prob_bits: int = 16           # CDF quantization precision (2**prob_bits)
    rate: int = 4                 # adaptation rate base (turbo model)

    def engine_kwargs(self) -> dict:
        kw = {"model_id": self.model_id, "block_size": self.block_size,
              "prob_bits": self.prob_bits}
        if self.model_id in ("order0c", "order0n", "order1n", "order2n"):
            kw["rate"] = self.rate
        return kw

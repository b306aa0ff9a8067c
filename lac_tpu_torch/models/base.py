"""Predictor protocol for the oracle (host) coding path.

Ports ``lac_tpu/models/base.py`` (:27-125), a copy: pure Python on the
host in both packages.

Capability parity with the reference's duck-typed predictor interface
(``val_to_symbol`` / ``symbol_to_range`` / ``accept`` / ``copy``,
arith_code.py:64-74), redesigned around a single source of truth: a model
exposes its belief as an **integer cumulative-count CDF** (``freq_cdf``), and
the interval mapping into the coder's live width is derived *once* here via
``ops.rescale_cdf``. That removes the floor/ceil-inverse subtlety the
reference needed (arith_code.py:94-110): after rescaling, the CDF total
equals the live width exactly, so lookup and range are trivially consistent.

The batched device paths do not use these objects; they consume integer
CDF arrays directly (see coder/vector.py). These classes are the correctness
oracle and a host coding path that only an explicit call reaches.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Sequence

from ..ops.quantize import rescale_cdf

__all__ = ["Predictor", "CDFBackedPredictor", "Uniform", "StaticCDF"]


class Predictor:
    """Abstract predictor over an alphabet of ``n`` symbols."""

    n: int

    def val_to_symbol(self, v: int, denom: int) -> int:
        raise NotImplementedError

    def symbol_to_range(self, s: int, denom: int) -> tuple[int, int]:
        raise NotImplementedError

    def accept(self, symbol: int) -> None:
        """Update model state after a symbol is coded (both directions)."""

    def copy(self) -> "Predictor":
        """Independent predictor with identical current state."""
        return self


class CDFBackedPredictor(Predictor):
    """Derives the interval mapping from an integer cumulative-count CDF.

    Subclasses implement ``freq_cdf`` (and call ``_invalidate`` when state
    changes). Rescaled CDFs are cached per (state epoch, denom) because the
    coder queries the same width several times per step.
    """

    def __init__(self, n: int):
        self.n = n
        self._epoch = 0
        self._scaled_cache: tuple[int, int, Sequence[int]] | None = None

    def freq_cdf(self) -> Sequence[int]:
        """Cumulative counts, length ``n``, strictly positive total."""
        raise NotImplementedError

    def _invalidate(self) -> None:
        self._epoch += 1

    def _scaled(self, denom: int) -> Sequence[int]:
        c = self._scaled_cache
        if c is not None and c[0] == self._epoch and c[1] == denom:
            return c[2]
        scaled = rescale_cdf(self.freq_cdf(), denom)
        self._scaled_cache = (self._epoch, denom, scaled)
        return scaled

    def val_to_symbol(self, v: int, denom: int) -> int:
        return bisect_right(self._scaled(denom), v)

    def symbol_to_range(self, s: int, denom: int) -> tuple[int, int]:
        scaled = self._scaled(denom)
        if not 0 <= s < self.n:
            raise ValueError(f"symbol {s} outside alphabet of size {self.n}")
        lo = scaled[s - 1] if s > 0 else 0
        return lo, scaled[s]

    def accept(self, symbol: int) -> None:
        self._invalidate()


class Uniform(Predictor):
    """Closed-form uniform model. ``val_to_symbol(v) = v*n // denom`` paired
    with **ceiling-division** ranges: ``val_to_symbol(v) == s`` iff
    ``ceil(s*denom/n) <= v < ceil((s+1)*denom/n)``, so the ranges must use
    ceil to partition ``[0, denom)`` consistently. (The reference's base
    Predictor at arith_code.py:64-74 floors both sides, which mis-assigns
    boundary values for some (n, denom); its CDFPredictor gets the pairing
    right at arith_code.py:105-110 — this class adopts the correct pairing.)
    Requires ``denom >= n`` for nonempty ranges."""

    def __init__(self, n: int):
        self.n = n

    def val_to_symbol(self, v: int, denom: int) -> int:
        return (v * self.n) // denom

    def symbol_to_range(self, s: int, denom: int) -> tuple[int, int]:
        return -((-s * denom) // self.n), -((-(s + 1) * denom) // self.n)


class StaticCDF(CDFBackedPredictor):
    """Fixed explicit distribution (reference CDFPredictor capability,
    arith_code.py:76-110)."""

    def __init__(self, cdf: Sequence[int]):
        super().__init__(len(cdf))
        if cdf[-1] <= 0 or any(b < a for a, b in zip(cdf, cdf[1:])):
            raise ValueError("cdf must be nondecreasing with positive total")
        self._cdf = list(cdf)

    def freq_cdf(self) -> Sequence[int]:
        return self._cdf

    def accept(self, symbol: int) -> None:  # static: no state
        pass

    def copy(self) -> "StaticCDF":
        return self

"""Base-N <-> binary conversion through the arithmetic coder.

Ports ``lac_tpu/utils/baseconv.py`` (:20-42), a copy, its imports of the
coder deferred as there (utils sits below coder).

Capability parity with the reference's minimal end-to-end demos
(``to_bin``/``from_bin``, arithmetic_coding.py:306-336, and
``compress_base_ten``/``decompress_base_ten``, arithmetic_coding.py:234-299):
a sequence of base-``base`` digits is coded under the uniform predictor, so
the payload is the digits' value in binary (to within the coder's ~2-bit
termination). Unlike the reference demos this round-trips at any precision
(its ``from_bin`` fails at the default precision 48 via uint64 overflow and
its flush drops trailing symbols — SURVEY.md §2.6.1/2).
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["digits_to_bytes", "bytes_to_digits"]


def digits_to_bytes(
    digits: Sequence[int], base: int, precision: int = 48
) -> tuple[bytes, int]:
    """Code base-``base`` digits to a binary payload. Returns
    (payload, exact bit length)."""
    if base < 2:
        raise ValueError("base must be >= 2")
    if any(not (0 <= d < base) for d in digits):
        raise ValueError("digit out of range")
    from ..coder.reference import ac_encode  # deferred: utils <- coder cycle
    from ..models.base import Uniform

    return ac_encode(digits, Uniform(base), precision=precision)


def bytes_to_digits(
    data: bytes, count: int, base: int, precision: int = 48, nbits: int | None = None
) -> list[int]:
    """Decode exactly ``count`` base-``base`` digits from a payload."""
    from ..coder.reference import ac_decode  # deferred: utils <- coder cycle
    from ..models.base import Uniform

    return ac_decode(data, count, Uniform(base), precision=precision, nbits=nbits)

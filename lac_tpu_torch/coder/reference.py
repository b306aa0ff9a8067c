"""Oracle arithmetic coder (pure Python, host-side).

Ports ``lac_tpu/coder/reference.py`` (:42-218), a copy: its payloads and
bit counts are ``lac_tpu``'s byte for byte.

Capability parity with the reference's two coder implementations
(``ACSampler``/``Region``/``CarryBuffer`` at arithmetic_coding.py:9-208 and
``A_to_bin``/``A_from_bin`` at arith_code.py:144-334), redesigned as a single
classic integer arithmetic coder with:

- **E1/E2/E3 renormalization with pending-bit carry counting** instead of the
  reference's bignum carry buffers (``CarryBuffer``, ``bits()``): when the
  interval straddles the midpoint inside the middle half, a counter is
  bumped; the next definite bit releases the inverted pending bits. Bounded
  state, no bignums — the same formulation the batched device coder uses.
- **A proven 2-bit termination**: after renormalization the interval always
  has width > quarter and straddles the midpoint, so either [quarter, half)
  or [half, 3*quarter) is fully contained in it; ``flush`` emits the 2 bits
  naming that dyadic interval. Any bit-padding then keeps the decoder's value
  inside the final interval, so decoding a *known symbol count* (carried in
  the container) is exact. This replaces the reference's lossy impl-#1 flush
  (SURVEY.md §2.6.2) and crash-prone decoder flush (§2.6.3).
- **Exact fractional-bit entropy accounting** kept from the reference
  (``total_encoded_entropy``, arith_code.py:220-226): emitted + pending
  + (-log2(width/one)) tracks the true code length at all times.

Decode correctness requires ``value ∈ [low, high]`` at every step and the
predictor's ``val_to_symbol``/``symbol_to_range`` to be a consistent
partition of ``[0, width)`` — both property-tested in tests/.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

from ..models.base import Predictor
from ..utils.bits import BitReader, BitWriter

__all__ = ["ArithmeticEncoder", "ArithmeticDecoder", "ac_encode", "ac_decode"]

DEFAULT_PRECISION = 48


class _IntervalState:
    """Shared [low, high] interval bookkeeping at ``precision`` bits."""

    __slots__ = ("precision", "one", "half", "quarter", "low", "high")

    def __init__(self, precision: int):
        if precision < 4:
            raise ValueError("precision must be >= 4")
        self.precision = precision
        self.one = 1 << precision
        self.half = self.one >> 1
        self.quarter = self.one >> 2
        self.low = 0
        self.high = self.one - 1

    @property
    def width(self) -> int:
        return self.high - self.low + 1

    def narrow(self, lo: int, hi: int) -> None:
        """Narrow to the sub-range [lo, hi) of the current width."""
        if hi <= lo:
            raise ValueError(f"empty symbol range [{lo},{hi})")
        base = self.low
        self.high = base + hi - 1
        self.low = base + lo


class ArithmeticEncoder:
    def __init__(self, predictor: Predictor, precision: int = DEFAULT_PRECISION):
        self.predictor = predictor
        self.s = _IntervalState(precision)
        self.pending = 0
        self.writer = BitWriter()
        self.symbols_coded = 0
        self.debug_log: list | None = None  # optional event hook, like arith_code.py:164

    # -- accounting (reference arith_code.py:220-226 capability) -----------
    @property
    def emitted_bits(self) -> int:
        return self.writer.bits_written

    @property
    def carried_info(self) -> float:
        """Fractional bits currently held in the interval register."""
        return self.pending - math.log2(self.s.width / self.s.one)

    @property
    def total_code_length(self) -> float:
        return self.emitted_bits + self.carried_info

    # -- core ---------------------------------------------------------------
    def _emit(self, bit: int) -> None:
        self.writer.write(bit)
        inv = 1 - bit
        for _ in range(self.pending):
            self.writer.write(inv)
        self.pending = 0

    def _renorm(self) -> None:
        s = self.s
        while True:
            if s.high < s.half:
                self._emit(0)
            elif s.low >= s.half:
                self._emit(1)
                s.low -= s.half
                s.high -= s.half
            elif s.low >= s.quarter and s.high < 3 * s.quarter:
                self.pending += 1
                s.low -= s.quarter
                s.high -= s.quarter
            else:
                break
            s.low <<= 1
            s.high = (s.high << 1) | 1

    def encode_symbol(self, symbol: int) -> None:
        w = self.s.width
        lo, hi = self.predictor.symbol_to_range(symbol, w)
        if self.debug_log is not None:
            self.debug_log.append((self.s.low, self.s.high, "sym", symbol, lo, hi))
        self.s.narrow(lo, hi)
        self.predictor.accept(symbol)
        self.symbols_coded += 1
        self._renorm()

    def encode(self, symbols: Iterable[int]) -> None:
        for sym in symbols:
            self.encode_symbol(sym)

    def flush(self) -> bytes:
        """Terminate: emit the 2 bits of a dyadic quarter-interval fully
        inside [low, high] (exists by the renorm invariant width > quarter
        with low < half <= high), then return the padded byte payload."""
        s = self.s
        if s.low < s.quarter:
            self._emit(0)
            self._emit(1)
        else:
            self._emit(1)
            self._emit(0)
        s.low = 0
        s.high = s.one - 1
        return self.writer.getvalue()


class ArithmeticDecoder:
    def __init__(
        self,
        predictor: Predictor,
        data: bytes,
        precision: int = DEFAULT_PRECISION,
        nbits: int | None = None,
    ):
        self.predictor = predictor
        self.s = _IntervalState(precision)
        self.reader = BitReader(data, nbits=nbits)
        self.value = self.reader.read_int(precision)
        self.symbols_decoded = 0

    def decode_symbol(self) -> int:
        s = self.s
        w = s.width
        sym = self.predictor.val_to_symbol(self.value - s.low, w)
        lo, hi = self.predictor.symbol_to_range(sym, w)
        s.narrow(lo, hi)
        if not (s.low <= self.value <= s.high):
            raise ValueError(
                "corrupt stream or inconsistent predictor: value left the interval"
            )
        self.predictor.accept(sym)
        self.symbols_decoded += 1
        # mirror of encoder renorm, shifting bits into `value`
        while True:
            if s.high < s.half:
                pass
            elif s.low >= s.half:
                s.low -= s.half
                s.high -= s.half
                self.value -= s.half
            elif s.low >= s.quarter and s.high < 3 * s.quarter:
                s.low -= s.quarter
                s.high -= s.quarter
                self.value -= s.quarter
            else:
                break
            s.low <<= 1
            s.high = (s.high << 1) | 1
            self.value = (self.value << 1) | self.reader.read()
        return sym

    def decode(self, count: int) -> list[int]:
        return [self.decode_symbol() for _ in range(count)]


def ac_encode(
    symbols: Sequence[int], predictor: Predictor, precision: int = DEFAULT_PRECISION
) -> tuple[bytes, int]:
    """One-shot encode. Returns (payload bytes, exact bit length)."""
    enc = ArithmeticEncoder(predictor.copy(), precision)
    enc.encode(symbols)
    data = enc.flush()
    return data, enc.emitted_bits


def ac_decode(
    data: bytes,
    count: int,
    predictor: Predictor,
    precision: int = DEFAULT_PRECISION,
    nbits: int | None = None,
) -> list[int]:
    """One-shot decode of exactly ``count`` symbols (the count travels in the
    container — fixing the reference's trailing-symbol ambiguity)."""
    dec = ArithmeticDecoder(predictor.copy(), data, precision, nbits=nbits)
    return dec.decode(count)

"""Push-style (callback) streaming coder — impl-#1 API parity.

Ports ``lac_tpu/coder/streaming.py`` (:34-186), a copy over the port's
``coder/reference.py``.

The reference ships two coder API styles; this module is the capability
equivalent of its callback/sampler style (``ACSampler``,
arithmetic_coding.py:9-124): symbols are *pushed* into the encoder as they
become available and completed bytes stream out through a callback; bytes
are pushed into the decoder and symbols stream out as soon as they are
unambiguous. The decoder reproduces the reference's windowed lookahead
(``d_bits``/``d_bits_ulp``, arithmetic_coding.py:48-49,99-122): it tracks
the interval of *possible* register values given the bits seen so far and
emits a symbol only when every continuation selects the same one.

Deliberate behavior differences from the reference (SURVEY.md §2.6):

- Termination is the encoder's proven 2-bit dyadic flush plus an explicit
  symbol count, not the lossy ``step(1,2,3)`` + zero-padding heuristic
  (§2.6.2), and there is no dummy-token-after-exhaustion footgun (§2.6.5):
  ``finish()`` is explicit and emits nothing afterwards.
- All interval math is Python int (no uint64 overflow, §2.6.1).
"""

from __future__ import annotations

from collections import deque
from typing import Callable

from ..models.base import Predictor
from ..utils.bits import unpack_bits
from .reference import DEFAULT_PRECISION, ArithmeticEncoder, _IntervalState

__all__ = ["StreamingEncoder", "StreamingDecoder"]


class StreamingEncoder:
    """Incremental encoder: ``push(symbol)`` streams completed bytes to
    ``on_bytes`` (if given); ``finish()`` returns any tail bytes.

    ``on_progress(symbols, emitted_bits, total_code_length)`` is the
    capability equivalent of the reference's ``bits_per_token`` callback
    (arithmetic_coding.py:17,89)."""

    def __init__(
        self,
        predictor: Predictor,
        precision: int = DEFAULT_PRECISION,
        on_bytes: Callable[[bytes], None] | None = None,
        on_progress: Callable[[int, int, float], None] | None = None,
    ):
        self._enc = ArithmeticEncoder(predictor, precision)
        self._on_bytes = on_bytes
        self._on_progress = on_progress
        self._finished = False

    @property
    def symbols_coded(self) -> int:
        return self._enc.symbols_coded

    @property
    def total_code_length(self) -> float:
        return self._enc.total_code_length

    def push(self, symbol: int) -> bytes:
        """Encode one symbol; returns (and forwards) newly completed bytes."""
        if self._finished:
            raise RuntimeError("push after finish")
        self._enc.encode_symbol(symbol)
        out = self._enc.writer.drain()
        if out and self._on_bytes:
            self._on_bytes(out)
        if self._on_progress:
            self._on_progress(
                self._enc.symbols_coded,
                self._enc.emitted_bits,
                self._enc.total_code_length,
            )
        return out

    def finish(self) -> bytes:
        """Flush the termination bits; returns the remaining bytes
        (zero-padded final byte included). Idempotent."""
        if self._finished:
            return b""
        self._finished = True
        self._enc.flush()
        tail = self._enc.writer.drain() + self._enc.writer.flush_partial()
        if tail and self._on_bytes:
            self._on_bytes(tail)
        return tail


class StreamingDecoder:
    """Incremental decoder: ``push(data)`` returns every symbol that is now
    determined regardless of future bits; ``finish(count)`` zero-pads to
    force out the final symbols (sound because the encoder's termination
    interval contains all paddings)."""

    def __init__(
        self,
        predictor: Predictor,
        precision: int = DEFAULT_PRECISION,
        on_symbol: Callable[[int], None] | None = None,
    ):
        self.predictor = predictor
        self.s = _IntervalState(precision)
        self._on_symbol = on_symbol
        # register window: known high bits + `unknown` undetermined low bits
        self._reg = 0
        self._unknown = precision
        self._pending: deque[int] = deque()  # bits that arrived faster than
        self.symbols_decoded = 0             # renorm opened register slots

    # -- internals ----------------------------------------------------------
    def _feed_bit(self, bit: int) -> None:
        self._unknown -= 1
        self._reg |= (bit & 1) << self._unknown

    def _try_decode(self) -> list[int]:
        out: list[int] = []
        s = self.s
        while True:
            vlo = self._reg
            vhi = self._reg | ((1 << self._unknown) - 1)
            if not (s.low <= vlo and vhi <= s.high):
                # bits missing even to pin the register inside the interval
                break
            w = s.width
            sym_lo = self.predictor.val_to_symbol(vlo - s.low, w)
            sym_hi = self.predictor.val_to_symbol(vhi - s.low, w)
            if sym_lo != sym_hi:
                break
            lo, hi = self.predictor.symbol_to_range(sym_lo, w)
            s.narrow(lo, hi)
            self.predictor.accept(sym_lo)
            self.symbols_decoded += 1
            out.append(sym_lo)
            if self._on_symbol:
                self._on_symbol(sym_lo)
            # renorm: mirror encoder E1/E2/E3; each shift opens one unknown bit
            while True:
                if s.high < s.half:
                    adj = 0
                elif s.low >= s.half:
                    adj = s.half
                elif s.low >= s.quarter and s.high < 3 * s.quarter:
                    adj = s.quarter
                else:
                    break
                s.low = (s.low - adj) << 1
                s.high = ((s.high - adj) << 1) | 1
                self._reg = (self._reg - adj) << 1
                self._unknown += 1
        return out

    def _pump(self) -> list[int]:
        out: list[int] = []
        while True:
            fed = False
            while self._pending and self._unknown > 0:
                self._feed_bit(self._pending.popleft())
                fed = True
            got = self._try_decode()
            out.extend(got)
            if not (fed or got):
                return out

    # -- public -------------------------------------------------------------
    def push(self, data: bytes | bytearray) -> list[int]:
        self._pending.extend(unpack_bits(bytes(data)))
        return self._pump()

    def push_bit(self, bit: int) -> list[int]:
        self._pending.append(bit & 1)
        return self._pump()

    def finish(self, count: int) -> list[int]:
        """Force out symbols up to ``count`` total by zero-padding (the
        encoder's flush guarantees this terminates for its own streams)."""
        out: list[int] = []
        guard = 0
        while self.symbols_decoded < count:
            got = self.push_bit(0)
            out.extend(got)
            guard = 0 if got else guard + 1
            if guard > 4 * self.s.precision:
                raise ValueError("stream exhausted before reaching count")
        return out

"""MSB-first bit <-> byte framing.

Ports ``lac_tpu/utils/bits.py`` (:14-113), a copy: it imports nothing of
either package.

Capability parity with the reference's two framing utilities
(``packbits``/``unpackbits`` at arithmetic_coding.py:212-230 and
``group_bits``/``ungroup_bits`` at arith_code.py:336-351), redesigned as a
writer/reader pair with explicit padding semantics: the final byte is
zero-padded on the right, and the exact bit length travels in the container
header instead of being implied (fixes reference defect SURVEY.md §2.6.2/3).
"""

from __future__ import annotations


class BitWriter:
    """Accumulates bits MSB-first into bytes."""

    __slots__ = ("_buf", "_acc", "_nacc", "bits_written")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0
        self._nacc = 0
        self.bits_written = 0

    def write(self, bit: int) -> None:
        self._acc = (self._acc << 1) | (bit & 1)
        self._nacc += 1
        self.bits_written += 1
        if self._nacc == 8:
            self._buf.append(self._acc)
            self._acc = 0
            self._nacc = 0

    def write_int(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.write((value >> i) & 1)

    def getvalue(self) -> bytes:
        """Zero-pad the partial byte and return the full byte string."""
        out = bytes(self._buf)
        if self._nacc:
            out += bytes([self._acc << (8 - self._nacc)])
        return out

    def drain(self) -> bytes:
        """Return (and forget) the *completed* bytes written so far; the
        partial byte stays buffered. Incremental counterpart of
        ``getvalue`` for streaming consumers."""
        out = bytes(self._buf)
        self._buf.clear()
        return out

    def flush_partial(self) -> bytes:
        """Zero-pad and return the buffered partial byte (empty if none),
        resetting the accumulator. For terminating a streamed bit sequence
        after ``drain``; emits each padded byte exactly once."""
        if not self._nacc:
            return b""
        out = bytes([self._acc << (8 - self._nacc)])
        self._acc = 0
        self._nacc = 0
        return out


class BitReader:
    """Reads bits MSB-first from bytes; reads past the end yield ``pad_bit``.

    Padded reads are deliberate: the arithmetic decoder needs ``precision``
    bits of lookahead beyond the payload, and the termination protocol
    guarantees correctness under arbitrary padding (see coder/reference.py).
    ``overrun`` counts how many padded bits were consumed.
    """

    __slots__ = ("_data", "_pos", "_bitpos", "pad_bit", "overrun", "nbits")

    def __init__(self, data: bytes, nbits: int | None = None, pad_bit: int = 0):
        self._data = data
        self._pos = 0
        self._bitpos = 0
        self.pad_bit = pad_bit
        self.overrun = 0
        self.nbits = len(data) * 8 if nbits is None else nbits

    def read(self) -> int:
        idx = self._pos * 8 + self._bitpos
        if idx >= self.nbits:
            self.overrun += 1
            return self.pad_bit
        b = (self._data[self._pos] >> (7 - self._bitpos)) & 1
        self._bitpos += 1
        if self._bitpos == 8:
            self._bitpos = 0
            self._pos += 1
        return b

    def read_int(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.read()
        return v


def pack_bits(bits) -> bytes:
    w = BitWriter()
    for b in bits:
        w.write(b)
    return w.getvalue()


def unpack_bits(data: bytes, nbits: int | None = None):
    n = len(data) * 8 if nbits is None else nbits
    for i in range(n):
        yield (data[i >> 3] >> (7 - (i & 7))) & 1

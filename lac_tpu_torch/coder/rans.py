"""rANS bitstream specs, NumPy host implementations.

Ports ``lac_tpu/coder/rans.py:52-151``: the rANS-64/32 spec of the LM path
(``RANS_L``, ``encode_capacity``, ``rans_encode_np``, ``rans_decode_np``)
and the rANS-32/16 spec of the turbo byte codecs (``RANS32_L``,
``rans32_encode_np``, ``rans32_decode_np``). These are the integer specs
that the port's coders, kernels and plain versions are checked against;
every implementation must match them bit for bit.

rANS-64/32 (u64 state, 32-bit renormalisation words, ``prob_bits <= 31``):

- state invariant ``x in [RANS_L, 2**63)``, encode starts at ``x = RANS_L``;
- encode visits symbols in REVERSE order; per symbol, if
  ``x >= ((RANS_L >> prob_bits) << 32) * freq`` emit ``x & 0xFFFFFFFF`` and
  shift right 32 (at most once), then
  ``x = ((x // freq) << prob_bits) + x % freq + cdf_lo``;
- the final state is pushed as two words, low 32 then high 32, and the
  word list is stored in decode order (the reverse of emission order), so a
  decoder reads high, low to seed ``x``;
- decode: ``slot = x & (2**prob_bits - 1)``, find ``s`` with
  ``cdf[s] <= slot < cdf[s+1]``, ``x = freq * (x >> prob_bits) + slot - cdf[s]``,
  and refill one word when ``x < RANS_L``.
- at most ``T + 2`` words a stream of T symbols (``encode_capacity``).

rANS-32/16 (u32 state, 16-bit renormalisation words, ``prob_bits <= 16``):

- state invariant ``x in [RANS32_L, 2**32)``, encode starts at ``x = RANS32_L``;
- encode visits symbols in REVERSE order; per symbol, if
  ``x >= freq << (32 - prob_bits)`` emit ``x & 0xFFFF`` and shift right 16,
  then ``x = ((x // freq) << prob_bits) + x % freq + cdf_lo``;
- the final state is stored as two words, high 16 then low 16, ahead of the
  emitted words in decode order (the reverse of emission order);
- decode: ``slot = x & (2**prob_bits - 1)``, find ``s`` with
  ``cdf[s] <= slot < cdf[s+1]``, ``x = freq * (x >> prob_bits) + slot - cdf[s]``,
  and refill one word when ``x < RANS32_L``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RANS_L", "encode_capacity", "rans_encode_np", "rans_decode_np",
           "RANS32_L", "rans32_encode_np", "rans32_decode_np"]

RANS_L = 1 << 31
_MASK32 = (1 << 32) - 1
RANS32_L = 1 << 16
_MASK16 = (1 << 16) - 1


def encode_capacity(num_symbols: int) -> int:
    """Guaranteed-sufficient rANS-64/32 word capacity for ``num_symbols``."""
    return num_symbols + 2


def rans_encode_np(cdf_lo: np.ndarray, freq: np.ndarray, prob_bits: int) -> np.ndarray:
    """rANS-64/32 single-stream encode. ``cdf_lo[t]``/``freq[t]`` are the
    coded symbol's interval at position ``t`` (forward order). Returns
    uint32 words in decode order."""
    assert 1 <= prob_bits <= 31
    x = RANS_L
    words: list[int] = []
    for t in range(len(freq) - 1, -1, -1):
        f = int(freq[t])
        lo = int(cdf_lo[t])
        x_max = ((RANS_L >> prob_bits) << 32) * f
        if x >= x_max:
            words.append(x & _MASK32)
            x >>= 32
        x = ((x // f) << prob_bits) + (x % f) + lo
    words.append(x & _MASK32)
    words.append((x >> 32) & _MASK32)
    return np.array(words[::-1], dtype=np.uint32)


def rans_decode_np(
    words: np.ndarray, num_symbols: int, cdf_provider, prob_bits: int
) -> list[int]:
    """rANS-64/32 single-stream decode. ``cdf_provider(t, out)`` returns the
    step-``t`` exclusive-prefix CDF (length V+1, total ``2**prob_bits``); it
    may depend on the symbols decoded so far (the LM engine feeds its model
    there)."""
    assert 1 <= prob_bits <= 31
    mask = (1 << prob_bits) - 1
    x = (int(words[0]) << 32) | int(words[1])
    pos = 2
    out: list[int] = []
    for t in range(num_symbols):
        cdf = cdf_provider(t, out)
        slot = x & mask
        s = int(np.searchsorted(cdf, slot, side="right")) - 1
        f = int(cdf[s + 1]) - int(cdf[s])
        x = f * (x >> prob_bits) + slot - int(cdf[s])
        if x < RANS_L:
            x = (x << 32) | int(words[pos])
            pos += 1
        out.append(s)
    return out


def rans32_encode_np(cdf_lo: np.ndarray, freq: np.ndarray, prob_bits: int) -> np.ndarray:
    """Single-stream encode; returns uint16 words in decode order (first two
    words are the final state: high 16, low 16)."""
    assert 1 <= prob_bits <= 16
    x = RANS32_L
    words: list[int] = []
    for t in range(len(freq) - 1, -1, -1):
        f = int(freq[t])
        lo = int(cdf_lo[t])
        x_max = ((RANS32_L >> prob_bits) << 16) * f
        if x >= x_max:
            words.append(x & _MASK16)
            x >>= 16
        x = ((x // f) << prob_bits) + (x % f) + lo
    words.append(x & _MASK16)
    words.append((x >> 16) & _MASK16)
    return np.array(words[::-1], dtype=np.uint16)


def rans32_decode_np(
    words: np.ndarray, num_symbols: int, cdf_provider, prob_bits: int
) -> list[int]:
    """Single-stream decode. ``cdf_provider(t, out)`` returns the step-``t``
    exclusive-prefix CDF (length V+1, total ``2**prob_bits``); it may depend
    on the symbols decoded so far."""
    assert 1 <= prob_bits <= 16
    mask = (1 << prob_bits) - 1
    x = (int(words[0]) << 16) | int(words[1])
    pos = 2
    out: list[int] = []
    for t in range(num_symbols):
        cdf = cdf_provider(t, out)
        slot = x & mask
        s = int(np.searchsorted(cdf, slot, side="right")) - 1
        f = int(cdf[s + 1]) - int(cdf[s])
        x = f * (x >> prob_bits) + slot - int(cdf[s])
        if x < RANS32_L:
            x = (x << 16) | int(words[pos])
            pos += 1
        out.append(s)
    return out

"""Batched rANS-64/32 over lanes, as torch ops: the LM path's coder.

Ports ``lac_tpu/coder/vector.py:42-178``: the encode scan
(``_encode_scan``, ``rans_encode_batch``), ``RansDecState``,
``rans_decode_init``, the decode step (``_decode_step``; the engine calls
it inside its model loop) and ``rans_decode_scan``. Bit for bit the spec of
``coder/rans.py`` (``rans_encode_np`` / ``rans_decode_np``), over B
independent streams held as tensor lanes on any device:

- encode: one step per position in reverse time, at most one 32-bit word
  emitted per lane per step (``utils/scan.py``'s loop: on the card a chunk
  of 64 steps is one CUDA graph replay), then each lane's words put in
  decode order;
- decode: one step (the CDF slot search, the state update and the refill)
  that the LM engine runs inside its model loop.

torch has no usable uint64 arithmetic, so states and words are **int64**,
and every value stays below 2**63: the state is in ``[2**31, 2**63)``;
``x_max = ((RANS_L >> pb) << 32) * f < 2**63`` since ``f < 2**pb``;
``f * (x >> pb) < 2**63`` likewise; a refill shifts a state that is below
2**31 (the shift takes ``x & (RANS_L - 1)``, which equals ``x`` when the
refill is taken, so an untaken one cannot overflow either). Words are u32
values held in int64; callers store them as ``>u4`` bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.scan import scan
from .rans import RANS_L

__all__ = [
    "rans_encode_batch",
    "RansDecState",
    "rans_decode_init",
    "rans_decode_scan",
]

i64 = torch.int64
_MASK32 = (1 << 32) - 1


def _encode_scan(cdf_lo: torch.Tensor, freq: torch.Tensor, lengths: torch.Tensor,
                 prob_bits: int, cap: int):
    """Core batched encode. cdf_lo/freq: [B, T] integer; lengths: [B].
    Returns (words [B, cap] int64 in decode order, nwords [B] int64).

    The scan keeps each step's emit flag and low word; the decode order is
    the final state (high, low) and then the emitted words in increasing t
    (emission runs in decreasing t), so one stable sort per lane places
    them: no per-step indexed write."""
    b, t_len = freq.shape
    dev = freq.device
    x = torch.full((b,), RANS_L, dtype=i64, device=dev)
    n_emit = torch.zeros((b,), dtype=i64, device=dev)
    body = torch.zeros((b, 0), dtype=i64, device=dev)
    if t_len:
        # [T, B], a step's lanes contiguous
        active = torch.arange(t_len, device=dev)[:, None] < lengths.to(i64)[None, :]
        # a position past a lane's length is never coded: give it f 1 so
        # its (discarded) division is defined on every device
        f_all = torch.where(active, freq.t().to(i64), 1)
        x_max_all = ((RANS_L >> prob_bits) << 32) * f_all

        def step(carry, xt):
            (x,), (act, f, x_max, lo) = carry, xt
            emit = act & (x >= x_max)
            x_ren = torch.where(emit, x >> 32, x)
            x_new = ((x_ren // f) << prob_bits) + (x_ren % f) + lo
            return (torch.where(act, x_new, x),), (emit, x & _MASK32)

        (x,), (emits, lows) = scan(step, (x,), (active, f_all, x_max_all,
                                                cdf_lo.t().to(i64)), reverse=True)
        emit_bt = emits.t()
        n_emit = emit_bt.sum(1)
        order = torch.sort((~emit_bt).to(torch.uint8), dim=1, stable=True).indices
        body = torch.gather(lows.t(), 1, order)
        body = torch.where(torch.arange(t_len, device=dev)[None, :] < n_emit[:, None], body, 0)
    words = torch.cat([(x >> 32)[:, None], (x & _MASK32)[:, None], body], dim=1)
    if cap > words.shape[1]:
        words = torch.cat([words, words.new_zeros((b, cap - words.shape[1]))], dim=1)
    return words[:, :cap], n_emit + 2


def rans_encode_batch(cdf_lo: torch.Tensor, freq: torch.Tensor, lengths: torch.Tensor,
                      prob_bits: int):
    """Encode B streams. ``cdf_lo``/``freq``: [B, T] (the coded symbol's
    interval per position, forward order); ``lengths``: [B]. Returns (words
    [B, T+2] int64 u32 values in decode order, nwords [B] int64), on the
    inputs' device."""
    return _encode_scan(cdf_lo, freq, lengths, prob_bits, freq.shape[1] + 2)


class RansDecState(NamedTuple):
    x: torch.Tensor      # [B] int64
    words: torch.Tensor  # [B, cap] int64, decode order
    pos: torch.Tensor    # [B] int64, the next word's index


def rans_decode_init(words: torch.Tensor) -> RansDecState:
    """Seed each lane's state from its first two words (high, low)."""
    words = words.to(i64)
    x = (words[:, 0] << 32) | words[:, 1]
    pos = torch.full((words.shape[0],), 2, dtype=i64, device=words.device)
    return RansDecState(x, words, pos)


def _decode_step(state: RansDecState, cdf: torch.Tensor, prob_bits: int,
                 active: torch.Tensor):
    """One decode step for all lanes. ``cdf``: [B, V+1] exclusive prefix
    with total 2**prob_bits; ``active``: [B] bool. Returns (sym [B] int64,
    new state); an inactive lane keeps its state and gives symbol 0."""
    x, words, pos = state
    slot = x & ((1 << prob_bits) - 1)
    # symbol = count of cdf entries <= slot, minus 1: a compare and a sum
    # over the row (lac_tpu/coder/vector.py:127-128)
    sym = (cdf <= slot[:, None]).sum(-1) - 1
    lo = torch.gather(cdf, 1, sym[:, None])[:, 0].to(i64)
    hi = torch.gather(cdf, 1, sym[:, None] + 1)[:, 0].to(i64)
    x_new = (hi - lo) * (x >> prob_bits) + slot - lo
    refill = active & (x_new < RANS_L)
    w = torch.gather(words, 1, pos.clamp(max=words.shape[1] - 1)[:, None])[:, 0]
    x_new = torch.where(refill, ((x_new & (RANS_L - 1)) << 32) | w, x_new)
    pos = pos + refill
    x = torch.where(active, x_new, x)
    sym = torch.where(active, sym, 0)
    return sym, RansDecState(x, words, pos)


def rans_decode_scan(words: torch.Tensor, cdfs: torch.Tensor, lengths: torch.Tensor,
                     prob_bits: int) -> torch.Tensor:
    """Pure-coder batched decode with precomputed per-step CDFs (``cdfs``:
    [B, T, V+1]), for tests; the LM engine runs the decode step inside its
    model loop instead. Returns the symbols [B, T] int64."""
    state = rans_decode_init(words)
    lengths = lengths.to(i64)
    syms = []
    for t in range(cdfs.shape[1]):
        sym, state = _decode_step(state, cdfs[:, t], prob_bits, t < lengths)
        syms.append(sym)
    if not syms:
        return torch.zeros((words.shape[0], 0), dtype=i64, device=words.device)
    return torch.stack(syms, dim=1)

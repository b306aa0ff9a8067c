"""The byte models as torch functions over a batch of lanes.

Ports ``lac_tpu/models/functional.py``: the scan protocol and the
XLA-scan models, ``_closed_rescale`` (:55-61), ``ScanModel`` (:64-78),
``Order0Scan`` (:81-98), ``MarkovScan`` (:101-129), ``_uniform_pow2``
and ``_decay_update`` (:148-161; ``_freq_to_cdf``, :164-166, is
``ops.quantize.cdf_from_freq``), ``Order0Decay``
(:169-182), ``MarkovDecay`` (:185-207) and ``MarkovCDF`` (:546-573); and
the turbo models, ``cdf_state_init`` / ``cdf_state_to_coder`` /
``cdf_state_update`` (:250-275) and ``Order0CDF`` (:292-311), any ``V``
and ``prob_bits`` (the turbo path runs them at 256 and 16),
``adaptive_rate`` (:277-289), ``nib_state_init`` / ``nib_state_to_coder``
/ ``nib_state_update`` (:347-374), ``Order0NibCDF`` (:376-423),
``Order1NibCDF`` (:425-481) and ``Order2NibCDF`` (:483-543), which take
``vocab`` 256 and ``prob_bits`` 16 only, as the reference's. This is the
models' spec in the port: the kernels of ``ops/rans_kernels.py`` and their
plain versions must give the intervals that ``cdf`` gives here, and the
scan engine (``runtime/engine.py``) steps any of them.

A model is ``init_state(batch, device)``, ``cdf(state)`` (int32 ``[B,
V+1]`` exclusive prefix with total ``2**prob_bits``, every width >= 1) and
``update(state, syms)``, pure as the reference's; ``update_`` may write
the state's tables in place and is what the engine and the plain kernel
versions step with, since a copy of every table a step costs more than the
step (a Markov table is ``[B, V, V]``). Symbols are int64 tensors, and so
is a state's ``prev``; every other state tensor is int32, as the
reference's. The counts models rescale their cumulative counts to the
coder's total with one int64 floor division an entry,
``(cum * (2**pb - V)) // total + j``; the decay models keep their
frequencies summing to ``2**pb`` (the sum of the decrements pinned to
int32), so their table is the CDF.

order0c is one joint-byte CDF per lane, kept pre-scaled in the coding
domain: ``state[k]`` in ``[0, M]`` with ``M = 2**16 - 256``, the coder's
boundary ``k`` is ``state[k] + k`` (so every width is >= 1 and
``state[256] = M`` gives the total 2**16), and a step moves each boundary
``>> rate`` toward the observed byte's one-hot CDF, the rate taken from the
global step.

A byte ``s = 16*h + l`` is modelled as ``P(h) * P(l | h)``: one hi-nibble
CDF row and one lo-nibble CDF row, each picked from a table by a context.
States are 15-bit and scaled to the 8-bit coding domain per step,
``eff[k] = ((state[k]*240) >> 15) + k``; the two nibble intervals compose
into one 16-bit rANS step, ``lo12 = (lo_h << 8) + f_h*lo_l`` and
``f12 = f_h*f_l``. The three models differ only in their contexts:

- order0n: one hi row, adapting on the global step schedule; the lo row
  picked by ``h`` (16 contexts), adapting on its own visit count;
- order1n: the hi row picked by the previous byte's hi nibble ``prev_h``
  (16 contexts) and the lo row by ``h``, both adapting on visit counts;
- order2n: the hi row as order1n; the lo row picked by
  ``h*4 + (prev_h >> 2)`` (64 contexts).

``hi_row(state)`` and ``lo_row(state, h)`` return the rows in use, so one
loop steps any of the three (``ops/rans_kernels.py``). ``update`` is pure,
as the reference's; ``update_`` writes the tables in place and is what the
plain kernel versions step with, since a copy of every table per step
costs them more than the step itself.

State layouts are the reference's, all int32:
``Order0CDF``: ``(cdf [B, 257], step)``, the step a Python int;
``Order0NibCDF``: ``(sh [B, 17], sl [B, 16, 17], cnt [B, 16], step)``,
the step a Python int; ``Order1NibCDF`` / ``Order2NibCDF``:
``(sh [B, 16, 17], sl [B, 16|64, 17], cnth [B, 16], cntl [B, 16|64],
prev_h [B])``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import torch

from ..ops.quantize import cdf_from_freq

__all__ = [
    "ScanModel",
    "Order0Scan",
    "MarkovScan",
    "Order0Decay",
    "MarkovDecay",
    "MarkovCDF",
    "O0C_V",
    "CDF_STATE_BITS",
    "cdf_state_init",
    "cdf_state_to_coder",
    "cdf_state_update",
    "Order0CDF",
    "NIB_V",
    "NIB_STATE_BITS",
    "adaptive_rate",
    "nib_state_init",
    "nib_state_to_coder",
    "nib_state_update",
    "Order0NibCDF",
    "Order1NibCDF",
    "Order2NibCDF",
]

O0C_V = 256  # order0c alphabet: the byte
# the reference's capacity note: the state's domain is derived from
# prob_bits (``_cdf_m``), not from this
CDF_STATE_BITS = 15
NIB_V = 16  # nibble alphabet
NIB_STATE_BITS = 15  # internal state precision
NIB_CODE_BITS = 8  # per-nibble coding precision (composed prob_bits = 16)
_NIB_S = 1 << NIB_STATE_BITS
_NIB_M = (1 << NIB_CODE_BITS) - NIB_V  # 240


def adaptive_rate(base_rate: int, step):
    """AV1-style rate schedule: adapt fast on a cold model, slow down as the
    block ages. ``step`` is an int or an int32 tensor; the result has the
    same kind."""
    if isinstance(step, torch.Tensor):
        return (
            base_rate
            + (step >= 16).to(torch.int32)
            + (step >= 32).to(torch.int32)
            + (step >= 64).to(torch.int32)
            + (step >= 128).to(torch.int32)
        )
    return base_rate + (step >= 16) + (step >= 32) + (step >= 64) + (step >= 128)


def _cdf_m(prob_bits: int, v: int) -> int:
    return (1 << prob_bits) - v


def cdf_state_init(batch: int, v: int = O0C_V, prob_bits: int = 16,
                   device=None) -> torch.Tensor:
    """Uniform order0c state: [B, V+1] int32 with fixed endpoints 0, M, on
    ``device``."""
    j = torch.arange(v + 1, dtype=torch.int32, device=device)
    return ((j * _cdf_m(prob_bits, v)) // v).expand(batch, v + 1).contiguous()


def _state_v(state: torch.Tensor, v: int | None) -> int:
    """The state's alphabet size V, checked against ``v`` when given."""
    if v is not None and state.shape[-1] != v + 1:
        raise ValueError(f"a state of {state.shape[-1]} boundaries is not one of vocab {v}")
    return state.shape[-1] - 1


def cdf_state_to_coder(state: torch.Tensor, prob_bits: int = 16,
                       v: int | None = None) -> torch.Tensor:
    """[..., V+1] state -> coder CDF with total 2**prob_bits and every width
    >= 1: one iota add, since the state is pre-scaled (``prob_bits`` does
    not enter; ``v``, the reference's argument, is checked against the
    state's V when given)."""
    _state_v(state, v)
    return state + torch.arange(state.shape[-1], dtype=torch.int32, device=state.device)


def cdf_state_update(state: torch.Tensor, syms: torch.Tensor, rate, v: int | None = None,
                     prob_bits: int = 16, *, out=None) -> torch.Tensor:
    """Move the boundaries toward the observed symbol's one-hot CDF.
    ``syms``: [B]; ``rate``: an int or a [B, 1] int32 column; ``v``: the
    alphabet size (the state's V when None); the state's range is
    ``2**prob_bits - V``. ``out`` may be ``state``."""
    m = _cdf_m(prob_bits, _state_v(state, v))
    k = torch.arange(state.shape[-1], dtype=torch.int32, device=state.device)
    toward_zero = state - (state >> rate)
    toward_total = state + ((m - state) >> rate)
    return torch.where(k <= syms[:, None], toward_zero, toward_total, out=out)


@dataclass(frozen=True, kw_only=True)
class ScanModel:
    """The scan protocol's static hyperparameters (module docstring)."""

    vocab: int
    prob_bits: int

    def init_state(self, batch: int, device=None):
        raise NotImplementedError

    def cdf(self, state) -> torch.Tensor:
        raise NotImplementedError

    def update(self, state, syms: torch.Tensor):
        raise NotImplementedError

    def update_(self, state, syms: torch.Tensor):
        return self.update(state, syms)


@dataclass(frozen=True)
class _ByteModel(ScanModel):
    """A turbo model: ``vocab`` 256 and ``prob_bits`` 16 unless given."""

    vocab: int = field(default=O0C_V, kw_only=True)
    prob_bits: int = field(default=16, kw_only=True)


@dataclass(frozen=True)
class Order0CDF(_ByteModel):
    """Adaptive order-0 shift-to-target model (model id "order0c").
    ``cdf`` returns the V+1-entry coder CDF with total 2**prob_bits."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        return (cdf_state_init(batch, self.vocab, self.prob_bits, device), 0)

    def cdf(self, state) -> torch.Tensor:
        return cdf_state_to_coder(state[0])

    def update(self, state, syms: torch.Tensor):
        cdf, step = state
        return (cdf_state_update(cdf, syms, adaptive_rate(self.rate, step), self.vocab,
                                 self.prob_bits), step + 1)

    def update_(self, state, syms: torch.Tensor):
        """As ``update``, writing the new CDF into the old one."""
        cdf, step = state
        cdf_state_update(cdf, syms, adaptive_rate(self.rate, step), self.vocab, self.prob_bits,
                         out=cdf)
        return (cdf, step + 1)


def nib_state_init(batch: int, device=None) -> torch.Tensor:
    """Uniform 15-bit nibble CDF state: [B, 17] int32, endpoints 0 / 2**15."""
    j = torch.arange(NIB_V + 1, dtype=torch.int32, device=device)
    return ((j * _NIB_S) // NIB_V).expand(batch, NIB_V + 1).contiguous()


def nib_state_to_coder(state: torch.Tensor) -> torch.Tensor:
    """15-bit state [..., 17] -> 8-bit coding CDF (total 256, widths >= 1)."""
    j = torch.arange(NIB_V + 1, dtype=torch.int32, device=state.device)
    return ((state * _NIB_M) >> NIB_STATE_BITS) + j


def nib_state_update(state: torch.Tensor, nib: torch.Tensor, rate) -> torch.Tensor:
    """Move 15-bit boundaries toward the observed nibble's one-hot CDF.
    ``nib``: [...] int32; ``rate``: int or a [..., 1] int32 column."""
    k = torch.arange(NIB_V + 1, dtype=torch.int32, device=state.device)
    toward_zero = state - (state >> rate)
    toward_total = state + ((_NIB_S - state) >> rate)
    return torch.where(k <= nib[..., None], toward_zero, toward_total)


def _table_init(batch: int, rows: int, device) -> torch.Tensor:
    """[B, rows, 17] uniform context rows."""
    return nib_state_init(1, device)[0].expand(batch, rows, NIB_V + 1).contiguous()


def _lanes(t: torch.Tensor) -> torch.Tensor:
    return torch.arange(t.shape[0], device=t.device)


def _adapt_(table, cnt, ctx, nib, base_rate: int) -> None:
    """In place: move row ``ctx`` of each lane's table toward ``nib`` at the
    rate of that row's visit count, and count the visit."""
    lane = _lanes(table)
    rate = adaptive_rate(base_rate, cnt[lane, ctx])[:, None]
    table[lane, ctx] = nib_state_update(table[lane, ctx], nib, rate)
    cnt[lane, ctx] += 1


def _compose(effh: torch.Tensor, effl: torch.Tensor) -> torch.Tensor:
    """Composed 257-entry CDF (total 2**16) from the hi boundaries [B, 17]
    and the lo boundaries that each hi nibble picks, [B, 16, 17]."""
    s = torch.arange(256, device=effh.device)
    hs, ls = s >> 4, s & 15
    loh = effh[:, hs]  # [B, 256]
    fh = effh[:, hs + 1] - loh
    cdf = (loh << 8) + fh * effl[:, hs, ls]
    total = torch.full((effh.shape[0], 1), 1 << 16, dtype=torch.int32, device=effh.device)
    return torch.cat([cdf, total], dim=-1)


def _split(syms: torch.Tensor):
    syms = syms.to(torch.int64)
    return syms >> 4, syms & 15


@dataclass(frozen=True)
class _NibModel(_ByteModel):
    def __post_init__(self):
        if self.vocab != 256 or self.prob_bits != 16:
            raise ValueError(f"{type(self).__name__} requires vocab=256, prob_bits=16")


@dataclass(frozen=True)
class Order0NibCDF(_NibModel):
    """Nibble-factorised adaptive byte model (model id "order0n").
    ``cdf`` returns the composed 257-entry CDF with total 2**16."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        sh = nib_state_init(batch, device)
        sl = _table_init(batch, NIB_V, device)
        cnt = torch.zeros((batch, NIB_V), dtype=torch.int32, device=device)
        return (sh, sl, cnt, 0)

    def hi_row(self, state) -> torch.Tensor:
        return state[0]

    def lo_row(self, state, h: torch.Tensor) -> torch.Tensor:
        sl = state[1]
        return sl[_lanes(sl), h]

    def cdf(self, state) -> torch.Tensor:
        sh, sl, _cnt, _step = state
        return _compose(nib_state_to_coder(sh), nib_state_to_coder(sl))

    def update(self, state, syms: torch.Tensor):
        sh, sl, cnt, step = state
        return self.update_((sh, sl.clone(), cnt.clone(), step), syms)

    def update_(self, state, syms: torch.Tensor):
        sh, sl, cnt, step = state
        h, l = _split(syms)
        sh = nib_state_update(sh, h, adaptive_rate(self.rate, step))
        _adapt_(sl, cnt, h, l, self.rate)
        return (sh, sl, cnt, step + 1)


@dataclass(frozen=True)
class _CtxNibCDF(_NibModel):
    """Both nibble rows picked by context, both adapting on visit counts."""

    rate: int = 4
    n_lo: ClassVar[int] = NIB_V

    def lo_ctx(self, h: torch.Tensor, prev_h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, batch: int, device=None):
        sh = _table_init(batch, NIB_V, device)
        sl = _table_init(batch, self.n_lo, device)
        cnth = torch.zeros((batch, NIB_V), dtype=torch.int32, device=device)
        cntl = torch.zeros((batch, self.n_lo), dtype=torch.int32, device=device)
        prev_h = torch.zeros((batch,), dtype=torch.int32, device=device)
        return (sh, sl, cnth, cntl, prev_h)

    def hi_row(self, state) -> torch.Tensor:
        sh, prev_h = state[0], state[4]
        return sh[_lanes(sh), prev_h]

    def lo_row(self, state, h: torch.Tensor) -> torch.Tensor:
        sl, prev_h = state[1], state[4]
        return sl[_lanes(sl), self.lo_ctx(h, prev_h)]

    def cdf(self, state) -> torch.Tensor:
        effl = torch.stack(
            [nib_state_to_coder(self.lo_row(state, torch.full_like(state[4], h)))
             for h in range(NIB_V)], dim=1)
        return _compose(nib_state_to_coder(self.hi_row(state)), effl)

    def update(self, state, syms: torch.Tensor):
        return self.update_(tuple(a.clone() for a in state), syms)

    def update_(self, state, syms: torch.Tensor):
        sh, sl, cnth, cntl, prev_h = state
        h, l = _split(syms)
        lc = self.lo_ctx(h, prev_h)  # from the previous byte, before prev_h moves
        _adapt_(sh, cnth, prev_h, h, self.rate)
        _adapt_(sl, cntl, lc, l, self.rate)
        return (sh, sl, cnth, cntl, h.to(torch.int32))


@dataclass(frozen=True)
class Order1NibCDF(_CtxNibCDF):
    """Order-1 nibble model (model id "order1n"): hi | prev_h, lo | h."""

    n_lo: ClassVar[int] = NIB_V

    def lo_ctx(self, h, prev_h):
        return h


@dataclass(frozen=True)
class Order2NibCDF(_CtxNibCDF):
    """Order-2-lite nibble model (model id "order2n"): hi | prev_h,
    lo | (h, prev_h >> 2), 64 lo contexts."""

    n_lo: ClassVar[int] = 4 * NIB_V

    def lo_ctx(self, h, prev_h):
        return h * 4 + (prev_h.to(h.dtype) >> 2)


# --------------------------------------------------------------------------
# The XLA-scan models (codec rANS-64): counts, decay and the order-1
# shift-to-target model, any vocab and prob_bits.
# --------------------------------------------------------------------------


def _closed_rescale(cum: torch.Tensor, total: torch.Tensor, denom: int, v: int) -> torch.Tensor:
    """cum [..., V+1] int64 inclusive prefix with a leading 0, total [..., 1]
    -> int32 exclusive-prefix CDF with total ``denom``, every width >= 1."""
    j = torch.arange(v + 1, dtype=torch.int64, device=cum.device)
    return ((cum * (denom - v)) // total + j).to(torch.int32)


def _with_zero(c: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)


def _counts_cdf(counts: torch.Tensor, prob_bits: int, v: int) -> torch.Tensor:
    """Laplace counts [B, V] int32 -> the coder CDF of ``count + 1``."""
    cum = _with_zero(torch.cumsum(counts.to(torch.int64) + 1, -1))
    return _closed_rescale(cum, cum[:, -1:], 1 << prob_bits, v)


@dataclass(frozen=True)
class Order0Scan(ScanModel):
    """Adaptive order-0: freq(s) = count(s) + 1. State: counts [B, V] int32."""

    inc: int = 1

    def init_state(self, batch: int, device=None):
        return torch.zeros((batch, self.vocab), dtype=torch.int32, device=device)

    def cdf(self, state) -> torch.Tensor:
        return _counts_cdf(state, self.prob_bits, self.vocab)

    def update(self, state, syms: torch.Tensor):
        return self.update_(state.clone(), syms)

    def update_(self, state, syms: torch.Tensor):
        lane = _lanes(state)
        state[lane, syms] += self.inc
        return state


@dataclass(frozen=True)
class MarkovScan(ScanModel):
    """Adaptive order-1: freq(s | prev) = count(prev, s) + 1. State:
    (counts [B, V, V] int32, prev [B])."""

    def init_state(self, batch: int, device=None):
        counts = torch.zeros((batch, self.vocab, self.vocab), dtype=torch.int32, device=device)
        return (counts, torch.zeros((batch,), dtype=torch.int64, device=device))

    def cdf(self, state) -> torch.Tensor:
        counts, prev = state
        return _counts_cdf(counts[_lanes(counts), prev], self.prob_bits, self.vocab)

    def update(self, state, syms: torch.Tensor):
        return self.update_((state[0].clone(), state[1]), syms)

    def update_(self, state, syms: torch.Tensor):
        counts, prev = state
        counts[_lanes(counts), prev, syms] += 1  # one entry a lane
        return (counts, syms)


def _uniform_pow2(batch: int, v: int, total: int, device=None) -> torch.Tensor:
    """[B, V] int32 frequencies summing to ``total``, the remainder on the
    first entries."""
    base, rem = divmod(total, v)
    if base < 1:
        raise ValueError(f"prob_bits too small for vocab {v}")
    row = torch.full((v,), base, dtype=torch.int32, device=device)
    row[:rem] += 1
    return row.expand(batch, v).contiguous()


def _decay_update(freq: torch.Tensor, syms: torch.Tensor, rate: int) -> torch.Tensor:
    """Take ``max(f >> rate, min(f - 1, 1))`` from every frequency and give
    their int32 sum to the observed symbol: the total stays."""
    dec = torch.maximum(freq >> rate, torch.clamp(freq - 1, max=1))
    inc = dec.sum(-1, keepdim=True, dtype=torch.int32)
    k = torch.arange(freq.shape[-1], device=freq.device)
    return torch.where(k == syms[:, None], freq - dec + inc, freq - dec)


@dataclass(frozen=True)
class Order0Decay(ScanModel):
    """Division-free adaptive order-0 model. State: freq [B, V] int32."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        return _uniform_pow2(batch, self.vocab, 1 << self.prob_bits, device)

    def cdf(self, state) -> torch.Tensor:
        return cdf_from_freq(state)

    def update(self, state, syms: torch.Tensor):
        return _decay_update(state, syms, self.rate)


@dataclass(frozen=True)
class MarkovDecay(ScanModel):
    """Division-free adaptive order-1 model: one decay row per previous
    symbol. State: (freq [B, V, V] int32, prev [B])."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        row = _uniform_pow2(1, self.vocab, 1 << self.prob_bits, device)
        freq = row.expand(batch, self.vocab, self.vocab).contiguous()
        return (freq, torch.zeros((batch,), dtype=torch.int64, device=device))

    def cdf(self, state) -> torch.Tensor:
        freq, prev = state
        return cdf_from_freq(freq[_lanes(freq), prev])

    def update(self, state, syms: torch.Tensor):
        return self.update_((state[0].clone(), state[1]), syms)

    def update_(self, state, syms: torch.Tensor):
        freq, prev = state
        lane = _lanes(freq)
        freq[lane, prev] = _decay_update(freq[lane, prev], syms, self.rate)
        return (freq, syms)


@dataclass(frozen=True)
class MarkovCDF(ScanModel):
    """Order-1 shift-to-target model: one CDF state row per previous
    symbol, each adapting on its own visit count (a [B, 1] rate column).
    State: (table [B, V, V+1] int32, prev [B], counts [B, V] int32)."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        row = cdf_state_init(1, self.vocab, self.prob_bits, device)
        table = row.expand(batch, self.vocab, self.vocab + 1).contiguous()
        counts = torch.zeros((batch, self.vocab), dtype=torch.int32, device=device)
        return (table, torch.zeros((batch,), dtype=torch.int64, device=device), counts)

    def cdf(self, state) -> torch.Tensor:
        table, prev, _ = state
        return cdf_state_to_coder(table[_lanes(table), prev])

    def update(self, state, syms: torch.Tensor):
        return self.update_((state[0].clone(), state[1], state[2].clone()), syms)

    def update_(self, state, syms: torch.Tensor):
        table, prev, counts = state
        lane = _lanes(table)
        rate = adaptive_rate(self.rate, counts[lane, prev][:, None])
        table[lane, prev] = cdf_state_update(table[lane, prev], syms, rate, self.vocab,
                                             self.prob_bits)
        counts[lane, prev] += 1
        return (table, syms, counts)

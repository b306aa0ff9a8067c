"""The turbo byte models as torch functions over a batch of lanes.

Ports ``lac_tpu/models/functional.py``: ``cdf_state_init`` /
``cdf_state_to_coder`` / ``cdf_state_update`` (:250-275) and ``Order0CDF``
(:292-311) at the turbo path's ``V = 256``, ``prob_bits = 16``,
``adaptive_rate`` (:277-289),
``nib_state_init`` / ``nib_state_to_coder`` / ``nib_state_update``
(:347-374), ``Order0NibCDF`` (:376-423), ``Order1NibCDF`` (:425-481) and
``Order2NibCDF`` (:483-543). This is the models' spec in the port: the
kernels of ``ops/rans_kernels.py`` and their plain versions must give the
intervals that ``cdf`` gives here.

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

from dataclasses import dataclass
from typing import ClassVar

import torch

__all__ = [
    "O0C_V",
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
_O0C_M = (1 << 16) - O0C_V  # order0c state range [0, M]; prob_bits 16
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


def cdf_state_init(batch: int, device=None) -> torch.Tensor:
    """Uniform order0c state: [B, 257] int32 with fixed endpoints 0, M."""
    j = torch.arange(O0C_V + 1, dtype=torch.int32, device=device)
    return ((j * _O0C_M) // O0C_V).expand(batch, O0C_V + 1).contiguous()


def cdf_state_to_coder(state: torch.Tensor) -> torch.Tensor:
    """[B, 257] state -> coder CDF with total 2**16 and every width >= 1:
    one iota add, since the state is pre-scaled."""
    return state + torch.arange(O0C_V + 1, dtype=torch.int32, device=state.device)


def cdf_state_update(state: torch.Tensor, syms: torch.Tensor, rate: int,
                     out=None) -> torch.Tensor:
    """Move the boundaries toward the observed byte's one-hot CDF.
    ``syms``: [B]. ``out`` may be ``state``."""
    k = torch.arange(O0C_V + 1, dtype=torch.int32, device=state.device)
    toward_zero = state - (state >> rate)
    toward_total = state + ((_O0C_M - state) >> rate)
    return torch.where(k <= syms[:, None], toward_zero, toward_total, out=out)


@dataclass(frozen=True)
class Order0CDF:
    """Adaptive order-0 shift-to-target byte model (model id "order0c").
    ``cdf`` returns the 257-entry coder CDF with total 2**16."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        return (cdf_state_init(batch, device), 0)

    def cdf(self, state) -> torch.Tensor:
        return cdf_state_to_coder(state[0])

    def update(self, state, syms: torch.Tensor):
        cdf, step = state
        return (cdf_state_update(cdf, syms, adaptive_rate(self.rate, step)), step + 1)

    def update_(self, state, syms: torch.Tensor):
        """As ``update``, writing the new CDF into the old one."""
        cdf, step = state
        cdf_state_update(cdf, syms, adaptive_rate(self.rate, step), out=cdf)
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
class Order0NibCDF:
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
class _CtxNibCDF:
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

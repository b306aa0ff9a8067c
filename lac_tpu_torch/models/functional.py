"""The order0n byte model as torch functions over a batch of lanes.

Ports ``lac_tpu/models/functional.py``: ``adaptive_rate`` (:277-289),
``nib_state_init`` / ``nib_state_to_coder`` / ``nib_state_update``
(:347-374) and ``Order0NibCDF`` (:376-423). This is the model's spec in the
port: the kernels of ``ops/rans_kernels.py`` and their plain versions must
give the intervals that ``Order0NibCDF.cdf`` gives here.

A byte ``s = 16*h + l`` is modelled as ``P(h) * P(l | h)``: one hi-nibble
CDF and 16 lo-nibble CDFs, one per hi nibble. States are 15-bit and scaled
to the 8-bit coding domain per step, ``eff[k] = ((state[k]*240) >> 15) + k``;
the two nibble intervals compose into one 16-bit rANS step,
``lo12 = (lo_h << 8) + f_h*lo_l`` and ``f12 = f_h*f_l``. The hi table adapts
on the global step schedule, each lo table on its own visit count.

State layout is the reference's: ``sh [B, 17]``, ``sl [B, 16, 17]``,
``cnt [B, 16]`` (all int32) and the step count, here a Python int.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = [
    "NIB_V",
    "NIB_STATE_BITS",
    "adaptive_rate",
    "nib_state_init",
    "nib_state_to_coder",
    "nib_state_update",
    "Order0NibCDF",
]

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


@dataclass(frozen=True)
class Order0NibCDF:
    """Nibble-factorised adaptive byte model (model id "order0n").
    ``cdf`` returns the composed 257-entry CDF with total 2**16."""

    rate: int = 4

    def init_state(self, batch: int, device=None):
        sh = nib_state_init(batch, device)
        sl = nib_state_init(1, device)[0].expand(batch, NIB_V, NIB_V + 1).contiguous()
        cnt = torch.zeros((batch, NIB_V), dtype=torch.int32, device=device)
        return (sh, sl, cnt, 0)

    def cdf(self, state) -> torch.Tensor:
        sh, sl, _cnt, _step = state
        b = sh.shape[0]
        effh = nib_state_to_coder(sh)  # [B, 17]
        effl = nib_state_to_coder(sl)  # [B, 16, 17]
        s = torch.arange(256, device=sh.device)
        hs, ls = s >> 4, s & 15
        loh = effh[:, hs]  # [B, 256]
        fh = effh[:, hs + 1] - loh
        lol = effl[:, hs, ls]
        cdf = (loh << 8) + fh * lol
        total = torch.full((b, 1), 1 << 16, dtype=torch.int32, device=sh.device)
        return torch.cat([cdf, total], dim=-1)

    def update(self, state, syms: torch.Tensor):
        sh, sl, cnt, step = state
        syms = syms.to(torch.int64)
        h, l = syms >> 4, syms & 15
        sh = nib_state_update(sh, h, adaptive_rate(self.rate, step))
        lane = torch.arange(sh.shape[0], device=sh.device)
        row = sl[lane, h]  # [B, 17]
        rl = adaptive_rate(self.rate, cnt[lane, h])[:, None]
        sl = sl.clone()
        sl[lane, h] = nib_state_update(row, l, rl)
        cnt = cnt.clone()
        cnt[lane, h] += 1
        return (sh, sl, cnt, step + 1)

"""Integer CDFs from float logits: the LM path's model-to-coder handoff.

Ports ``lac_tpu/ops/quantize.py:128-217``, the device functions of the
LM path: ``quantize_logits`` (the float path, and ``det=True``, the det8
forward's), ``cdf_from_freq`` and ``gather_intervals``; and, as copies,
``rescale_cdf`` (:40-69), the host coder's integer rescale, and the NumPy
spec holders ``quantize_logits_np`` and ``cdf_from_freq_np`` (:72-114).

``quantize_logits`` has two stages, split here so that each can be held
to the reference on its own:

- the float stage (``quantize_float``): f32 cast, subtract the row max,
  ``exp``, the ``budget / sum`` scale, ``floor``; its bits depend on the
  stack's ``exp`` and summation order, which is why a float container is
  fingerprinted (``runtime.lm_engine.lm_fingerprint``). Under ``det=True``
  (``quantize_det``) the exp is ``detmath.det_exp`` and the denominator
  the integer sum of ``detmath.int_sum_pow2``, so the stage is exact on
  every device: ``p = det_exp(x - max)``, then ``scale = (budget * 2^sb) /
  tot``, then the floor;
- the integer stage (``freq_from_floor``): +1 for every symbol, then the
  residual to the first argmax. Integer, hence exact on every stack.

``lac_tpu``'s blocked cumsum (``_cumsum_blocked``) bounds a TPU compile;
its integers equal a plain cumsum's, so ``cdf_from_freq`` is a plain
``torch.cumsum`` in int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .detmath import ceil_log2, det_exp, det_exp_np, int_sum_pow2

__all__ = ["rescale_cdf", "quantize_logits_np", "cdf_from_freq_np", "quantize_float",
           "quantize_det", "freq_from_floor", "quantize_logits", "cdf_from_freq",
           "gather_intervals"]

f32 = torch.float32


def rescale_cdf(cdf, denom: int):
    """Rescale an integer CDF (cumulative counts, total ``cdf[-1]``) so its
    total becomes exactly ``denom``, with every symbol width >= 1.

    Proportional flooring with a remaining-symbols budget: symbol ``i``'s
    cumulative value is clamped into ``[p+1, denom - (n-1-i))]`` so that no
    later symbol can be starved. Requires ``denom >= len(cdf)``.

    This is the capability of the reference's ``fudged_dist``
    (arith_code.py:83-93) as a standalone pure function; the arithmetic
    coder applies it with ``denom`` = live interval width, and the rANS path
    never needs it because quantized totals are powers of two matching the
    coder precision (the reference's own observation at arith_code.py:41-43
    that power-of-two denominators avoid recalculation).
    """
    n = len(cdf)
    total = cdf[-1]
    if denom < n:
        raise ValueError(f"denom {denom} < alphabet size {n}: not codable")
    if total == denom:
        return cdf
    out = [0] * n
    p = 0
    for i in range(n):
        c = (cdf[i] * denom) // total
        hi = denom - (n - 1 - i)
        c = p + 1 if c <= p else (hi if c > hi else c)
        out[i] = c
        p = c
    return out


def quantize_logits_np(logits: np.ndarray, prob_bits: int, det: bool = False) -> np.ndarray:
    """Quantize float logits ``[..., V]`` to int64 frequencies summing
    exactly to ``2**prob_bits``, every one >= 1: f32 softmax scaled to
    ``total - V``, floored, +1 each, the residual to the first argmax.
    ``det=True`` takes ``det_exp_np`` and the integer denominator, op for op
    as ``quantize_det``. The host spec holder, bit-equal to ``lac_tpu``'s."""
    v = logits.shape[-1]
    total = 1 << prob_bits
    if total < 2 * v:
        raise ValueError(f"prob_bits {prob_bits} too small for vocab {v}")
    x = logits.astype(np.float32)
    x = x - x.max(axis=-1, keepdims=True)
    budget = np.float32(total - v)
    if det:
        p = det_exp_np(x)
        sb = 30 - ceil_log2(v)
        pi = np.round(p * np.float32(2.0**sb)).astype(np.int32)
        tot = pi.sum(axis=-1, keepdims=True, dtype=np.int64)
        scale = (budget * np.float32(2.0**sb)) / tot.astype(np.float32)
    else:
        p = np.exp(x)
        scale = budget / p.sum(axis=-1, keepdims=True, dtype=np.float32)
    freq = np.floor(p * scale).astype(np.int64) + 1
    residual = total - freq.sum(axis=-1, keepdims=True)
    amax = np.argmax(freq, axis=-1)
    np.put_along_axis(
        freq, amax[..., None], np.take_along_axis(freq, amax[..., None], -1) + residual, -1
    )
    return freq


def cdf_from_freq_np(freq: np.ndarray) -> np.ndarray:
    """Exclusive-prefix CDF with a trailing total, ``[..., V+1]``:
    ``cdf[..., 0] = 0``, ``cdf[..., -1] = total``."""
    c = np.cumsum(freq, axis=-1)
    return np.concatenate([np.zeros_like(c[..., :1]), c], axis=-1)


def _check(v: int, prob_bits: int) -> None:
    if (1 << prob_bits) < 2 * v or prob_bits > 30:
        raise ValueError(f"prob_bits {prob_bits} unusable for vocab {v}")


def quantize_float(logits: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """The float stage: logits [..., V] -> int32 floor(p * budget / sum p),
    ``p = exp(x - max x)`` and ``budget = 2**prob_bits - V``."""
    v = logits.shape[-1]
    _check(v, prob_bits)
    x = logits.to(f32)
    x = x - x.amax(-1, keepdim=True)
    budget = torch.tensor(float((1 << prob_bits) - v), dtype=f32)
    p = torch.exp(x)
    # a true division (a Python float over a tensor would take the
    # reciprocal and multiply: two roundings)
    scale = torch.div(budget, p.sum(-1, keepdim=True))
    return torch.floor(p * scale).to(torch.int32)


def quantize_det(logits: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """The det8 float stage (``det=True``, :150-155): int32 floor(p *
    scale), ``p = det_exp(x - max x)``, ``scale = (budget * 2^sb) / tot``
    with ``tot`` the int32 sum of p's ``int_sum_pow2`` quantization."""
    v = logits.shape[-1]
    _check(v, prob_bits)
    x = logits.to(f32)
    x = x - x.amax(-1, keepdim=True)
    p = det_exp(x)
    _, tot, sb = int_sum_pow2(p)
    num = torch.tensor(float((1 << prob_bits) - v) * 2.0**sb, dtype=f32)
    return torch.floor(p * torch.div(num, tot.to(f32))).to(torch.int32)


def freq_from_floor(q: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """The integer stage: floors [..., V] -> int32 frequencies, each >= 1,
    summing to exactly 2**prob_bits (the residual goes to the first
    argmax)."""
    freq = q.to(torch.int32) + 1
    residual = (1 << prob_bits) - freq.sum(-1, keepdim=True, dtype=torch.int32)
    amax = freq.argmax(-1, keepdim=True)
    bump = torch.gather(freq, -1, amax) + residual
    ar = torch.arange(freq.shape[-1], device=freq.device)
    return torch.where(ar == amax, bump, freq)


def quantize_logits(logits: torch.Tensor, prob_bits: int, det: bool = False) -> torch.Tensor:
    """logits [..., V] -> int32 frequencies summing exactly to
    2**prob_bits, each >= 1 (``prob_bits <= 30``); ``det``: the det8
    forward's exact stage."""
    q = quantize_det(logits, prob_bits) if det else quantize_float(logits, prob_bits)
    return freq_from_floor(q, prob_bits)


def cdf_from_freq(freq: torch.Tensor) -> torch.Tensor:
    """int32 exclusive-prefix CDF with a trailing total: [..., V+1],
    ``cdf[..., 0] = 0``, ``cdf[..., -1] = total``."""
    c = torch.cumsum(freq, -1, dtype=torch.int32)
    return torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)


def gather_intervals(cdf: torch.Tensor, syms: torch.Tensor):
    """The coding intervals of known symbols (the encoder's handoff):
    cdf [..., V+1], syms [...] integer -> (cdf_lo, freq)."""
    idx = syms.to(torch.int64)[..., None]
    lo = torch.gather(cdf, -1, idx)[..., 0]
    hi = torch.gather(cdf, -1, idx + 1)[..., 0]
    return lo, hi - lo

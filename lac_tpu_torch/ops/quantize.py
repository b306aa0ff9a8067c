"""Integer CDFs from float logits: the LM path's model-to-coder handoff.

Ports ``lac_tpu/ops/quantize.py:128-217``, the device functions of the
LM path: ``quantize_logits`` (the float path, and ``det=True``, the det8
forward's), ``cdf_from_freq`` and ``gather_intervals``.

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

import torch

from .detmath import det_exp, int_sum_pow2

__all__ = ["quantize_float", "quantize_det", "freq_from_floor", "quantize_logits",
           "cdf_from_freq", "gather_intervals"]

f32 = torch.float32


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

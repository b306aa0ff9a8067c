"""Shape-invariant elementwise math of the det8 forward.

Ports ``lac_tpu/ops/detmath.py``: ``ceil_log2`` and ``int_sum_pow2``
(:37-61), ``det_exp`` (:76-88, in the form of its host mirror
``det_exp_np``, :91-114), ``det_exp_np`` itself (a copy: the NumPy spec
holder), ``det_rsqrt`` (:117-120), ``det_silu`` (:123-129) and
``det_gelu_tanh`` (:132-145).

det8 uses only correctly rounded float ops (+, -, *, /, sqrt, each its own
torch op) and integer ops for everything that carries a value, so its
results do not depend on the shape, the tiling or the device: the same
inputs give the same bits on the CPU and on the card.

Where ``lac_tpu``'s expression adds to a product, XLA's CPU backend
contracts the two into one f32 FMA, which rounds once (measured; the
Horner steps of ``det_exp`` are what ``det_exp_np`` documents). The port
writes each such site as ``fma32``: the f32 operands widened to f64, whose
product is exact there, the add in f64, one rounding back to f32. A true
f32 FMA rounds once where this rounds twice, which can differ only at rare
ties (``det_exp_np`` makes the same trade); every step is a correctly
rounded op, so the result is the same on every device. The sites are
listed in ``models/transformer.py``'s docstring.

``det_rsqrt`` is ``1 / sqrt(x)`` in f32, two correctly rounded ops, as
``lac_tpu`` documents it; XLA's CPU backend rewrites the reference's
expression into its own ``rsqrt``, which is up to 1 ulp off (ROADMAP C).
"""

from __future__ import annotations

import torch

__all__ = ["ceil_log2", "int_sum_pow2", "fma32", "det_exp", "det_exp_np", "det_sqrt", "det_rsqrt",
           "det_silu", "det_gelu_tanh"]

f32 = torch.float32

_LOG2E = 1.4426950408889634
# Taylor coefficients of 2^f = sum (ln 2)^k / k! * f^k, k = 1..7 (the
# reference's _EXP2_C); each enters as its f32 value
_EXP2_C = [
    0.6931471805599453,
    0.2402265069591007,
    0.05550410866482158,
    0.009618129107628477,
    0.0013333558146428443,
    0.00015403530393381608,
    1.5252733804059837e-05,
]


def _f32(x: float) -> float:
    return torch.tensor(x, dtype=f32).item()


def ceil_log2(n: int) -> int:
    """Static ceil(log2(n)) for overflow sizing (0 for n <= 1)."""
    return max(0, int(n - 1).bit_length())


def int_sum_pow2(p: torch.Tensor, cap: int | None = None):
    """Values ``p`` in [0, 1] along the last axis as ``pi = round(p * 2^sb)``
    int32, ``sb`` sized so that ``sum(pi)`` cannot overflow int32 over
    ``cap`` (default: the axis length) terms. Returns (pi, the keepdim
    int32 sum, sb). ``cap`` pins sb across axis lengths, so a chunk's
    score rows and a serial step's quantize alike (``_det_softmax``)."""
    n = cap if cap is not None else p.shape[-1]
    if n < p.shape[-1]:
        raise ValueError(f"int_sum_pow2 cap {cap} < axis length {p.shape[-1]}")
    sb = 30 - ceil_log2(n)
    pi = torch.round(p * float(2.0**sb)).to(torch.int32)
    return pi, pi.sum(-1, keepdim=True, dtype=torch.int32), sb


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` for f32 values with one rounding of the f32 product,
    as an FMA gives (module docstring). ``a`` has the result's shape; ``b``
    and ``c`` may be tensors (f32, or f64 holding f32 values) or Python
    floats holding f32 values."""
    return a.to(torch.float64, copy=True).mul_(b).add_(c).float()


def det_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x <= 0 as 2^n * P(f): the exact power of two from the
    floor's bits, a degree-7 Taylor polynomial in Horner form for 2^f."""
    y = x.float() * _f32(_LOG2E)
    n = torch.floor(y)
    f = (y - n).double()  # in [0, 1), an f32 value
    p = fma32(f, _f32(_EXP2_C[-1]), _f32(_EXP2_C[-2]))
    for c in _EXP2_C[-3::-1]:
        p = fma32(p, f, _f32(c))
    p = fma32(p, f, 1.0)
    ni = n.clamp(-126.0, 0.0).to(torch.int32)
    two_n = ((ni + 127) << 23).view(f32)
    # below 2^-126 the true value underflows anyway; pinned to exactly 0
    return torch.where(n < -126.0, 0.0, p * two_n)


def det_exp_np(x):
    """Host (NumPy) spec mirror of ``det_exp``, a copy of ``lac_tpu``'s: each
    Horner step ``p * f + c`` is an exact f64 product and one rounding to
    f32, the FMA that XLA's CPU backend forms. ``x``: a NumPy array; returns
    f32."""
    import numpy as np

    def fma32_np(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)

    y = (x.astype(np.float32) * np.float32(_LOG2E)).astype(np.float32)
    n = np.floor(y)
    f = (y - n).astype(np.float32)
    p = np.full_like(f, np.float32(_EXP2_C[-1]))
    for c in _EXP2_C[-2::-1]:
        p = fma32_np(p, f, np.float64(np.float32(c)))
    p = fma32_np(p, f, np.float64(1.0))
    ni = np.clip(n, -126.0, 0.0).astype(np.int32)
    two_n = ((ni + 127) << 23).view(np.float32)
    return np.where(n < -126.0, np.float32(0.0), (p * two_n).astype(np.float32))


def det_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 sqrt: an f64 sqrt rounded to f32. torch's
    f32 sqrt on the CPU is not correctly rounded (it takes MKL's vector
    sqrt: 6,490 of 10^6 values off by an ulp); an f64 sqrt within an f64
    ulp of the true root, rounded to f32, is, since the root of an f32
    value lies at least 2^-50 relative from every midpoint of two f32
    values."""
    return torch.sqrt(x.double()).float()


def det_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) in f32: a correctly rounded sqrt (``det_sqrt``), then a
    correctly rounded reciprocal, 1 / y (never ``torch.rsqrt``, an
    approximation)."""
    return torch.reciprocal(det_sqrt(x.float()))


def det_silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) over det_exp: t = exp(-|x|), sigmoid = 1 / (1 + t)
    for x >= 0, else t / (1 + t)."""
    xf = x.float()
    t = det_exp(-xf.abs())
    den = t + 1.0
    sig = torch.where(xf >= 0, torch.reciprocal(den), t / den)
    return xf * sig


def det_gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU with tanh(z) = sign(z) (1 - e) / (1 + e),
    e = exp(-2 |z|); ``z = x c1 + x^3 c2`` with the first product fused
    into the add, as XLA computes it."""
    xf = x.float()
    x3 = (xf * xf) * xf
    z = fma32(xf, _f32(0.7978845608028654), x3 * _f32(0.035677408136300125))
    e = det_exp(z.abs() * -2.0)
    th = (torch.sign(z) * (1.0 - e)) / (e + 1.0)
    return xf * ((th + 1.0) * 0.5)

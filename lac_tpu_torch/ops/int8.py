"""Exact int8 products: the int32 contractions of the w8 and kv8 forwards.

``lac_tpu`` computes every int8 product of its w8 and kv8 modes as an XLA
``einsum`` with ``preferred_element_type=int32`` (``lac_tpu/models/
transformer.py``: ``_w8_dot`` :530-550, the kv8 scores :877-899 and PV
:924-940); no Pallas kernel lies on this path. An int8 product summed in
int32 is exact, so any method that gives those integers gives the
reference's, on the CPU and on the card alike. These two helpers are the
only way the port forms them, and nothing falls back from them:

- ``int8_mm`` (the projections, 2-D): ``torch._int_mm``, int32
  accumulation on the card's int8 tensor cores. On CUDA it requires more
  than 16 rows and K and N multiples of 8, so the helper pads M (to 32
  when it has 16 rows or fewer), K and N with zeros, and slices the
  result back: zero rows and columns add nothing, so the integers stay
  exact. It hands ``_int_mm`` a column-major ``b`` (both operands
  contiguous along K, the int8 tensor cores' layout): cuBLASLt refused a
  row-major ``b`` at 17 and 24 rows with K 64 (``NOT_SUPPORTED``; H100,
  torch 2.11, CUDA 12.8) and took the column-major one at every shape
  tried. The same padding and layout run on the CPU. An error of
  ``_int_mm`` raises.
- ``int8_bmm`` (the kv8 attention, batched over lanes and KV heads):
  torch has no batched int8 product on CUDA, so the operands go through
  f32. An f32 product of int8 values is exact while the contraction has
  at most 1040 terms (1040 * 127^2 < 2^24: every partial sum is an
  integer f32 holds), whatever order the library sums in. The helper
  contracts chunks of at most ``CHUNK`` = 1024 terms, converts each
  chunk's f32 result to int32 (exact) and sums the chunks in int32. It
  raises when TF32 (or another reduced-precision f32 product) is on,
  which would round the operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "int8_mm", "int8_bmm"]

CHUNK = 1024  # terms a chunk of int8_bmm; exact up to 1040
_MIN_ROWS = 32  # int8_mm pads M <= 16 to this (_int_mm needs M > 16)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times b [K, N] int8 -> [M, N] int32, the exact integer
    product, through ``torch._int_mm`` (module docstring). A ``b`` that is
    not column-major, or not 8-aligned, is copied into a column-major,
    aligned one each call; the w8 weights are stored so."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_mm takes 2-D int8 operands, got {a.dtype} {tuple(a.shape)} "
                         f"and {b.dtype} {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"int8_mm: inner sizes {k} and {b.shape[0]} differ")
    mp, kp, np_ = (m if m > 16 else _MIN_ROWS), _up8(k), _up8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n) or b.stride(0) != 1:
        bp = torch.zeros((np_, kp), dtype=torch.int8, device=b.device).t()
        bp[:k, :n] = b
        b = bp
    out = torch._int_mm(a, b)
    return out if (mp, np_) == (m, n) else out[:m, :n]


def _check_exact_f32(device: torch.device) -> None:
    """Raise unless f32 products on ``device`` run in full f32."""
    if device.type == "cuda":
        reduced = torch.backends.cuda.matmul.allow_tf32
    else:
        mkldnn = getattr(torch.backends.mkldnn, "matmul", None)
        reduced = getattr(mkldnn, "fp32_precision", "none") not in ("none", "ieee")
    if reduced:
        raise RuntimeError(
            "int8_bmm needs full-precision f32 products (TF32 is on); run it under "
            "lm_engine._coding, which turns TF32 off")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32, memory_format=torch.contiguous_format)


def int8_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] int8 times b [..., K, N] int8 (batch dims equal) ->
    [..., M, N] int32, the exact integer product: f32 products of chunks
    of at most CHUNK terms, each converted to int32, summed in int32."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8_bmm takes int8 operands, got {a.dtype} and {b.dtype}")
    _check_exact_f32(a.device)
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, CHUNK):
        part = torch.matmul(_f32(a[..., k0 : k0 + CHUNK]),
                            _f32(b[..., k0 : k0 + CHUNK, :])).to(torch.int32)
        out = part if out is None else out.add_(part)
    return out

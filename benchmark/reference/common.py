"""What the plain references of every family share: f32 weights, the
causal attention, the integer CDF of a distribution and the lower-precision
weights and K/V of the controls.

Plain PyTorch in float32 with TF32 off; it imports nothing of the program
under test. ``quantize_freq`` is a frozen copy of the coder's published
rule (f32 softmax scaled to ``2**prob_bits - V``, floored, +1 a symbol,
the residual to the first argmax): the reference works out its own CDF
from its own logits.
"""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def plain_precision() -> None:
    """Float32 products in float32: no TF32, no reduced-precision sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def fake_quant(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """``x`` through a symmetric integer grid of ``bits`` bits with one
    scale per slice along ``dim`` (the max magnitude), back in f32: the
    control's lower precision."""
    qmax = float((1 << (bits - 1)) - 1)
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30)
    return torch.round(x / s * qmax) * (s / qmax)


def f32_weights(weights: dict, matrices: tuple, weight_bits: int | None = None) -> dict:
    """The weights as f32 tensors; with ``weight_bits``, each 2-D weight
    whose last name is in ``matrices`` through ``fake_quant`` over its
    input dim (rows)."""
    out = {}
    for name, t in weights.items():
        w = t.to(f32)
        if weight_bits and name.rsplit(".", 1)[-1] in matrices and w.ndim == 2:
            w = fake_quant(w, weight_bits, 0)
        out[name] = w
    return out


def causal_attention(q, k, v, kv_bits: int | None = None) -> torch.Tensor:
    """q, k, v [B, S, H, Dh] f32 (K/V heads already repeated to H) ->
    [B, S, H*Dh]. With ``kv_bits``, K and V rows go through ``fake_quant``
    over Dh first, as a cache in that precision would hold them."""
    if kv_bits:
        k, v = fake_quant(k, kv_bits, -1), fake_quant(v, kv_bits, -1)
    b, s, h, hd = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.matmul(torch.softmax(scores, dim=-1), vh)
    return out.permute(0, 2, 1, 3).reshape(b, s, h * hd)


def quantize_freq(logits: torch.Tensor, sym: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """The coded frequency of ``sym`` [...] under the integer CDF of
    ``logits`` [..., V]: ``floor(p * (2**pb - V)) + 1``, plus the residual
    where ``sym`` is the first argmax. int64 [...]."""
    v = logits.shape[-1]
    total = 1 << prob_bits
    x = logits.to(f32)
    x = x - x.amax(-1, keepdim=True)
    p = torch.exp(x)
    scale = torch.div(torch.tensor(float(total - v), dtype=f32, device=x.device),
                      p.sum(-1, keepdim=True))
    freq = torch.floor(p * scale).to(torch.int64) + 1
    residual = total - freq.sum(-1)
    amax = freq.argmax(-1)
    got = torch.gather(freq, -1, sym[..., None].to(torch.int64))[..., 0]
    return torch.where(sym.to(torch.int64) == amax, got + residual, got)


def coded_freqs(family, weights: dict, model: dict, blocks: torch.Tensor,
                prob_bits: int, rows: int, quant: dict | None = None) -> torch.Tensor:
    """The frequency each position of ``blocks`` [N, T] (each row a block
    coded from a fresh context) is coded with under the reference: the
    forward of ``[BOS, s_0 .. s_{T-2}]`` (BOS is id ``vocab``), ``rows``
    blocks at a time. int64 [N, T]."""
    w = family.prepare(weights, model, quant)
    bos = torch.full((blocks.shape[0], 1), model["vocab"], dtype=torch.int64,
                     device=blocks.device)
    inputs = torch.cat([bos, blocks[:, :-1].to(torch.int64)], dim=1)
    out = []
    with torch.inference_mode():
        for i in range(0, blocks.shape[0], rows):
            logits = family.logits(w, model, inputs[i : i + rows], quant)
            out.append(quantize_freq(logits, blocks[i : i + rows], prob_bits))
    return torch.cat(out)

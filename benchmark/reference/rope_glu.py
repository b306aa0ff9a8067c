"""Plain reference of the rotary, RMSNorm, SiLU-gated family (the repo's
byte LMs): pre-norm decoder layers, rotary positions on the half-split
head dims, SiLU(x W_gate) * (x W_up) W_down, an untied head.

Float32 throughout from the stored weights. The K/V heads are repeated
to the query heads (GQA). Token id ``vocab`` is BOS, the embedding's
extra row, at position 0.
"""

from __future__ import annotations

import torch

from .common import causal_attention, f32_weights

MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "head")
RESIDUAL_OUT = ("wo", "w_down")  # the outputs into the residual stream


def param_shapes(m: dict) -> dict:
    """name -> shape of every stored weight."""
    d, hd = m["d_model"], m["d_model"] // m["n_heads"]
    h, kvh, ff = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    shapes = {"embed": (m["vocab"] + 1, d), "final_norm.scale": (d,), "head": (d, m["vocab"])}
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        shapes.update({p + "ln1.scale": (d,), p + "ln2.scale": (d,),
                       p + "wq": (d, h * hd), p + "wk": (d, kvh * hd), p + "wv": (d, kvh * hd),
                       p + "wo": (h * hd, d), p + "w_up": (d, ff), p + "w_down": (ff, d),
                       p + "w_gate": (d, ff)})
    return shapes


def prepare(weights: dict, m: dict, quant: dict | None = None) -> dict:
    return f32_weights(weights, MATRICES, (quant or {}).get("weight_bits"))


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x [B, S, H, Dh], positions 0..S-1, half-split pairs."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) * 2.0 / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(w: dict, m: dict, tokens: torch.Tensor, quant: dict | None = None) -> torch.Tensor:
    """tokens [B, S] -> f32 logits [B, S, vocab]."""
    b, s = tokens.shape
    h, kvh = m["n_heads"], m["n_kv_heads"]
    hd, eps = m["d_model"] // h, m["norm_eps"]
    kv_bits = (quant or {}).get("kv_bits")
    x = w["embed"][tokens]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        y = _rms(x, w[p + "ln1.scale"], eps)
        q = (y @ w[p + "wq"]).reshape(b, s, h, hd)
        k = (y @ w[p + "wk"]).reshape(b, s, kvh, hd)
        v = (y @ w[p + "wv"]).reshape(b, s, kvh, hd)
        q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
        k, v = k.repeat_interleave(h // kvh, dim=2), v.repeat_interleave(h // kvh, dim=2)
        x = x + causal_attention(q, k, v, kv_bits) @ w[p + "wo"]
        y = _rms(x, w[p + "ln2.scale"], eps)
        gate = torch.nn.functional.silu(y @ w[p + "w_gate"])
        x = x + (gate * (y @ w[p + "w_up"])) @ w[p + "w_down"]
    return _rms(x, w["final_norm.scale"], eps) @ w["head"]

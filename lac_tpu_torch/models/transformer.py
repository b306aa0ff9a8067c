"""Decoder-only transformer LM: the float prefill forward, as ``nn.Module``s.

Ports the float path of ``lac_tpu/models/transformer.py``: ``LMConfig``
(:67-153), ``tiny_config`` (:155-163), the presets ``GPT2_SMALL``,
``TINYLLAMA_1B``, ``LLAMA2_7B`` and ``LLAMA3_8B`` (:166-183),
``init_params`` (:191-237), ``init_cache`` (:336-375, float branch),
``_norm`` (:376-388), ``_rope`` (:401-430), ``_act`` (:460), ``_mlp``
(float branch :979-993), ``_attention`` (:771-949, float branches) with
``_FUSED`` (:703), ``_splash_prefill`` (:706-722), ``_bf16s_prefill``
(:725-743) and ``_flash_prefill`` (:746-768), and ``forward``
(:994-1116, float branch): the prefill (``prefill=True``) and the cached
decode step (``prefill=False``). Both GPT-2-style (learned positions,
LayerNorm, GELU, biases, tied head) and Llama-style (RoPE, RMSNorm,
SiLU-GLU, GQA, no biases) models, as in the reference.

Numerics follow the reference's explicit types: activations in
``cfg.dtype``; a projection is a ``cfg.dtype`` product with f32
accumulation, rounded once to ``cfg.dtype`` (what ``preferred_element_type
=f32`` then ``astype`` gives); where the reference keeps the f32 result
(the exact branch's scores, the SiLU gate, the logits) the product runs on
f32 upcasts, with TF32 off. Norm statistics, RoPE and softmax are f32.
Masked scores are ``-inf``, so they contribute exactly 0.

Parameters keep the reference's layout (``x @ w``, ``w`` is ``[in, out]``)
and names; ``convert.py`` carries them between the packages. A model may
hold its parameters in any float type (training keeps an f32 master copy):
the forward casts each one to ``cfg.dtype`` where it is used, so the
gradients reach the parameters as they are stored.

The cached decode step keeps the reference's structure, which the LM
coding path's bits depend on: queries score the cache (f32, times the
scale, ``-inf`` at slots ``w >= pos``) and the call's fresh K/V (causal
within the call) under ONE softmax over the concatenated axis; the cache
and fresh probabilities are cast to ``cfg.dtype`` apart, run through two
products summed in f32, then cast. The cache is ``[L, B, W, KVH, Dh]`` in
``cfg.dtype`` with a shared host-side ``pos``; each layer writes its fresh
K/V at ``pos`` in place after its own reads (the reference writes all
layers at once after the layer scan; a layer reads only its own slice and
masks ``w >= pos``, so the two give the same values). The det8, w8, kv8
and slide modes raise ``NotImplementedError`` naming the ROADMAP item that
ports them.

Training-only fused attention: ``forward(..., fused=True)`` routes the
attention of an MHA model (``n_heads == n_kv_heads``) through
``_FUSED["impl"]``: ``"bf16s"`` (the default, torch ops), ``"flash"``
(K10-K12, ``ops/attention.py``, scale ``1/sqrt(hd)``) or ``"splash"``
(q times ``1/sqrt(hd)`` in ``cfg.dtype`` first, then K10-K12 at scale 1).
GQA takes the exact branch, as in ``lac_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_attention

__all__ = [
    "LMConfig",
    "Norm",
    "Block",
    "Transformer",
    "init_params",
    "init_cache",
    "forward",
    "tiny_config",
    "GPT2_SMALL",
    "TINYLLAMA_1B",
    "LLAMA2_7B",
    "LLAMA3_8B",
]

f32 = torch.float32

# Training-only fused-attention implementation selector (lac_tpu's _FUSED,
# transformer.py:703; training scripts may override). flash_bs / splash_bs
# are the reference's block-size overrides; the port's kernels have fixed
# 64-row tiles and do not read them.
_FUSED = {"impl": "bf16s", "flash_bs": None, "splash_bs": None}


@dataclass(frozen=True)
class LMConfig:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq: int
    pos_embedding: str = "rope"      # "rope" | "learned"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    act: str = "silu_glu"            # "silu_glu" | "gelu"
    use_bias: bool = False
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # forward modes of lac_tpu that the port does not have yet (ROADMAP
    # A6-A8); kept so configs and checkpoints carry the same fields
    det8: bool = False
    w8: bool = False
    kv8: bool = False
    slide: bool = False
    rope_positions: int = 0

    def __post_init__(self):
        if self.det8 and (self.w8 or self.kv8):
            raise ValueError(
                "det8 is mutually exclusive with w8/kv8 (it quantizes on its own)"
            )
        if self.slide and self.pos_embedding != "rope":
            raise ValueError("slide mode requires rope positions")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def bos_id(self) -> int:
        return self.vocab  # extra embedding row


def tiny_config(vocab: int = 256, **kw) -> LMConfig:
    """Small random-init model for tests and CI."""
    defaults = dict(
        vocab=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, dtype=torch.float32,
    )
    defaults.update(kw)
    return LMConfig(**defaults)


# Architecture presets (dimensions per the public model cards).
GPT2_SMALL = LMConfig(
    vocab=50257, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
    d_ff=3072, max_seq=1024, pos_embedding="learned", norm="layernorm",
    act="gelu", use_bias=True, tie_embeddings=True, dtype=torch.bfloat16,
)
TINYLLAMA_1B = LMConfig(
    vocab=32000, d_model=2048, n_layers=22, n_heads=32, n_kv_heads=4,
    d_ff=5632, max_seq=2048, dtype=torch.bfloat16,
)
LLAMA2_7B = LMConfig(
    vocab=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
    d_ff=11008, max_seq=4096, dtype=torch.bfloat16,
)
LLAMA3_8B = LMConfig(
    vocab=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, max_seq=8192, dtype=torch.bfloat16, rope_theta=500000.0,
)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to lac_tpu_torch yet (ROADMAP {item})")


def _check_float_path(cfg: LMConfig) -> None:
    for flag, item in (("det8", "A8"), ("w8", "A7"), ("kv8", "A7"), ("slide", "A6")):
        if getattr(cfg, flag):
            raise _not_ported(f"the {flag} forward", item)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _param(shape, dtype, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm) of one norm."""

    def __init__(self, cfg: LMConfig, dtype=None, device=None):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.scale = _param((cfg.d_model,), dtype, device)
        self.bias = _param((cfg.d_model,), dtype, device) if cfg.norm == "layernorm" else None


# (name, shape) of a layer's weights, in the reference's order
def _layer_shapes(cfg: LMConfig):
    d, h, kvh, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    shapes = [("wq", (d, h * hd)), ("wk", (d, kvh * hd)), ("wv", (d, kvh * hd)),
              ("wo", (h * hd, d)), ("w_up", (d, ff)), ("w_down", (ff, d))]
    if cfg.act == "silu_glu":
        shapes.append(("w_gate", (d, ff)))
    return shapes


def _bias_shapes(cfg: LMConfig):
    d, h, kvh, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    if not cfg.use_bias:
        return []
    return [("bq", (h * hd,)), ("bk", (kvh * hd,)), ("bv", (kvh * hd,)), ("bo", (d,)),
            ("b_up", (ff,)), ("b_down", (d,))]


class Block(nn.Module):
    """One layer: ``ln1``, ``ln2`` and the projections of ``_layer_shapes``
    and ``_bias_shapes``."""

    def __init__(self, cfg: LMConfig, dtype=None, device=None):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.ln1 = Norm(cfg, dtype, device)
        self.ln2 = Norm(cfg, dtype, device)
        for name, shape in _layer_shapes(cfg) + _bias_shapes(cfg):
            setattr(self, name, _param(shape, dtype, device))


class Transformer(nn.Module):
    """The parameters of one model: ``embed`` [vocab + 1, d] (the last row is
    BOS), ``pos_embed`` [max_seq, d] for learned positions, ``head``
    [d, vocab] unless tied, ``final_norm`` and ``layers``."""

    def __init__(self, cfg: LMConfig, dtype=None, device=None):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _param((cfg.vocab + 1, d), dtype, device)
        self.final_norm = Norm(cfg, dtype, device)
        self.pos_embed = (_param((cfg.max_seq, d), dtype, device)
                          if cfg.pos_embedding == "learned" else None)
        self.head = None if cfg.tie_embeddings else _param((d, cfg.vocab), dtype, device)
        self.layers = nn.ModuleList(Block(cfg, dtype, device) for _ in range(cfg.n_layers))


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Transformer:
    """Random init (scaled normal), the reference's distributions and order
    of draws, from a CPU ``torch.Generator`` seeded with ``seed`` (the same
    weights on every device), then moved to ``device`` (the CPU when None).
    The bits differ from ``jax.random``'s."""
    g = torch.Generator().manual_seed(seed)

    def dense(fan_in, shape):
        return (torch.randn(shape, generator=g, dtype=f32)
                / torch.sqrt(torch.tensor(float(fan_in), dtype=f32))).to(cfg.dtype)

    model = Transformer(cfg)
    with torch.no_grad():
        model.embed.copy_(dense(1, model.embed.shape) * 0.02)
        if model.pos_embed is not None:
            model.pos_embed.copy_(dense(1, model.pos_embed.shape) * 0.01)
        if model.head is not None:
            model.head.copy_(dense(cfg.d_model, model.head.shape))
        for norm in [model.final_norm] + [n for lyr in model.layers for n in (lyr.ln1, lyr.ln2)]:
            norm.scale.fill_(1)
        for lyr in model.layers:
            for name, shape in _layer_shapes(cfg):
                getattr(lyr, name).copy_(dense(shape[0], shape))
    return model.to(device) if device is not None else model


def init_cache(cfg: LMConfig, batch: int, window: int | None = None, device=None) -> dict:
    """KV cache over the context window: ``k`` and ``v`` ``[L, B, W, KVH,
    Dh]`` in ``cfg.dtype`` (zeros), and ``pos``, the shared write cursor
    (all lanes run lock-step), a host int. ``window`` (default
    ``cfg.max_seq``, capped there) sizes the cache: every step reads all of
    it, so the coding engine sizes it to the block or grows it."""
    _check_float_path(cfg)
    w = cfg.max_seq if window is None else min(window, cfg.max_seq)
    shape = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _c(cfg: LMConfig, p: torch.Tensor) -> torch.Tensor:
    """A parameter in ``cfg.dtype`` (itself when it is stored so)."""
    return p if p.dtype == cfg.dtype else p.to(cfg.dtype)


def _act(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Round an activation to the model dtype (the float path's cast)."""
    return x if x.dtype == cfg.dtype else x.to(cfg.dtype)


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float: a scalar operand that an f32
    tensor op uses exactly, with no copy to the device."""
    return float(np.float32(x))


def _norm(cfg: LMConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    # a cfg.dtype operand of an f32 op is widened exactly inside the op
    # (type promotion), as an explicit f32 cast would widen it
    xf = x.float()
    eps = _f32(cfg.norm_eps)
    scale = _c(cfg, p.scale)
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return _act(cfg, xf * scale)
    xc = xf - xf.mean(-1, keepdim=True)
    xf = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return _act(cfg, xf * scale + _c(cfg, p.bias))


def _rope_tables(cfg: LMConfig, positions: torch.Tensor):
    """(cos, sin) [1, S, 1, Dh/2] f32 of the rotary angles at ``positions``
    [S]; the same for every layer, so a step computes them once."""
    half = cfg.head_dim // 2
    coef = -np.log(np.float32(cfg.rope_theta)) * np.float32(2.0) / np.float32(cfg.head_dim)
    freqs = torch.exp(torch.arange(0, half, dtype=f32, device=positions.device) * float(coef))
    ang = positions.to(f32)[:, None] * freqs[None, :]  # [S, half]
    return torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split. x: [B, S, H, Dh]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]  # widened to f32 by the products
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split. x: [B, S, H, Dh]; positions: [S]."""
    return _rope_apply(x, *_rope_tables(cfg, positions))


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``cfg.dtype`` operands, f32 accumulation, one rounding to their type."""
    return torch.matmul(x, w)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same product kept in f32 (f32 upcasts: exact products of the
    operands, f32 sums)."""
    return torch.matmul(x.float(), w.float())


def _scale_f32(hd: int) -> float:
    """``f32(1) / sqrt(f32(hd))`` as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (the reference's
    ``scale.astype(cfg.dtype)``)."""
    return torch.tensor(x, dtype=dtype).item()


def _bf16s_prefill(cfg: LMConfig, q, k, v, scale):
    """Exact-structure causal prefill with model-dtype scores, normalised
    after the PV product (``_bf16s_prefill``). q, k, v: [B, H, S, Dh]."""
    s = q.shape[2]
    sf = _dot(q, k.transpose(-1, -2))  # f32 sums rounded to cfg.dtype
    sf = sf * _in_dtype(scale, cfg.dtype)
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sf = sf.masked_fill(~keep, float("-inf"))
    m = sf.amax(-1, keepdim=True)
    e = torch.exp((sf - m).float()).to(cfg.dtype)
    ssum = e.float().sum(-1, keepdim=True)
    out = _dot_f32(e, v)
    return (out / ssum).to(cfg.dtype)


def _fused_prefill(cfg: LMConfig, q, k, v, scale):
    """The training-only fused branch for MHA. q, k, v: [B, S, H, Dh];
    returns [B, S, H, Dh] in cfg.dtype."""
    hd = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, Dh] views
    impl = _FUSED["impl"]
    if impl == "bf16s":
        out = _bf16s_prefill(cfg, qh, kh, vh, scale)
    elif impl == "splash":
        qh = qh * _in_dtype(1.0 / float(hd) ** 0.5, cfg.dtype)
        out = causal_attention(qh, kh, vh, 1.0)
    elif impl == "flash":
        out = causal_attention(qh, kh, vh, 1.0 / float(hd) ** 0.5)
    else:
        raise ValueError(f"unknown fused attention impl {impl!r}")
    return out.transpose(1, 2).to(cfg.dtype)


def _qkv(cfg: LMConfig, p: Block, x: torch.Tensor):
    """The layer's projections of x [B, S, D]: q [B, S, H, Dh], k and v
    [B, S, KVH, Dh], in cfg.dtype."""
    b, s, _ = x.shape

    def proj(w, bias_name, heads):
        y = _dot(x, _c(cfg, getattr(p, w)))
        if cfg.use_bias:
            y = y + _c(cfg, getattr(p, bias_name))
        return y.reshape(b, s, heads, cfg.head_dim)

    return proj("wq", "bq", cfg.n_heads), proj("wk", "bk", cfg.n_kv_heads), \
        proj("wv", "bv", cfg.n_kv_heads)


def _out_proj(cfg: LMConfig, p: Block, out: torch.Tensor) -> torch.Tensor:
    """The attention output [B, S, H*Dh] through ``wo``."""
    y = _dot(out, _c(cfg, p.wo))
    if cfg.use_bias:
        y = y + _c(cfg, p.bo)
    return y


def _attention(cfg: LMConfig, p: Block, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """One layer's causal self-attention over the block (prefill)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_embedding == "rope":
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    scale = _scale_f32(hd)

    if fused and h == kvh:
        out = _fused_prefill(cfg, q, k, v, scale)
    else:
        # exact branch; GQA folds the query heads into groups [B, KVH, R, S, Dh]
        rep = h // kvh
        qg = q.reshape(b, s, kvh, rep, hd).permute(0, 2, 3, 1, 4)
        kg = k.permute(0, 2, 1, 3)[:, :, None]  # [B, KVH, 1, S, Dh]
        vg = v.permute(0, 2, 1, 3)[:, :, None]
        sf = _dot_f32(qg, kg.transpose(-1, -2)) * scale
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        sf = sf.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(sf, dim=-1)
        out = _dot(probs.to(cfg.dtype), vg)  # [B, KVH, R, S, Dh]
        out = out.permute(0, 3, 1, 2, 4)
    return _out_proj(cfg, p, out.reshape(b, s, h * hd))


def _attention_cached(cfg: LMConfig, p: Block, x: torch.Tensor, cache: dict, layer: int,
                      rope, keep) -> torch.Tensor:
    """One layer's attention for S tokens at ``cache["pos"]`` against the
    layer's cache slice and the call's fresh K/V (the reference's
    ``prefill=False`` float branch), then the fresh K/V written into the
    slice at ``pos``. ``rope``: the call's (cos, sin), or None. ``keep``:
    the causal mask of the fresh scores [R*S, S], or None at S 1, where it
    keeps everything."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache["pos"]
    ck, cv = cache["k"][layer], cache["v"][layer]  # [B, W, KVH, Dh]
    w_len = ck.shape[1]
    q, k, v = _qkv(cfg, p, x)
    if rope is not None:  # q and k rotated as one tensor: the same values
        q, k = _rope_apply(torch.cat([q, k], dim=2), *rope).split([h, kvh], dim=2)
    scale = _scale_f32(hd)
    # GQA: the query heads of a KV head fold into the rows, [B, KVH, R*S, Dh]
    # in (r, s) order; every product below is one batched matmul over
    # (B, KVH) on f32 upcasts, with each operand made contiguous first
    rep = h // kvh

    def heads_f32(t):  # [B, N, KVH, ...] -> contiguous f32 [B, KVH, N, ...]
        return t.transpose(1, 2).to(f32, memory_format=torch.contiguous_format)

    qf = heads_f32(q.reshape(b, s, kvh, rep, hd)).transpose(2, 3).reshape(b, kvh, rep * s, hd)
    ckf, cvf = heads_f32(ck), heads_f32(cv)
    kf, vf = heads_f32(k), heads_f32(v)
    # the cache's scores [.., W] and the fresh ones [.., S], then the scale
    scores = torch.cat([torch.matmul(qf, ckf.transpose(-1, -2)),
                        torch.matmul(qf, kf.transpose(-1, -2))], dim=-1) * scale
    scores[..., pos:w_len] = float("-inf")  # slots w >= pos hold no token yet
    if keep is not None:
        scores[..., w_len:].masked_fill_(~keep, float("-inf"))
    # one softmax over both; the probabilities rounded to cfg.dtype, then
    # the cache's and the fresh products summed in f32
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype).float()
    out = torch.matmul(probs[..., :w_len], cvf) + torch.matmul(probs[..., w_len:], vf)
    out = out.to(cfg.dtype).reshape(b, kvh, rep, s, hd).permute(0, 3, 1, 2, 4)
    y = _out_proj(cfg, p, out.reshape(b, s, h * hd))
    # after this layer's reads: the fresh K/V into its slice at pos
    cache["k"][layer, :, pos:pos + s] = k
    cache["v"][layer, :, pos:pos + s] = v
    return y


def _mlp(cfg: LMConfig, p: Block, x: torch.Tensor) -> torch.Tensor:
    up = _dot(x, _c(cfg, p.w_up))
    if cfg.use_bias:
        up = up + _c(cfg, p.b_up)
    if cfg.act == "silu_glu":
        gate = _dot_f32(x, _c(cfg, p.w_gate))
        up = (F.silu(gate) * up).to(cfg.dtype)  # up widened to f32 in the product
    else:
        up = F.gelu(up.float(), approximate="tanh").to(cfg.dtype)
    y = _dot(up, _c(cfg, p.w_down))
    if cfg.use_bias:
        y = y + _c(cfg, p.b_down)
    return y


def _layer(cfg: LMConfig, p: Block, x: torch.Tensor, fused: bool) -> torch.Tensor:
    x = _act(cfg, x + _attention(cfg, p, _norm(cfg, p.ln1, x), fused=fused))
    return _act(cfg, x + _mlp(cfg, p, _norm(cfg, p.ln2, x)))


def _head(cfg: LMConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the output head: f32 logits [B, S, vocab]."""
    x = _norm(cfg, params.final_norm, x)
    embed = _c(cfg, params.embed)
    wh = embed[: cfg.vocab].T if cfg.tie_embeddings else _c(cfg, params.head)
    return _dot_f32(x, wh)


def _forward_cached(cfg: LMConfig, params: Transformer, tokens: torch.Tensor, cache: dict):
    b, s = tokens.shape
    pos = cache["pos"]
    if pos + s > cache["k"].shape[2]:
        raise ValueError(f"{s} tokens at pos {pos} overrun the cache width "
                         f"{cache['k'].shape[2]}")
    tokens = tokens.long()
    positions = torch.arange(pos, pos + s, dtype=torch.int32, device=tokens.device)
    x = _act(cfg, _c(cfg, params.embed)[tokens])  # [B, S, D]
    rope = keep = None
    if cfg.pos_embedding == "learned":
        x = x + _c(cfg, params.pos_embed)[positions.long()][None, :, :]
    else:
        rope = _rope_tables(cfg, positions)
    if s > 1:  # rows in (r, s) order, causal within the call
        keep = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
        keep = keep.repeat(cfg.n_heads // cfg.n_kv_heads, 1)
    for layer, lp in enumerate(params.layers):
        h = _attention_cached(cfg, lp, _norm(cfg, lp.ln1, x), cache, layer, rope, keep)
        x = _act(cfg, x + h)
        x = _act(cfg, x + _mlp(cfg, lp, _norm(cfg, lp.ln2, x)))
    cache["pos"] = pos + s
    return _head(cfg, params, x), cache


def forward(cfg: LMConfig, params: Transformer, tokens: torch.Tensor, cache: dict | None = None,
            prefill: bool = False, remat: bool = False, fused: bool = False):
    """Run S tokens through the model.

    tokens: [B, S] integer (values in [0, vocab]; ``vocab`` = BOS row), on
    the parameters' device.

    ``prefill=False`` (the reference's default): the cached decode step.
    The S tokens sit at positions ``cache["pos"] + arange(S)`` after the
    cache's; returns (logits [B, S, vocab] f32, cache), the cache written at
    ``pos`` in place and ``pos`` advanced by S. ``cache`` comes from
    ``init_cache``.

    ``prefill=True``: from position 0 with an empty context; returns the
    logits alone (the reference's prefill callers drop its cache; ``cache``
    is ignored).

    ``remat=True``: recompute each layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` does
    in the reference; only the layers' inputs are kept.

    ``fused=True``: TRAINING-ONLY, route an MHA model's prefill attention
    through ``_FUSED["impl"]`` (module docstring); different float
    summation order from the exact branch, so coding paths must not set
    it."""
    _check_float_path(cfg)
    if not prefill:
        if cache is None:
            raise ValueError("forward(prefill=False) needs a cache from init_cache")
        return _forward_cached(cfg, params, tokens, cache)
    tokens = tokens.long()
    x = _act(cfg, _c(cfg, params.embed)[tokens])  # [B, S, D]
    if cfg.pos_embedding == "learned":
        s = tokens.shape[1]
        x = x + _c(cfg, params.pos_embed)[:s][None, :, :]
    for lp in params.layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, cfg, lp, x, fused, use_reentrant=False)
        else:
            x = _layer(cfg, lp, x, fused)
    return _head(cfg, params, x)

"""Decoder-only transformer LM: the float, int8 and det8 forwards, as ``nn.Module``s.

Ports ``lac_tpu/models/transformer.py``: ``LMConfig``
(:67-153), ``tiny_config`` (:155-163), the presets ``GPT2_SMALL``,
``TINYLLAMA_1B``, ``LLAMA2_7B`` and ``LLAMA3_8B`` (:166-183),
``init_params`` (:191-237), ``init_params_w8`` (:239-326), ``init_cache``
(:336-375), ``_norm`` (:376-388), ``_rope_table`` and ``_rope``
(:390-423), ``_act`` (:460-481), ``_q8``, ``W8_KEYS``, ``ensure_w8`` and
``_w8_dot`` (:484-550), the det8 primitives (:553-694), ``_mlp``
(:952-991), ``_attention`` (:771-949) with ``_FUSED`` (:703),
``_splash_prefill`` (:706-722), ``_bf16s_prefill`` (:725-743) and
``_flash_prefill`` (:746-768), and ``forward`` (:994-1116): the prefill
(``prefill=True``) and the cached decode step (``prefill=False``). Both
GPT-2-style (learned positions, LayerNorm, GELU, biases, tied head) and
Llama-style (RoPE, RMSNorm, SiLU-GLU, GQA, no biases) models, as in the
reference.

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
``cfg.dtype`` with a shared cursor ``pos``, a 0-d int64 tensor on the
cache's device: the step reads it there (masks by comparison, writes by
index), so no value of the step is a host number that changes from step
to step, and a CUDA graph of the step replays at every position
(``runtime/step_graph.py``). Each layer writes its fresh K/V at ``pos`` in
place after its own reads (the reference writes all layers at once after
the layer scan; a layer reads only its own slice and masks ``w >= pos``,
so the two give the same values).

Slide mode (``cfg.slide``, the reference's ring cache, :117-136, :1083-1095)
codes blocks longer than the context on one ``W``-wide cache: the write
cursor wraps to ``pos % W`` while ``pos``, the RoPE positions and the
validity mask ``w < pos`` stay global, so at step ``p >= W`` the cache
holds exactly tokens ``[p - W, p)`` and every slot counts. A call of S > 1
tokens adds the ring-age mask (:902-911): query ``i`` does not see the
``i`` oldest slots, which serial steps would have evicted. A call's write
may not wrap partway.

The int8 modes (``cfg.w8``, ``cfg.kv8``; alone or together):

- w8 (:484-550, :796-834, :967-978, :1069-1070): every ``W8_KEYS``
  projection and the head (even when tied to the embedding) is a ``W8``
  module, an int8 ``q`` [K, N] quantized over K and an f32 scale ``s``
  [1, N] with 1/127^2 folded in (``ensure_w8``, ``init_params_w8``).
  ``_w8_dot`` quantizes the activations per row (``_q8``), forms the
  exact int32 product (``ops/int8.py``) and dequantizes as
  ``(acc * sx) * s``; a bias adds in f32, then one cast. Embeddings,
  norms and biases stay float.
- kv8 (:354-362, :877-940, :1094-1107): the cache holds ``k`` and ``v``
  as int8 [L, B, W, KVH, Dh] and their per-row scales ``ks`` and ``vs``
  [L, B, W, KVH, 1] f32, in the reference's layout. The cache's scores
  are the exact int32 product of the query quantized per row and the int8
  K, dequantized as ``(acc * sq) * (sk * (scale / 127^2))``; the fresh
  scores use the unquantized fresh K; one softmax over both. The cache's
  PV product takes the probabilities times V's row scales, quantized per
  row over W, dequantized by the row scale times 1/127^2; the fresh PV
  product is the float path's; their f32 sum is cast once. A cache write
  (the step's at ``pos``, the prefill's at 0..S-1) quantizes each fresh
  K/V row over Dh.

``lac_tpu`` pins each of these f32 chains with ``optimization_barrier``,
since XLA regrouped ``acc * sx * ws`` differently in the encoder's and the
decoder's programs (its hazard #5); eager torch and a CUDA graph run each
op as written, so each product here is its own op, in the reference's
grouping, and nothing passes through ``torch.compile``. Given the same
inputs, ``_q8``, the quantized weights and every dequant chain equal
``lac_tpu``'s bit for bit.

det8 (``cfg.det8``, :425-694), the integer-reduction forward. Every
order-sensitive reduction is an int32 sum and every quantization scale is
a row's own maximum, so its bits depend on neither the shape nor the
device: the port's CPU and card runs give the same logits, and so do an
S-token chunk and S serial steps.

- Activations are f32 tensors holding ``cfg.dtype`` values (``_act``
  rounds them); the cache holds them in ``cfg.dtype``, exactly.
- Every product is integer: a dual-int8 operand (``_dual16``: int16
  precision as hi * 256 + lo, one scale a row) against int8 rows (``_q8``,
  one scale a row or column), both halves in one exact product
  (``ops/int8.py``: ``int8_mm`` for the projections and the head,
  ``int8_bmm`` for the scores and PV), recombined as ``hi * 256 + lo`` in
  f32. The weights' codes are a pure function of the weights, computed
  once a coding call (``ensure_det8``, ``D8``).
- The softmax sums ``round(det_exp(x - max) * 2^sb)`` in int32; the cached
  route pins ``sb`` with the cap ``2 * W``. The norms' statistics are
  int32 sums of int16 codes; ``det_rsqrt`` is ``1 / sqrt``. RoPE reads
  host tables (numpy float64, rounded to f32), gathered on the device.
- The float ops are elementwise and correctly rounded, each its own torch
  op, in the reference's grouping. Where XLA's CPU backend fuses a product
  into the add after it, the port computes ``detmath.fma32`` there, so
  that it equals ``lac_tpu`` bit for bit. Each site was measured against
  the jitted reference, at S 1 and S 24: ``mean_sq + eps`` in the norms;
  LayerNorm's ``x * scale + bias``; RoPE's ``x1 * cos - x2 * sin`` and
  ``x2 * cos + x1 * sin`` (the first product); every bias add after a
  product (``_det_proj``); and the residual add after ``wo`` and
  ``w_down`` in an f32 model without biases, where ``_act`` rounds nothing
  between them (``_det_out``, ``_residual``). LayerNorm's ``x - mean`` is
  not fused. The attention layout ``[B, KVH, R*S, ...]`` moves no bit:
  every quantization is per row.
- ``det_rsqrt`` is the one primitive that differs from ``lac_tpu``'s,
  whose XLA rewrite is up to 1 ulp off the documented ``1 / sqrt``
  (ROADMAP C).

Training-only fused attention: ``forward(..., fused=True)`` routes the
attention of an MHA model (``n_heads == n_kv_heads``) through
``_FUSED["impl"]``: ``"bf16s"`` (the default, torch ops), ``"flash"``
(K10-K12, ``ops/attention.py``, scale ``1/sqrt(hd)``) or ``"splash"``
(q times ``1/sqrt(hd)`` in ``cfg.dtype`` first, then K10-K12 at scale 1).
GQA takes the exact branch, as in ``lac_tpu``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_attention
from ..ops.detmath import ceil_log2, det_exp, det_gelu_tanh, det_rsqrt, det_silu, fma32, \
    int_sum_pow2
from ..ops.int8 import int8_bmm, int8_mm

__all__ = [
    "LMConfig",
    "Norm",
    "Block",
    "Transformer",
    "W8",
    "W8_KEYS",
    "init_params",
    "init_params_w8",
    "ensure_w8",
    "init_cache",
    "forward",
    "tiny_config",
    "GPT2_SMALL",
    "TINYLLAMA_1B",
    "LLAMA2_7B",
    "LLAMA3_8B",
]

f32 = torch.float32


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float: a scalar operand that an f32
    tensor op uses exactly, with no copy to the device."""
    return float(np.float32(x))


# the reference's f32(1 / 127^2): w8's folded scale and kv8's PV dequant
_DEQUANT = _f32(1.0 / (127.0 * 127.0))
# the dequant constant of a dual16 x q8 product (the reference's _DUAL_K)
_DUAL_K = _f32(1.0 / (32512.0 * 127.0))

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
    # the integer-reduction forward (module docstring): the same bits on
    # every device and at every split of the positions
    det8: bool = False
    # int8 weights (W8A8 projections) and the int8 KV cache (module
    # docstring); each changes the bitstream
    w8: bool = False
    kv8: bool = False
    # the ring cache past the model context (module docstring); the coding
    # engine sets it for a block longer than max_seq (lm_engine._slide_cfg)
    slide: bool = False
    # det8's bound on slide's global RoPE positions (its host tables); the
    # float path computes the angles on the device and ignores it
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


class _Int8Weight(nn.Module):
    """An int8 weight: ``q`` [K, N] int8, quantized over K, stored
    column-major (the layout of the card's int8 products; its values are
    the reference's), and ``s`` [1, N] f32, the per-column scale times the
    class's dequant constant ``FOLD``."""

    FOLD: float

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    @classmethod
    def empty(cls, k: int, n: int, device=None):
        return cls(torch.zeros((n, k), dtype=torch.int8, device=device).t(),
                   torch.ones((1, n), dtype=f32, device=device))

    @classmethod
    def quantize(cls, w: torch.Tensor):
        """``w`` [K, N] quantized over K (``_q8(w, axis=0)``), the scale
        times ``FOLD`` in one f32 multiply."""
        with torch.no_grad():
            q, s = _q8(w.float(), 0)
            return cls(q.t().contiguous().t(), s * cls.FOLD)


class W8(_Int8Weight):
    """An int8 weight of the w8 forward (``lac_tpu``'s ``(q, scale)``
    tuple, ``_quantize_w8``'s ``qw``): 1/127^2 folded into ``s``."""

    FOLD = _DEQUANT


class D8(_Int8Weight):
    """A weight of the det8 forward: ``_det_dot8``'s ``_q8(w, axis=0)``
    (:585), a pure function of the weight, quantized once for a coding call
    (``ensure_det8``) where the reference quantizes it in every step (the
    same bits); ``s`` is ``sw * _DUAL_K``, the factor of the reference's
    ``sx * (sw * _DUAL_K)``."""

    FOLD = _DUAL_K


W8_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


class Block(nn.Module):
    """One layer: ``ln1``, ``ln2`` and the projections of ``_layer_shapes``
    and ``_bias_shapes``; with ``w8``, each projection a ``W8``."""

    def __init__(self, cfg: LMConfig, dtype=None, device=None, w8: bool = False):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.ln1 = Norm(cfg, dtype, device)
        self.ln2 = Norm(cfg, dtype, device)
        for name, shape in _layer_shapes(cfg):
            setattr(self, name, W8.empty(*shape, device) if w8 else _param(shape, dtype, device))
        for name, shape in _bias_shapes(cfg):
            setattr(self, name, _param(shape, dtype, device))


class Transformer(nn.Module):
    """The parameters of one model: ``embed`` [vocab + 1, d] (the last row is
    BOS), ``pos_embed`` [max_seq, d] for learned positions, ``head``
    [d, vocab] unless tied, ``final_norm`` and ``layers``. With ``w8``
    (what ``ensure_w8`` and ``init_params_w8`` give), the projections and
    the head, tied or not, are ``W8`` modules."""

    def __init__(self, cfg: LMConfig, dtype=None, device=None, w8: bool = False):
        super().__init__()
        dtype = dtype or cfg.dtype
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _param((cfg.vocab + 1, d), dtype, device)
        self.final_norm = Norm(cfg, dtype, device)
        self.pos_embed = (_param((cfg.max_seq, d), dtype, device)
                          if cfg.pos_embedding == "learned" else None)
        if w8:
            self.head = W8.empty(d, cfg.vocab, device)
        else:
            self.head = None if cfg.tie_embeddings else _param((d, cfg.vocab), dtype, device)
        self.layers = nn.ModuleList(Block(cfg, dtype, device, w8) for _ in range(cfg.n_layers))


def is_w8(params: Transformer) -> bool:
    """Whether ``params`` holds the w8 forward's quantized weights."""
    return isinstance(params.head, W8)


def is_det8(params: Transformer) -> bool:
    """Whether ``params`` holds the det8 forward's quantized weights."""
    return isinstance(params.head, D8)


def _draws(cfg: LMConfig, seed: int):
    """``dense(fan_in, shape)``: the next scaled-normal draw in cfg.dtype,
    from a CPU ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def dense(fan_in, shape):
        return (torch.randn(shape, generator=g, dtype=f32)
                / torch.sqrt(torch.tensor(float(fan_in), dtype=f32))).to(cfg.dtype)

    return dense


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Transformer:
    """Random init (scaled normal), the reference's distributions and order
    of draws, from a CPU ``torch.Generator`` seeded with ``seed`` (the same
    weights on every device), then moved to ``device`` (the CPU when None).
    The bits differ from ``jax.random``'s. The weights are float whatever
    ``cfg.w8`` says, as in the reference (``ensure_w8`` quantizes them)."""
    dense = _draws(cfg, seed)
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


def _q8(x: torch.Tensor, dim: int):
    """int8 quantization of f32 ``x`` with one max per slice along ``dim``
    (the reference's ``_q8``, :484-492): ``s = max(max |x|, 1e-30)``,
    ``q = round((x / s) * 127)``, one f32 division then one f32 multiply,
    rounding half to even, as ``jnp.round``. Returns (q int8, s f32)."""
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30)
    return torch.round(x / s * 127.0).to(torch.int8), s


def _norm_like(cfg: LMConfig, device) -> Norm:
    norm = Norm(cfg, cfg.dtype, device)
    with torch.no_grad():
        norm.scale.fill_(1)
    return norm


def init_params_w8(cfg: LMConfig, seed: int = 0, device=None) -> Transformer:
    """``ensure_w8(cfg, init_params(cfg, seed, device))`` without the whole
    float model (the reference's staged ``init_params_w8``, :239-326, for
    7B/8B): the same draws in the same order, each layer's weights moved to
    ``device`` and quantized at once, only the int8 copy kept, so the peak
    is one layer's float tensors. Same structure, shapes, types and bits as
    the unstaged model."""
    if not cfg.w8:
        raise ValueError("init_params_w8 requires cfg.w8")
    dense = _draws(cfg, seed)
    dev = torch.device("cpu" if device is None else device)
    d = cfg.d_model
    model = Transformer(cfg, device="meta", w8=True)
    with torch.no_grad():
        model.embed = nn.Parameter((dense(1, (cfg.vocab + 1, d)) * 0.02).to(dev))
        if cfg.pos_embedding == "learned":
            model.pos_embed = nn.Parameter((dense(1, (cfg.max_seq, d)) * 0.01).to(dev))
        wh = model.embed[: cfg.vocab].T if cfg.tie_embeddings else dense(d, (d, cfg.vocab))
        model.head = W8.quantize(wh.to(dev))
        model.final_norm = _norm_like(cfg, dev)
        for lyr in model.layers:
            lyr.ln1, lyr.ln2 = _norm_like(cfg, dev), _norm_like(cfg, dev)
            for name, shape in _layer_shapes(cfg):
                setattr(lyr, name, W8.quantize(dense(shape[0], shape).to(dev)))
            for name, shape in _bias_shapes(cfg):
                setattr(lyr, name, _param(shape, cfg.dtype, dev))
    return model


def _quantized(cfg: LMConfig, params: Transformer, cls) -> Transformer:
    """``params`` with every ``W8_KEYS`` weight and the head (for a tied
    head, ``embed[:vocab].T``) quantized over K into a ``cls``, from its
    values as stored, as the reference quantizes them (its bf16 configs
    store the embedding in f32); the embeddings, norms and biases are
    ``params``' own tensors, shared. ``params`` is left as it was."""
    with torch.no_grad():
        model = Transformer(cfg, device="meta", w8=True)
        model.embed, model.final_norm = params.embed, params.final_norm
        model.pos_embed = params.pos_embed
        wh = params.embed[: cfg.vocab].T if cfg.tie_embeddings else params.head
        model.head = cls.quantize(wh)
        for lyr, src in zip(model.layers, params.layers):
            lyr.ln1, lyr.ln2 = src.ln1, src.ln2
            for name, _ in _layer_shapes(cfg):
                setattr(lyr, name, cls.quantize(getattr(src, name)))
            for name, _ in _bias_shapes(cfg):
                setattr(lyr, name, getattr(src, name))
    return model


def ensure_w8(cfg: LMConfig, params: Transformer) -> Transformer:
    """The w8 forward's model (the reference's ``ensure_w8`` and
    ``_quantize_w8``, :498-527): ``_quantized`` with ``W8``. Idempotent: a
    quantized model, or any model under a cfg without w8, comes back as it
    is."""
    if not cfg.w8 or is_w8(params):
        return params
    return _quantized(cfg, params, W8)


def ensure_det8(cfg: LMConfig, params: Transformer) -> Transformer:
    """The det8 forward's model: ``_quantized`` with ``D8``, the weights'
    quantization that the reference's ``_det_dot8`` repeats in every step,
    done once. Idempotent, as ``ensure_w8``."""
    if not cfg.det8 or is_det8(params):
        return params
    return _quantized(cfg, params, D8)


def ensure_quantized(cfg: LMConfig, params: Transformer) -> Transformer:
    """The model ``forward`` runs under ``cfg``: ``ensure_w8``'s under w8,
    ``ensure_det8``'s under det8 (the two exclude each other), else
    ``params``. The coding engine calls it once a coding call."""
    return ensure_det8(cfg, ensure_w8(cfg, params))


def init_cache(cfg: LMConfig, batch: int, window: int | None = None, device=None) -> dict:
    """KV cache over the context window: ``k`` and ``v`` ``[L, B, W, KVH,
    Dh]`` in ``cfg.dtype`` (zeros), or under kv8 in int8 with their per-row
    scales ``ks`` and ``vs`` ``[L, B, W, KVH, 1]`` f32, and ``pos``, the
    shared cursor (all lanes run lock-step), a 0-d int64 tensor on
    ``device``. ``window`` (default ``cfg.max_seq``, capped there) sizes
    the cache: every step reads all of it, so the coding engine sizes it to
    the block or grows it; under slide it is the ring."""
    w = cfg.max_seq if window is None else min(window, cfg.max_seq)
    shape = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.zeros((), dtype=torch.int64, device=device)
    if cfg.kv8:
        rows = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(rows, dtype=f32, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "vs": torch.zeros(rows, dtype=f32, device=device), "pos": pos}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device), "pos": pos}


def _cache_rows(cfg: LMConfig, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The cache entries of fresh K/V [B, S, KVH, Dh], keyed as the cache:
    themselves, or under kv8 each row quantized over Dh (:1094-1107)."""
    if not cfg.kv8:  # det8's rows hold cfg.dtype values: the cast is exact
        return {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}
    k8, ks = _q8(k.float(), -1)
    v8, vs = _q8(v.float(), -1)
    return {"k": k8, "ks": ks, "v": v8, "vs": vs}


def index_write(buf: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> None:
    """``buf.index_copy_(dim, index, src)`` for distinct indices, in a form a
    CUDA graph can capture. Under deterministic algorithms a CUDA
    ``index_copy_`` runs as ``index_put_``, which checks the index range on
    the host (a device sync, which a capture refuses). Distinct indices
    write distinct elements, so the plain kernel's result cannot depend on
    its order: the write runs with deterministic algorithms off."""
    if not (buf.is_cuda and torch.are_deterministic_algorithms_enabled()):
        buf.index_copy_(dim, index, src)
        return
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        buf.index_copy_(dim, index, src)
    finally:
        torch.use_deterministic_algorithms(True, warn_only=warn_only)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _c(cfg: LMConfig, p: torch.Tensor) -> torch.Tensor:
    """A parameter in ``cfg.dtype`` (itself when it is stored so)."""
    return p if p.dtype == cfg.dtype else p.to(cfg.dtype)


def _act(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Round an activation to the model dtype (:460-481): the float path's
    cast; under det8 the value rounds to ``cfg.dtype`` (round to nearest
    even, as ``reduce_precision``) and stays f32."""
    if cfg.det8:
        return x.float() if cfg.dtype == f32 else x.to(cfg.dtype).float()
    return x if x.dtype == cfg.dtype else x.to(cfg.dtype)


def _det_norm(cfg: LMConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    """det8's norm (:376-387): the statistics of ``_det_mean_sq`` and
    ``_det_mean``, ``det_rsqrt``; the scale and bias as stored, in f32.
    ``mean_sq + eps`` is ``fma32(t, (s * s) * cc, eps)`` and LayerNorm's
    bias add ``fma32(x, scale, bias)``: XLA fuses each product into the
    add that follows it. It does not fuse the mean's product into the
    centring ``x - mean`` (measured with an f32 model)."""
    xf = x.float()
    eps = _f32(cfg.norm_eps)
    if cfg.norm == "rmsnorm":
        xf = xf * det_rsqrt(fma32(*_det_mean_sq_parts(xf), eps))
        return _act(cfg, xf * p.scale.float())
    xc = xf - _det_mean(xf)
    xf = xc * det_rsqrt(fma32(*_det_mean_sq_parts(xc), eps))
    return _act(cfg, fma32(xf, p.scale.float(), p.bias.float()))


def _norm(cfg: LMConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.det8:
        return _det_norm(cfg, p, x)
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


@functools.lru_cache(maxsize=16)
def rope_table(n: int, hd: int, theta: float):
    """det8's host RoPE tables (:390-398): cos and sin [n, hd/2] of the
    angles in numpy float64, each rounded to f32."""
    half = hd // 2
    fr = np.exp(np.arange(half, dtype=np.float64) * (-np.log(float(theta)) * 2.0 / hd))
    ang = np.arange(n, dtype=np.float64)[:, None] * fr[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rope_table_on(n: int, hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_table`` as one f32 tensor [2, n, hd/2] on ``device``, put
    there once: a captured step gathers from it."""
    return torch.from_numpy(np.stack(rope_table(n, hd, theta))).to(device)


def _rope_tables(cfg: LMConfig, positions: torch.Tensor):
    """(cos, sin) [1, S, 1, Dh/2] f32 of the rotary angles at ``positions``
    [S]; the same for every layer, so a step computes them once. Under
    det8, the rows of the host tables at the positions (:405-409), sized
    ``max(max_seq, rope_positions)``, gathered on the device."""
    if cfg.det8:
        n = max(cfg.max_seq, cfg.rope_positions)
        table = _rope_table_on(n, cfg.head_dim, float(cfg.rope_theta), positions.device)
        rows = table.index_select(1, positions)
        return rows[0][None, :, None, :], rows[1][None, :, None, :]
    half = cfg.head_dim // 2
    coef = -np.log(np.float32(cfg.rope_theta)) * np.float32(2.0) / np.float32(cfg.head_dim)
    freqs = torch.exp(torch.arange(0, half, dtype=f32, device=positions.device) * float(coef))
    ang = positions.to(f32)[:, None] * freqs[None, :]  # [S, half]
    return torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]


def _rope_apply(cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split. x: [B, S, H, Dh]. Under det8 each
    half's first product is fused into its add or subtract, as XLA
    computes it (:418), then ``_act``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]  # widened to f32 by the products
    if cfg.det8:
        x1, x2 = x1.float(), x2.float()
        out = torch.cat([fma32(x1, cos, -(x2 * sin)), fma32(x2, cos, x1 * sin)], dim=-1)
        return _act(cfg, out)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split. x: [B, S, H, Dh]; positions: [S]."""
    return _rope_apply(cfg, x, *_rope_tables(cfg, positions))


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``cfg.dtype`` operands, f32 accumulation, one rounding to their type."""
    return torch.matmul(x, w)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same product kept in f32 (f32 upcasts: exact products of the
    operands, f32 sums)."""
    return torch.matmul(x.float(), w.float())


def _w8_dot(x: torch.Tensor, w: W8) -> torch.Tensor:
    """x [..., K] times an int8 weight -> f32 [..., N] (the reference's
    ``_w8_dot``, :530-550): x quantized per row, the exact int32 product
    (``ops.int8.int8_mm``), then ``(acc * sx) * s``, two f32 multiplies in
    that grouping."""
    xq, sx = _q8(x.float(), -1)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), w.q)
    return (acc.to(f32).reshape(*x.shape[:-1], -1) * sx) * w.s


# --------------------------------------------------------------------------
# det8: the integer-reduction forward (module docstring)
# --------------------------------------------------------------------------


def _row_max(x: torch.Tensor) -> torch.Tensor:
    """max(max |x| over the last axis, 1e-30), keepdim: every det8 scale."""
    return x.abs().amax(-1, keepdim=True).clamp_min(1e-30)


def _dual16(x: torch.Tensor):
    """int16-precision dual-int8 row quantization over the last axis
    (:553-560): x ~= (256 hi + lo) s / 32512, hi in [-127, 127], lo in
    [-128, 127]. Returns (hi, lo int8, s f32)."""
    s = _row_max(x)
    q = torch.round(x / s * 32512.0).to(torch.int32)
    hi = (q + 128) >> 8  # round-to-nearest high byte
    lo = q - (hi << 8)
    return hi.to(torch.int8), lo.to(torch.int8), s


def _dual_acc(acc: torch.Tensor, m: int) -> torch.Tensor:
    """The int32 products of ``cat([hi, lo])`` rows [.., 2m, N] recombined
    as ``dhi * 256 + dlo`` in f32 (:566-579): an exact product, one
    rounded add."""
    return acc[..., :m, :].float() * 256.0 + acc[..., m:, :].float()


def _det_dot8_parts(x: torch.Tensor, w: D8):
    """x [..., K] times a det8 weight (:582-586) as its two f32 factors
    ``(dual, sx * (sw * _DUAL_K))`` [..., N]: x in dual-int8 rows, hi and lo
    against the int8 weight in one exact product (``ops.int8.int8_mm``, the
    two stacked along M)."""
    hi, lo, sx = _dual16(x.float())
    k = x.shape[-1]
    m = hi.numel() // k
    acc = int8_mm(torch.cat([hi.reshape(m, k), lo.reshape(m, k)]), w.q)
    return _dual_acc(acc, m).reshape(*x.shape[:-1], -1), sx * w.s


def _det_dot8(x: torch.Tensor, w: D8) -> torch.Tensor:
    """x [..., K] times a det8 weight -> f32 [..., N]: ``dual * (sx * (sw *
    _DUAL_K))``."""
    dual, scale = _det_dot8_parts(x, w)
    return dual * scale


def _det_proj(cfg: LMConfig, x: torch.Tensor, w: D8, b) -> torch.Tensor:
    """``_det_dot8`` plus the bias in f32, where the model has biases
    (:791-794, :825-828, :953-956, :964-966): ``fma32(dual, scale, b)``,
    since XLA fuses the product into the add."""
    if not cfg.use_bias:
        return _det_dot8(x, w)
    return fma32(*_det_dot8_parts(x, w), b.float())


def _det_out(cfg: LMConfig, x: torch.Tensor, w: D8, b):
    """A layer's last product (``wo``, ``w_down``), which the residual add
    takes: ``_act`` of ``_det_proj``, or, where ``_act`` rounds nothing (an
    f32 model) and no bias comes between, its two factors, for the add to
    fuse the product as XLA does (``_residual``)."""
    if cfg.dtype == f32 and b is None:
        return _det_dot8_parts(x, w)
    return _act(cfg, _det_proj(cfg, x, w, b))


def _residual(cfg: LMConfig, x: torch.Tensor, h) -> torch.Tensor:
    """``_act(x + h)`` (:1053-1056), h a tensor or ``_det_out``'s factors,
    fused as ``fma32(dual, scale, x)``."""
    if isinstance(h, tuple):
        return _act(cfg, fma32(*h, x))
    return _act(cfg, x + h)


def _det_softmax(scores: torch.Tensor, cap: int | None = None) -> torch.Tensor:
    """Softmax over the last axis with an integer denominator (:589-598);
    ``-inf`` entries give exactly 0; ``cap`` pins the quantization exponent
    (``detmath.int_sum_pow2``)."""
    e = det_exp(scores - scores.amax(-1, keepdim=True))
    ei, tot, _ = int_sum_pow2(e, cap)
    return ei.float() / tot.float()


def _det_mean_sq_parts(x: torch.Tensor):
    """``_det_mean_sq`` (:601-615) as its two factors ``(t, (s * s) *
    cc)``: int16 row quantization, the squares' sum split into two int32
    sums, recombined in f32 (an exact product, one add)."""
    d = x.shape[-1]
    s = _row_max(x)
    q = torch.round(x / s * 32767.0).to(torch.int32)
    sq = q * q  # <= 2^30
    shift = max(12, ceil_log2(d) - 1)  # each sum fits int32
    hi = (sq >> shift).sum(-1, keepdim=True, dtype=torch.int32).float()
    lo = (sq & ((1 << shift) - 1)).sum(-1, keepdim=True, dtype=torch.int32).float()
    t = hi * float(1 << shift) + lo
    return t, (s * s) * _f32(1.0 / (32767.0 * 32767.0 * d))


def _det_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis from an int16 row quantization (:618-623):
    ``sum q * (s * c)``."""
    d = x.shape[-1]
    s = _row_max(x)
    q = torch.round(x / s * 32767.0).to(torch.int32)
    return q.sum(-1, keepdim=True, dtype=torch.int32).float() * (s * _f32(1.0 / (32767.0 * d)))


def _det_rows8(t: torch.Tensor):
    """K or V rows [B, N, KVH, Dh] (any float type) quantized per row over
    Dh (``_q8``; ``_det_v8``, :637-645), head-major: (int8 [B, KVH, N,
    Dh], scales f32 [B, KVH, N, 1])."""
    q, sc = _q8(t.float(), -1)
    return q.transpose(1, 2), sc.transpose(1, 2)


def _det_scores(qs: torch.Tensor, k8: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """Scores with integer accumulation (:626-634): qs [B, KVH, M, Dh] f32
    (pre-scaled queries, dual-int8 rows), k8 [B, KVH, J, Dh] int8 rows with
    their scales sk [B, KVH, J, 1] -> f32 [B, KVH, M, J], ``(dots * sq) *
    (sk * _DUAL_K)``."""
    hi, lo, sq = _dual16(qs)
    m = qs.shape[-2]
    acc = int8_bmm(torch.cat([hi, lo], -2), k8.transpose(-1, -2))
    return (_dual_acc(acc, m) * sq) * (sk.transpose(-1, -2) * _DUAL_K)


def _det_pv(probs: torch.Tensor, v8: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """probs [B, KVH, M, J] times V's int8 rows v8 [B, KVH, J, Dh] (scales
    sv [B, KVH, J, 1]) -> f32 [B, KVH, M, Dh] (``_det_attn_out`` and
    ``_det_attn_out_cached``, :648-694): V's scales folded into the
    probabilities, those in dual-int8 rows over J, one exact product over
    J (the reference's cache and fresh products summed in int32 are the
    same integers), then ``out * (sp * _DUAL_K)``."""
    hi, lo, sp = _dual16(probs * sv.transpose(-1, -2))
    acc = int8_bmm(torch.cat([hi, lo], -2), v8)
    return _dual_acc(acc, probs.shape[-2]) * (sp * _DUAL_K)


def _attend_det8(cfg: LMConfig, qf, rows, w_len: int, drop, keep, scale,
                 cap) -> torch.Tensor:
    """det8 attention (:848-863, :875-923) of queries qf [B, KVH, R*S, Dh]
    against ``rows`` [(K, V)] of [B, N, KVH, Dh] (the cache slice, ``w_len``
    wide, then the call's fresh rows; or the fresh rows alone, ``w_len``
    0), their scores side by side as the reference's concatenated axis:
    every quantization is per row, so quantizing the parts apart gives the
    same bits. ``drop`` / ``keep``: the masks of ``_mask``; ``cap``: the
    softmax's (``2 * w_len`` with a cache, None without). Returns f32
    [B, KVH, R*S, Dh], rounded by ``_act``."""
    ks = [_det_rows8(k) for k, _ in rows]
    vs = [_det_rows8(v) for _, v in rows]
    k8, sk = (torch.cat(t, 2) for t in zip(*ks))
    v8, sv = (torch.cat(t, 2) for t in zip(*vs))
    scores = _det_scores(qf * scale, k8, sk)
    _mask(scores, w_len, drop, keep)
    return _act(cfg, _det_pv(_det_softmax(scores, cap), v8, sv))


def _bias_f32(cfg: LMConfig, y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A w8 product's f32 result plus the bias, as stored, in f32."""
    return y + b.float() if cfg.use_bias else y


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
        if cfg.det8:
            y = _act(cfg, _det_proj(cfg, x, getattr(p, w), getattr(p, bias_name, None)))
        elif cfg.w8:
            y = _bias_f32(cfg, _w8_dot(x, getattr(p, w)), getattr(p, bias_name, None))
            y = y.to(cfg.dtype)
        else:
            y = _dot(x, _c(cfg, getattr(p, w)))
            if cfg.use_bias:
                y = y + _c(cfg, getattr(p, bias_name))
        return y.reshape(b, s, heads, cfg.head_dim)

    return proj("wq", "bq", cfg.n_heads), proj("wk", "bk", cfg.n_kv_heads), \
        proj("wv", "bv", cfg.n_kv_heads)


def _out_proj(cfg: LMConfig, p: Block, out: torch.Tensor) -> torch.Tensor:
    """The attention output [B, S, H*Dh] through ``wo``."""
    if cfg.det8:
        return _det_out(cfg, out, p.wo, getattr(p, "bo", None))
    if cfg.w8:
        return _bias_f32(cfg, _w8_dot(out, p.wo), getattr(p, "bo", None)).to(cfg.dtype)
    y = _dot(out, _c(cfg, p.wo))
    if cfg.use_bias:
        y = y + _c(cfg, p.bo)
    return y


def _attention(cfg: LMConfig, p: Block, x: torch.Tensor, fused: bool = False,
               cache: dict | None = None, layer: int = 0) -> torch.Tensor:
    """One layer's causal self-attention over the block (prefill); with a
    ``cache``, the block's K/V also go into the layer's slice at 0..S-1."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_embedding == "rope":
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    if cache is not None:
        for key, t in _cache_rows(cfg, k, v).items():
            cache[key][layer, :, :s] = t
    scale = _scale_f32(hd)

    if cfg.det8:  # the fused gate excludes det8, as the reference's (:840)
        rep = h // kvh
        qf = q.reshape(b, s, kvh, rep, hd).permute(0, 2, 3, 1, 4).reshape(b, kvh, rep * s, hd)
        ar = torch.arange(s, device=x.device)
        keep = ar[None, :] <= ar.repeat(rep)[:, None]  # causal, rows in (r, s) order
        out = _attend_det8(cfg, qf, [(k, v)], 0, None, keep, scale, None)
        out = out.reshape(b, kvh, rep, s, hd).permute(0, 3, 1, 2, 4)
    elif fused and h == kvh:
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


def _heads_f32(t: torch.Tensor) -> torch.Tensor:
    """[B, N, KVH, ...] -> contiguous f32 [B, KVH, N, ...]."""
    return t.transpose(1, 2).to(f32, memory_format=torch.contiguous_format)


def _mask(scores: torch.Tensor, w_len: int, drop, keep) -> None:
    """-inf, in place, at the cache slots ``drop`` and the fresh scores off
    ``keep`` (``_attention_cached``); either may be None."""
    if drop is not None:
        scores[..., :w_len].masked_fill_(drop, float("-inf"))
    if keep is not None:
        scores[..., w_len:].masked_fill_(~keep, float("-inf"))


def _attend_float(cfg: LMConfig, qf, kf, vf, ck, cv, drop, keep, scale) -> torch.Tensor:
    """The float cache route: f32 upcasts of the cache slice ``ck``, ``cv``
    [B, W, KVH, Dh]; returns [B, KVH, R*S, Dh] in cfg.dtype."""
    w_len = ck.shape[1]
    ckf, cvf = _heads_f32(ck), _heads_f32(cv)
    # the cache's scores [.., W] and the fresh ones [.., S], then the scale
    scores = torch.cat([torch.matmul(qf, ckf.transpose(-1, -2)),
                        torch.matmul(qf, kf.transpose(-1, -2))], dim=-1) * scale
    _mask(scores, w_len, drop, keep)
    # one softmax over both; the probabilities rounded to cfg.dtype, then
    # the cache's and the fresh products summed in f32
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype).float()
    out = torch.matmul(probs[..., :w_len], cvf) + torch.matmul(probs[..., w_len:], vf)
    return out.to(cfg.dtype)


def _kv8_scores(qf: torch.Tensor, c8: dict, scale: float) -> torch.Tensor:
    """The cache's scores under kv8 (:877-899): the queries qf [B, KVH,
    R*S, Dh] quantized per row over Dh, the exact int32 product with the
    int8 K, then ``(acc * sq) * (sk * (scale / 127^2))``, ``scale / 127^2``
    an f32 division as in the reference. Returns f32 [B, KVH, R*S, W]."""
    q8, sq = _q8(qf, -1)
    sci = int8_bmm(q8, c8["k"].permute(0, 2, 3, 1))
    skc = c8["ks"].permute(0, 2, 3, 1) * _f32(np.float32(scale) / np.float32(127.0 * 127.0))
    return (sci.to(f32) * sq) * skc


def _kv8_pv(probs: torch.Tensor, c8: dict) -> torch.Tensor:
    """The cache's PV product under kv8 (:924-936): the probabilities
    [B, KVH, R*S, W] times V's row scales, quantized per row over W, the
    exact int32 product with the int8 V, then ``acc * (sp * 1/127^2)``.
    Returns f32 [B, KVH, R*S, Dh]."""
    p8, sp = _q8(probs * c8["vs"].permute(0, 2, 3, 1), -1)
    oci = int8_bmm(p8, c8["v"].transpose(1, 2))
    return oci.to(f32) * (sp * _DEQUANT)


def _attend_kv8(cfg: LMConfig, qf, kf, vf, c8: dict, drop, keep, scale) -> torch.Tensor:
    """The kv8 cache route on the layer's int8 slice ``c8`` (``k``, ``v``
    [B, W, KVH, Dh], ``ks``, ``vs`` [B, W, KVH, 1]): the cache's scores
    beside the fresh ones (unquantized fresh K), one softmax, the cache's
    PV product plus the fresh one in f32, one cast. Returns [B, KVH, R*S,
    Dh] in cfg.dtype."""
    w_len = c8["k"].shape[1]
    scores = torch.cat([_kv8_scores(qf, c8, scale),
                        torch.matmul(qf, kf.transpose(-1, -2)) * scale], dim=-1)
    _mask(scores, w_len, drop, keep)
    probs = torch.softmax(scores, dim=-1)
    outf = torch.matmul(probs[..., w_len:].to(cfg.dtype).float(), vf)
    return (_kv8_pv(probs[..., :w_len], c8) + outf).to(cfg.dtype)


def _attention_cached(cfg: LMConfig, p: Block, x: torch.Tensor, cache: dict, layer: int,
                      rope, drop, keep, slots) -> torch.Tensor:
    """One layer's attention for S tokens at ``cache["pos"]`` against the
    layer's cache slice and the call's fresh K/V (the reference's
    ``prefill=False`` branches, float or kv8), then the fresh K/V written
    into the slice at ``slots``. ``rope``: the call's (cos, sin), or None.
    ``drop``: the cache slots no query may see, [W] or [R*S, W]. ``keep``:
    the causal mask of the fresh scores [R*S, S], or None at S 1, where it
    keeps everything. ``slots``: [S] cache slots of the call's tokens."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    slice_ = {key: t[layer] for key, t in cache.items() if key != "pos"}
    q, k, v = _qkv(cfg, p, x)
    if rope is not None:  # q and k rotated as one tensor: the same values
        q, k = _rope_apply(cfg, torch.cat([q, k], dim=2), *rope).split([h, kvh], dim=2)
    scale = _scale_f32(hd)
    # GQA: the query heads of a KV head fold into the rows, [B, KVH, R*S, Dh]
    # in (r, s) order; every product is one batched matmul over (B, KVH),
    # with each operand made contiguous first
    rep = h // kvh
    qf = _heads_f32(q.reshape(b, s, kvh, rep, hd)).transpose(2, 3).reshape(b, kvh, rep * s, hd)
    if cfg.det8:
        w_len = slice_["k"].shape[1]
        out = _attend_det8(cfg, qf, [(slice_["k"], slice_["v"]), (k, v)], w_len, drop, keep,
                           scale, 2 * w_len)
    elif cfg.kv8:
        out = _attend_kv8(cfg, qf, _heads_f32(k), _heads_f32(v), slice_, drop, keep, scale)
    else:
        out = _attend_float(cfg, qf, _heads_f32(k), _heads_f32(v), slice_["k"], slice_["v"],
                            drop, keep, scale)
    out = out.reshape(b, kvh, rep, s, hd).permute(0, 3, 1, 2, 4)
    y = _out_proj(cfg, p, out.reshape(b, s, h * hd))
    # after this layer's reads: the fresh K/V into its slice
    for key, t in _cache_rows(cfg, k, v).items():
        index_write(slice_[key], 1, slots, t)
    return y


def _mlp(cfg: LMConfig, p: Block, x: torch.Tensor) -> torch.Tensor:
    if cfg.det8:  # (:952-966) each product's result rounded by _act, but the gate's
        up = _act(cfg, _det_proj(cfg, x, p.w_up, getattr(p, "b_up", None)))
        if cfg.act == "silu_glu":
            up = _act(cfg, det_silu(_det_dot8(x, p.w_gate)) * up)
        else:
            up = _act(cfg, det_gelu_tanh(up))
        return _det_out(cfg, up, p.w_down, getattr(p, "b_down", None))
    if cfg.w8:  # (:967-978) f32 between the products, one cast before w_down
        up = _bias_f32(cfg, _w8_dot(x, p.w_up), getattr(p, "b_up", None))
        if cfg.act == "silu_glu":
            up = F.silu(_w8_dot(x, p.w_gate)) * up
        else:
            up = F.gelu(up, approximate="tanh")
        y = _w8_dot(up.to(cfg.dtype), p.w_down)
        return _bias_f32(cfg, y, getattr(p, "b_down", None)).to(cfg.dtype)
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


def _layer(cfg: LMConfig, p: Block, x: torch.Tensor, fused: bool, cache: dict | None = None,
           layer: int = 0) -> torch.Tensor:
    x = _residual(cfg, x, _attention(cfg, p, _norm(cfg, p.ln1, x), fused, cache, layer))
    return _residual(cfg, x, _mlp(cfg, p, _norm(cfg, p.ln2, x)))


def _head(cfg: LMConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the output head: f32 logits [B, S, vocab]."""
    x = _norm(cfg, params.final_norm, x)
    if cfg.det8:
        return _det_dot8(x, params.head)  # ensure_det8 quantized it, tied or not
    if cfg.w8:
        return _w8_dot(x, params.head)
    embed = _c(cfg, params.embed)
    wh = embed[: cfg.vocab].T if cfg.tie_embeddings else _c(cfg, params.head)
    return _dot_f32(x, wh)


def _pos_add(cfg: LMConfig, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The learned position rows [S, D] added to x [B, S, D]: in cfg.dtype,
    or under det8 in f32 from the rows as stored, then ``_act``
    (:1037-1043)."""
    if cfg.det8:
        return _act(cfg, x + rows.float()[None])
    return x + _c(cfg, rows)[None]


def _forward_cached(cfg: LMConfig, params: Transformer, tokens: torch.Tensor, cache: dict):
    b, s = tokens.shape
    w_len = cache["k"].shape[2]
    dev = tokens.device
    pos = cache["pos"]  # 0-d int64 on the device: every use below is a device op
    at = pos % w_len if cfg.slide else pos  # the call's first slot
    # checked on the device (no sync): the write may not overrun the cache,
    # nor, under slide, wrap partway
    torch._assert_async(at + s <= w_len, f"{s} tokens overrun the cache width {w_len}")
    tokens = tokens.long()
    ar = torch.arange(s, device=dev)
    positions = pos + ar  # global under slide
    x = _act(cfg, _c(cfg, params.embed)[tokens])  # [B, S, D]
    rope = keep = None
    if cfg.pos_embedding == "learned":
        x = _pos_add(cfg, x, params.pos_embed[positions])
    else:
        rope = _rope_tables(cfg, positions)
    w_ids = torch.arange(w_len, device=dev)
    seen = w_ids < pos  # slots that hold a token; under slide every slot once pos >= W
    if s > 1:  # rows in (r, s) order
        q_ids = ar.repeat(cfg.n_heads // cfg.n_kv_heads)
        keep = ar[None, :] <= q_ids[:, None]  # causal within the call
        if cfg.slide:  # ring age: query i does not see the i oldest slots
            seen = seen & (torch.remainder(w_ids - pos, w_len)[None, :] >= q_ids[:, None])
    drop = ~seen
    slots = at + ar
    for layer, lp in enumerate(params.layers):
        h = _attention_cached(cfg, lp, _norm(cfg, lp.ln1, x), cache, layer, rope, drop, keep,
                              slots)
        x = _residual(cfg, x, h)
        x = _residual(cfg, x, _mlp(cfg, lp, _norm(cfg, lp.ln2, x)))
    cache["pos"] += s
    return _head(cfg, params, x), cache


def forward(cfg: LMConfig, params: Transformer, tokens: torch.Tensor, cache: dict | None = None,
            prefill: bool = False, remat: bool = False, fused: bool = False):
    """Run S tokens through the model.

    tokens: [B, S] integer (values in [0, vocab]; ``vocab`` = BOS row), on
    the parameters' device.

    ``prefill=False`` (the reference's default): the cached decode step.
    The S tokens sit at positions ``cache["pos"] + arange(S)`` after the
    cache's; returns (logits [B, S, vocab] f32, cache), the cache written at
    ``pos`` (under slide ``pos % W``) in place and ``pos`` advanced by S.
    ``cache`` comes from ``init_cache``.

    ``prefill=True``: from position 0 with an empty context. Without a
    cache, returns the logits alone; with one (the reference's re-prime
    passes a fresh ``init_cache``), returns (logits, cache), the block's K/V
    written at slots 0..S-1 and ``pos`` set to S, as S steps would leave
    them; slots from S on keep what they held, which the steps mask
    (``w < pos``) as they mask a fresh cache's zeros.

    ``remat=True``: recompute each layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` does
    in the reference; only the layers' inputs are kept.

    ``fused=True``: TRAINING-ONLY, route an MHA model's prefill attention
    through ``_FUSED["impl"]`` (module docstring); different float
    summation order from the exact branch, so coding paths must not set
    it."""
    want = "w8" if cfg.w8 else "det8" if cfg.det8 else "float"
    have = "w8" if is_w8(params) else "det8" if is_det8(params) else "float"
    if want != have:
        raise ValueError("the w8 forward needs the model ensure_w8 gives, the det8 forward "
                         "the one ensure_det8 gives, and the float forward a float one "
                         f"(the forward is {want}, the model {have})")
    if not prefill:
        if cache is None:
            raise ValueError("forward(prefill=False) needs a cache from init_cache")
        return _forward_cached(cfg, params, tokens, cache)
    tokens = tokens.long()
    s = tokens.shape[1]
    if cache is not None and s > cache["k"].shape[2]:
        raise ValueError(f"a prefill of {s} tokens overruns the cache width "
                         f"{cache['k'].shape[2]}")
    x = _act(cfg, _c(cfg, params.embed)[tokens])  # [B, S, D]
    if cfg.pos_embedding == "learned":
        x = _pos_add(cfg, x, params.pos_embed[:s])
    for layer, lp in enumerate(params.layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, cfg, lp, x, fused, cache, layer, use_reentrant=False)
        else:
            x = _layer(cfg, lp, x, fused, cache, layer)
    if cache is None:
        return _head(cfg, params, x)
    cache["pos"].fill_(s)
    return _head(cfg, params, x), cache

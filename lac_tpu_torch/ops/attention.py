"""Fused causal attention for training: K10-K12, their plain versions, and
the autograd function that joins them.

Ports the library Pallas kernels that ``lac_tpu``'s training prefill
reaches (``lac_tpu/models/transformer.py:706-768``): JAX's flash attention
(``jax/experimental/pallas/ops/tpu/flash_attention.py``, forward
``_flash_attention_impl`` :589, backward ``_flash_attention_bwd_dkv`` :941
and ``_flash_attention_bwd_dq`` :1287) and splash attention
(``splash_attention_kernel.py``, ``_splash_attention_forward`` :895,
``_splash_attention_bwd_dq`` :1405, ``_splash_attention_bwd_dkv`` :1857).
Both compute the same causal softmax attention; splash takes q already
multiplied by the scale, so it is this function with ``scale = 1``.

- K10 ``causal_attn_fwd(q, k, v, scale) -> (o, lse)``;
- K11 ``causal_attn_bwd_dkv(q, k, v, do, lse, di, scale) -> (dk, dv)``;
- K12 ``causal_attn_bwd_dq(q, k, v, do, lse, di, scale) -> dq``;
- ``causal_attention(q, k, v, scale)``: the ``torch.autograd.Function``
  whose forward is K10 and whose backward is K11 and K12, with
  ``di = sum(o * do, -1)`` in f32 as a torch op, as the library computes
  it outside its kernels (``flash_attention.py:273-275``).

Tensors are ``[B, H, S, D]`` with the last dimension contiguous; ``lse`` and
``di`` are ``[B, H, S]`` f32. The kernels take the ``[B, H, S, D]`` and
``[B, S, H, D]`` storage orders without a copy (the model hands them views
of its ``[B, S, H, D]`` projections); any other layout is copied into
``[B, H, S, D]`` first. Inputs are bf16 or f32, head dim 64 or 128 on the
card; outputs take the input type.

Which kernel a CUDA tensor launches is fixed by its type, not tried:
bf16 K10-K12 run on the tensor cores (``csrc/causal_attn_sm90.cu``:
wgmma, TMA, mbarriers), f32 K10-K12 on the scalar kernels of
``csrc/causal_attn.cu`` (tensor cores on f32 would mean TF32). The
tensor-core kernels read their operands through TMA maps, whose byte
strides ``tma_strides`` computes and checks.

A wrapper runs its plain version only for tensors on the CPU, where any
head dim works. For CUDA tensors it launches its kernel or raises; it
never falls back. ``launches[name]`` counts the kernel's launches, both
variants alike, and nothing else; ``symbol_launches``
counts them by the C entry point launched. The plain versions use
explicit f32 math, and the backward recomputes ``P = exp(s * scale -
lse)`` as the kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "causal_attention",
    "causal_attn_fwd",
    "causal_attn_bwd_dkv",
    "causal_attn_bwd_dq",
    "attention_plain_fwd",
    "attention_plain_bwd",
    "attention_plain_bwd_dkv",
    "attention_plain_bwd_dq",
    "launches",
    "symbol_launches",
    "reset_launches",
    "tma_strides",
    "KERNEL_HEAD_DIMS",
]

KERNEL_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

launches = {"causal_attn_fwd": 0, "causal_attn_bwd_dkv": 0, "causal_attn_bwd_dq": 0}
# by entry point: the scalar kernels (lac_attn_*) and the tensor-core ones
# (lac_attn_*_sm90)
symbol_launches = {s: 0 for s in ("lac_attn_fwd", "lac_attn_fwd_sm90", "lac_attn_bwd_dkv",
                                  "lac_attn_bwd_dkv_sm90", "lac_attn_bwd_dq",
                                  "lac_attn_bwd_dq_sm90")}


def reset_launches() -> None:
    for counts in (launches, symbol_launches):
        for k in counts:
            counts[k] = 0


# --------------------------------------------------------------------------
# Plain versions (f32 math)
# --------------------------------------------------------------------------


def _scores(q, k, scale):
    """Masked scaled scores [B, H, S, S] in f32, and the causal mask."""
    s_len = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = torch.ones(s_len, s_len, dtype=torch.bool, device=q.device).tril()
    return s, keep


def attention_plain_fwd(q, k, v, scale: float):
    """(o in q's type, lse f32 [B, H, S]) of causal softmax(q k^T scale) v."""
    s, keep = _scores(q, k, scale)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _plain_ds(q, k, v, do, lse, di, scale):
    """(P, dS) [B, H, S, S] f32, recomputed from lse as the kernels do."""
    s, keep = _scores(q, k, scale)
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di[..., None])


def attention_plain_bwd_dkv(q, k, v, do, lse, di, scale: float):
    """(dk, dv) in q's type; K11's plain version."""
    p, ds = _plain_ds(q, k, v, do, lse, di, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk.to(q.dtype), dv.to(q.dtype)


def attention_plain_bwd_dq(q, k, v, do, lse, di, scale: float):
    """dq in q's type; K12's plain version."""
    _, ds = _plain_ds(q, k, v, do, lse, di, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def _di(o, do):
    return (o.float() * do.float()).sum(-1)


def attention_plain_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) in q's type, with di = sum(o * do, -1) in f32."""
    di = _di(o, do)
    dk, dv = attention_plain_bwd_dkv(q, k, v, do, lse, di, scale)
    return attention_plain_bwd_dq(q, k, v, do, lse, di, scale), dk, dv


# --------------------------------------------------------------------------
# Argument checks and launches
# --------------------------------------------------------------------------


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got shape {tuple(t.shape)}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} is on an unsupported device {t.device}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} (no GQA in the fused path)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share one of {_DTYPES}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def _strides(t):
    """(sh, ss) element strides if ``t`` [B, H, S, D] is stored as
    [B, H, S, D] or [B, S, H, D] with the batch stride H S D; else None."""
    b, h, s, d = t.shape
    sb, sh, ss, sd = t.stride()
    if sd != 1 and d > 1:
        return None
    if (sh, ss) in ((s * d, d), (d, h * d)) and (sb == h * s * d or b == 1):
        return sh, ss
    return None


def _like(t, layout_of):
    """``t`` in the storage order of ``layout_of`` (no copy when it is)."""
    if t.stride() == layout_of.stride():
        return t
    return torch.empty_like(layout_of).copy_(t)


def _kernel_args(q, *rest):
    """Checks for a launch: CUDA, a kernel head dim, a storage order the
    kernel takes. Returns (q, rest in q's order, (sh, ss))."""
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take head dim {KERNEL_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"B * H = {q.shape[0] * q.shape[1]} exceeds the grid's 65535")
    for t in rest:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"dO must match q: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"q {q.dtype} {tuple(q.shape)} on {q.device}")
    st = _strides(q)
    if st is None:
        q = torch.empty(q.shape, dtype=q.dtype, device=q.device).copy_(q)
        st = _strides(q)
    return q, [_like(t, q) for t in rest], st


def _rows(t, shape, name):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be f32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def tma_strides(st, q, *ts) -> tuple:
    """Byte strides (ss, sh, sb) of a position, a head and a batch of ``q``
    [B, H, S, D], stored as ``st = _strides(q)`` says, for the TMA maps of
    the tensor-core kernels; ``ts`` share q's storage order. TMA takes only
    strides that are multiples of 16 bytes and base addresses aligned to 16
    bytes: anything else raises."""
    _, h, s, d = q.shape
    es = q.element_size()
    out = (st[1] * es, st[0] * es, h * s * d * es)
    if any(x % 16 for x in out):
        raise ValueError(f"TMA needs byte strides that are multiples of 16, got (position, "
                         f"head, batch) = {out}")
    for x in (q, *ts):
        if x.data_ptr() % 16:
            raise ValueError(f"TMA needs 16-byte-aligned tensors, got address {x.data_ptr():#x}")
    return out


def _launch(symbol: str, name: str, device: torch.device, *args) -> None:
    """Call ``symbol`` on the device's current stream; raise on any non-zero
    return (a cudaError_t, or 1000 + a CUresult from a TMA map). Counts the
    launch under kernel ``name`` and under ``symbol``."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch ({symbol}) failed: error {rc}")
    launches[name] += 1
    symbol_launches[symbol] += 1


def _dims(q, st, scale):
    return (*q.shape, *st, ctypes.c_float(float(scale)))


def _dims_sm90(q, st, tensors, scale):
    return (*q.shape, *tma_strides(st, q, *tensors), ctypes.c_float(float(scale)))


def causal_attn_fwd(q, k, v, scale: float):
    """K10: (o, lse) of causal softmax(q k^T scale) v; o in q's type and
    storage order, lse f32 [B, H, S]."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain_fwd(q, k, v, scale)
    q, (k, v), st = _kernel_args(q, k, v)
    b, h, s, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if not q.numel():
        return o, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    if q.dtype == torch.bfloat16:
        _launch("lac_attn_fwd_sm90", "causal_attn_fwd", q.device, *ptrs,
                *_dims_sm90(q, st, (k, v, o), scale))
    else:
        _launch("lac_attn_fwd", "causal_attn_fwd", q.device, *ptrs, *_dims(q, st, scale))
    return o, lse


def causal_attn_bwd_dkv(q, k, v, do, lse, di, scale: float):
    """K11: (dk, dv) from q, k, v, dO, lse and di = sum(o * dO, -1)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain_bwd_dkv(q, k, v, do, lse, di, scale)
    q, (k, v, do), st = _kernel_args(q, k, v, do)
    lse, di = _rows(lse, q.shape[:3], "lse"), _rows(di, q.shape[:3], "di")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if not q.numel():
        return dk, dv
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if q.dtype == torch.bfloat16:
        _launch("lac_attn_bwd_dkv_sm90", "causal_attn_bwd_dkv", q.device, *ptrs,
                *_dims_sm90(q, st, (k, v, do, dk, dv), scale))
    else:
        _launch("lac_attn_bwd_dkv", "causal_attn_bwd_dkv", q.device, *ptrs,
                *_dims(q, st, scale))
    return dk, dv


def causal_attn_bwd_dq(q, k, v, do, lse, di, scale: float):
    """K12: dq from q, k, v, dO, lse and di."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain_bwd_dq(q, k, v, do, lse, di, scale)
    q, (k, v, do), st = _kernel_args(q, k, v, do)
    lse, di = _rows(lse, q.shape[:3], "lse"), _rows(di, q.shape[:3], "di")
    dq = torch.empty_like(q)
    if not q.numel():
        return dq
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr())
    if q.dtype == torch.bfloat16:
        _launch("lac_attn_bwd_dq_sm90", "causal_attn_bwd_dq", q.device, *ptrs,
                *_dims_sm90(q, st, (k, v, do, dq), scale))
    else:
        _launch("lac_attn_bwd_dq", "causal_attn_bwd_dq", q.device, *ptrs, *_dims(q, st, scale))
    return dq


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = causal_attn_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        di = _di(o, do)
        dk, dv = causal_attn_bwd_dkv(q, k, v, do, lse, di, ctx.scale)
        dq = causal_attn_bwd_dq(q, k, v, do, lse, di, ctx.scale)
        return dq, dk, dv, None


def causal_attention(q, k, v, scale: float):
    """Causal softmax(q k^T scale) v over [B, H, S, D], differentiable: K10
    forward, K11 and K12 backward (their plain versions on the CPU)."""
    return _CausalAttention.apply(q, k, v, scale)

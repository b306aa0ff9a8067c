"""The cached decode step's attention: one query position of every lane
against the layer's K/V cache and the step's fresh K/V, the float route
at S = 1 of ``models/transformer.py``'s ``_attention_cached`` on the card.

- ``takes_step(cfg, device)``: whether a step of one token takes the
  kernel, which the model asks before it routes a step here and the
  fingerprint before it folds the kernel's tag;
- ``step_attention(q, k, v, ck, cv, pos, scale)``: the kernel
  (``csrc/step_attn.cu``), CUDA tensors only;
- ``step_attention_plain``: the plain version, the float route
  (``_attend_float``) as the model runs it on the CPU, op for op: the
  tests' reference.

It replaces no TPU kernel: ``lac_tpu``'s cached step is plain jnp that
XLA fuses. The kernel exists because the torch route copies the layer's
whole cache slice into new f32 tensors at every step (``csrc/step_attn.cu``
says more). The math: f32 scores of the stored values times the scale over
the live cache slots ``w < min(pos, W)`` and the fresh row, one f32
softmax, the probabilities rounded to the inputs' type, the products
summed in f32 and rounded once. The slots ``w >= pos`` get probability
exactly 0 in the plain version (scores of ``-inf``) and are not read by
the kernel.

Shapes: ``q`` [B, 1, H, Dh], ``k`` and ``v`` [B, 1, KVH, Dh] (any lane
and head strides, the last dimension contiguous), ``ck`` and ``cv`` the
layer's cache slices [B, W, KVH, Dh], contiguous, ``pos`` the cache's
cursor, a 0-d int64 tensor on the same device; all of one type, bf16 or
f32; ``H = R KVH``, the query heads ``g R .. g R + R - 1`` reading KV head
``g``. Returns [B, 1, H, Dh] contiguous, in the inputs' type. The kernel
takes any R and W, and a row of Dh values of up to 512 bytes; the library
says which shapes it takes and what scratch memory they need
(``lac_step_attn_scratch``), so this module holds no copy of its layout.

The wrapper launches the kernel or raises; it never falls back.
``launches`` counts the kernel's launches (at an eager step and at a
capture of a graph, not at its replays)."""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["takes_step", "step_attention", "step_attention_plain", "launches"]

_DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def takes_step(cfg, device: torch.device) -> bool:
    """Whether a step of one token of the model ``cfg`` (an ``LMConfig``)
    on ``device`` takes the kernel: a float cache (not det8, not kv8) on
    CUDA, at every shape. ``models/transformer._attention_cached`` routes
    by it and ``runtime/lm_engine.lm_fingerprint`` folds the kernel's tag
    by it."""
    return device.type == "cuda" and not (cfg.det8 or cfg.kv8)


def _heads_f32(t: torch.Tensor) -> torch.Tensor:
    """[B, N, KVH, ...] -> contiguous f32 [B, KVH, N, ...]."""
    return t.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)


def step_attention_plain(q, k, v, ck, cv, pos, scale: float) -> torch.Tensor:
    """The float route of ``_attention_cached`` at S = 1, op for op: f32
    upcasts of the cache slice, the cache's and the fresh scores under one
    softmax with ``-inf`` at the slots ``w >= pos``, the probabilities
    rounded to the inputs' type, two f32 products summed, one rounding.
    Any device; the shapes of ``step_attention``."""
    b, _, h, hd = q.shape
    w_len, kvh = ck.shape[1], ck.shape[2]
    rep = h // kvh
    qf = _heads_f32(q.reshape(b, 1, kvh, rep, hd)).transpose(2, 3).reshape(b, kvh, rep, hd)
    kf, vf = _heads_f32(k), _heads_f32(v)
    ckf, cvf = _heads_f32(ck), _heads_f32(cv)
    scores = torch.cat([torch.matmul(qf, ckf.transpose(-1, -2)),
                        torch.matmul(qf, kf.transpose(-1, -2))], dim=-1) * scale
    drop = ~(torch.arange(w_len, device=q.device) < pos)
    scores[..., :w_len].masked_fill_(drop, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.matmul(probs[..., :w_len], cvf) + torch.matmul(probs[..., w_len:], vf)
    out = out.to(q.dtype).reshape(b, kvh, rep, 1, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, 1, h, hd)


def _row_strides(name, t, heads, hd):
    """(lane, head) element strides of ``t`` [B, 1, heads, Dh], whose last
    dimension is contiguous."""
    if t.dim() != 4 or t.shape[1] != 1 or t.shape[2] != heads or t.shape[3] != hd:
        raise ValueError(f"{name} must be [B, 1, {heads}, {hd}], got {tuple(t.shape)}")
    sb, _, sh, sd = t.stride()
    if sd != 1 and hd > 1:
        raise ValueError(f"{name} must have contiguous rows, got strides {t.stride()}")
    return sb, sh


def _check(q, k, v, ck, cv, pos):
    """The wrapper's checks; returns (B, KVH, R, W, Dh) and the strides of
    q, k and v."""
    ts = (("q", q), ("k", k), ("v", v), ("ck", ck), ("cv", cv))
    for name, t in (*ts, ("pos", pos)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for _, t in ts):
        raise TypeError(f"q, k, v, ck, cv must share one of {_DTYPES}, got "
                        f"{[t.dtype for _, t in ts]}")
    if pos.dtype != torch.int64 or pos.dim() != 0:
        raise TypeError(f"pos must be a 0-d int64 tensor, got {pos.dtype} {tuple(pos.shape)}")
    if ck.dim() != 4 or ck.shape != cv.shape or not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError(f"ck, cv must be contiguous [B, W, KVH, Dh], got {tuple(ck.shape)} and "
                         f"{tuple(cv.shape)}")
    b, w_len, kvh, hd = ck.shape
    if q.dim() != 4 or q.shape[0] != b or q.shape[2] % kvh or not q.shape[2]:
        raise ValueError(f"q must be [{b}, 1, R x {kvh}, {hd}], got {tuple(q.shape)}")
    r = q.shape[2] // kvh
    strides = [_row_strides(name, t, heads, hd)
               for name, t, heads in (("q", q, r * kvh), ("k", k, kvh), ("v", v, kvh))]
    if k.shape[0] != b or v.shape[0] != b:
        raise ValueError(f"k, v must hold {b} lanes, got {k.shape[0]} and {v.shape[0]}")
    return (b, kvh, r, w_len, hd), strides


def step_attention(q, k, v, ck, cv, pos, scale: float) -> torch.Tensor:
    """The step's attention, [B, 1, H, Dh] (module docstring), by the
    kernel; CUDA tensors only."""
    global launches
    (b, kvh, r, w_len, hd), strides = _check(q, k, v, ck, cv, pos)
    if q.device.type != "cuda":
        raise ValueError(f"step_attention takes CUDA tensors, got {q.device} (the model's "
                         "route elsewhere is _attend_float; step_attention_plain)")
    out = torch.empty((b, 1, r * kvh, hd), dtype=q.dtype, device=q.device)
    if not b:
        return out
    lib = _build.load_library()
    bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        n = lib.lac_step_attn_scratch(b, kvh, r, w_len, hd, bf16)
        if n < 0:
            raise ValueError(f"the step kernel does not take {r} query heads a KV head over "
                             f"{w_len} slots at head dim {hd} in {q.dtype} (csrc/step_attn.cu: "
                             "a row of at most 512 bytes)")
        scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.lac_step_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ck.data_ptr(),
                               cv.data_ptr(), pos.data_ptr(), out.data_ptr(),
                               scratch.data_ptr() if n else None, b, kvh, r, w_len, hd, bf16,
                               *(x for st in strides for x in st),
                               ctypes.c_float(float(scale)), stream)
    if rc != 0:
        raise RuntimeError(f"step_attn kernel launch (lac_step_attn) failed: error {rc}")
    launches += 1
    return out

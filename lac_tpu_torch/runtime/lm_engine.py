"""LM coding engine: lock-step batched encode and decode with a transformer.

Ports ``lac_tpu/runtime/lm_engine.py``: ``_step_cdf`` (:42-47), the
fixed-width encode and decode (``_encode_intervals`` :49-68,
``_decode_scan`` :265-286) and the growing-cache schedule (``GROW_BUCKET``,
``_grow_cache``, ``_check_grow``, ``_grown_segments``, ``_run_grown``,
``_encode_intervals_grown``, ``_decode_scan_grown`` :173-263,
``_seg_intervals`` :361-372, ``_seg_decode`` :539-555), both run by one
encode and one decode function (the fixed width is the schedule's one
segment, as ``_grown_segments`` gives it at bucket 0), ``lm_encode`` and
``lm_decode`` (:289-326), ``lm_encode_windowed`` and ``lm_decode_windowed``
for blocks within the model context (:397-430, :557-569; a longer block is
ROADMAP A6 and raises), and ``lm_fingerprint`` (:629-672). The det8,
kv8 and w8 forwards are A8 and A7: the transformer raises for them.

Determinism contract (``lac_tpu/runtime/lm_engine.py:1-15``): the encoder
and the decoder run the SAME step function, ``_step_cdf``, on the SAME
shapes (lanes, cache width) and the SAME schedule, one single-token
forward per position, lock-step across the lanes. Given the same weights,
stack and device, the float logits are then identical on both sides, so
the integer CDFs match bit for bit. The step runs eagerly: no
``torch.compile``, since two compiled programs may fuse the shared step
differently (``lac_tpu``'s hazard #5). On CUDA the coding calls run under
``_coding``: deterministic algorithms on, TF32 and reduced-precision bf16
reductions off; ``lac_tpu_torch/__init__.py`` sets
``CUBLAS_WORKSPACE_CONFIG`` when the package is imported, before any
cuBLAS call of the process. A container carries the fingerprint of the
stack that wrote it, so a decoder on another stack fails loudly.
"""

from __future__ import annotations

import contextlib
import zlib

import numpy as np
import torch

from ..coder.vector import _decode_step, _encode_scan, rans_decode_init
from ..models.transformer import LMConfig, Transformer, forward, init_cache
from ..ops.quantize import cdf_from_freq, gather_intervals, quantize_logits

__all__ = [
    "GROW_BUCKET",
    "lm_encode",
    "lm_decode",
    "lm_encode_windowed",
    "lm_decode_windowed",
    "lm_fingerprint",
    "stack_tag",
]

GROW_BUCKET = 128
_SLIDE_SEG = 512  # lac_tpu's float slide segment (lm_engine.py:483); A6 runs it


@contextlib.contextmanager
def _coding(device: torch.device):
    """Inference mode (no autograd records, the least dispatch work an op);
    on CUDA, deterministic algorithms, and no TF32 or reduced-precision
    bf16 reductions in the products, for the duration of a coding call (the
    process's settings come back after it). Deterministic mode would also
    fill every new tensor before use, a kernel an allocation; no coding op
    reads memory it has not written (caches start as zeros), so the fill is
    off."""
    with torch.inference_mode():
        if device.type != "cuda":
            yield
            return
        m, d = torch.backends.cuda.matmul, torch.utils.deterministic
        saved = (torch.are_deterministic_algorithms_enabled(), m.allow_tf32,
                 m.allow_bf16_reduced_precision_reduction, d.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True)
        m.allow_tf32 = False
        m.allow_bf16_reduced_precision_reduction = False
        d.fill_uninitialized_memory = False
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(saved[0])
            m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved[1:3]
            d.fill_uninitialized_memory = saved[3]


def _device(params: Transformer) -> torch.device:
    return params.embed.device


def _bos(cfg: LMConfig, b: int, device) -> torch.Tensor:
    return torch.full((b,), cfg.bos_id, dtype=torch.int64, device=device)


def _step_cdf(cfg: LMConfig, params: Transformer, cache: dict, prev: torch.Tensor,
              prob_bits: int):
    """One lock-step model step: prev tokens [B] -> (cdf [B, V+1], cache)."""
    logits, cache = forward(cfg, params, prev[:, None], cache)
    return cdf_from_freq(quantize_logits(logits[:, 0, :], prob_bits)), cache


def _seg_intervals(cfg: LMConfig, params: Transformer, cache: dict, prev: torch.Tensor,
                   tokens_seg: torch.Tensor, prob_bits: int):
    """``steps`` single-token steps over tokens_seg [B, steps]; returns
    (cache, prev, cdf_lo [B, steps], freq [B, steps])."""
    los, fs = [], []
    for t in range(tokens_seg.shape[1]):
        cdf, cache = _step_cdf(cfg, params, cache, prev, prob_bits)
        prev = tokens_seg[:, t]
        lo, f = gather_intervals(cdf, prev)
        los.append(lo)
        fs.append(f)
    return cache, prev, torch.stack(los, dim=1), torch.stack(fs, dim=1)


def _seg_decode(cfg: LMConfig, params: Transformer, cache: dict, prev: torch.Tensor,
                rstate, prob_bits: int, steps: int, t0: int, lengths: torch.Tensor):
    """``steps`` decode steps from position ``t0``; returns (cache, prev,
    rstate, syms [B, steps])."""
    syms = []
    for i in range(steps):
        cdf, cache = _step_cdf(cfg, params, cache, prev, prob_bits)
        prev, rstate = _decode_step(rstate, cdf, prob_bits, (t0 + i) < lengths)
        syms.append(prev)
    return cache, prev, rstate, torch.stack(syms, dim=1)


def _first_width(t_len: int, bucket: int) -> int:
    """The cache's first width: one bucket, or without growth the block
    rounded up to 128 (the reference's fixed width)."""
    return bucket or -(-t_len // 128) * 128


# --------------------------------------------------------------------------
# Growing-cache schedule (``cache_grow`` = bucket size, 0 = fixed width).
#
# Every step reads the WHOLE cache, so the schedule starts it one bucket
# wide and re-allocates it +bucket at bucket boundaries (one copy each).
# The schedule is a pure function of (t_len, bucket), so encoder and
# decoder replay identical computations; the container records the bucket
# (``cache_grow``) and the fingerprint folds it in.
# --------------------------------------------------------------------------


def _grow_cache(cfg: LMConfig, cache: dict, new_w: int) -> dict:
    """A cache ``new_w`` wide holding ``cache``'s entries at the front."""
    k = cache["k"]
    grown = init_cache(cfg, k.shape[1], new_w, device=k.device)
    for key in ("k", "v"):
        grown[key][:, :, : k.shape[2]] = cache[key]
    grown["pos"] = cache["pos"]
    return grown


def _check_grow(cache_grow: int) -> None:
    if cache_grow < 0:
        raise ValueError(f"cache_grow must be >= 0, got {cache_grow}")


def _grown_segments(t_len: int, bucket: int):
    """[(start, steps, width)] covering [0, t_len) in bucket strides.
    bucket=0 means no growth: one segment at width None (= current cache)."""
    if not bucket:
        return [(0, t_len, None)]
    segs = []
    for i in range(0, t_len, bucket):
        steps = min(bucket, t_len - i)
        segs.append((i, steps, -(-(i + steps) // bucket) * bucket))
    return segs


def _run_grown(cfg: LMConfig, cache: dict, carry, t_len: int, bucket: int, step):
    """Drive the growing-cache schedule: grow the cache to each segment's
    width, then ``step(cache, carry, i, steps) -> (cache, carry)``.

    This is the ONE owner of the grow-loop geometry for both sides: the
    schedule IS the bitstream, so an encoder copy and a decoder copy that
    could drift apart would be a corruption hazard, not a style issue."""
    for i, steps, w in _grown_segments(t_len, bucket):
        if w is not None and cache["k"].shape[2] < w:
            cache = _grow_cache(cfg, cache, w)
        cache, carry = step(cache, carry, i, steps)
    return cache, carry


def _encode_intervals(cfg: LMConfig, params: Transformer, tokens: torch.Tensor,
                      prob_bits: int, bucket: int):
    """All positions' (cdf_lo, freq) under the cache schedule of ``bucket``
    (0: one fixed width)."""
    b, t_len = tokens.shape
    los, fs = [], []

    def step(cache, prev, i, steps):
        cache, prev, lo, f = _seg_intervals(cfg, params, cache, prev,
                                            tokens[:, i : i + steps], prob_bits)
        los.append(lo)
        fs.append(f)
        return cache, prev

    cache = init_cache(cfg, b, _first_width(t_len, bucket), device=tokens.device)
    _run_grown(cfg, cache, _bos(cfg, b, tokens.device), t_len, bucket, step)
    return torch.cat(los, dim=1), torch.cat(fs, dim=1)


def _decode_scan(cfg: LMConfig, params: Transformer, words: torch.Tensor,
                 lengths: torch.Tensor, prob_bits: int, t_len: int, bucket: int):
    """The symbols [B, t_len] under the cache schedule of ``bucket``."""
    b = words.shape[0]
    outs = []

    def step(cache, carry, i, steps):
        prev, rstate = carry
        cache, prev, rstate, syms = _seg_decode(cfg, params, cache, prev, rstate,
                                                prob_bits, steps, i, lengths)
        outs.append(syms)
        return cache, (prev, rstate)

    cache = init_cache(cfg, b, _first_width(t_len, bucket), device=words.device)
    carry = (_bos(cfg, b, words.device), rans_decode_init(words))
    _run_grown(cfg, cache, carry, t_len, bucket, step)
    return torch.cat(outs, dim=1)


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def lm_encode(cfg: LMConfig, params: Transformer, tokens, lengths, prob_bits: int,
              cache_grow: int = 0):
    """Encode B lanes of tokens ([B, T], T <= cfg.max_seq; the model state
    resets per lane). Returns (words [B, T+2] int64 u32 values in decode
    order, nwords [B] int64) on the parameters' device. ``cache_grow``: the
    growing-cache bucket (0 = fixed width); the decoder must use the same
    value (the container records it)."""
    _check_grow(cache_grow)
    dev = _device(params)
    tokens = _as_tensor(tokens, torch.int64, dev)
    lengths = _as_tensor(lengths, torch.int64, dev)
    if tokens.shape[1] > cfg.max_seq:
        raise ValueError(f"block tokens {tokens.shape[1]} > context {cfg.max_seq}")
    with _coding(dev):
        lo, f = _encode_intervals(cfg, params, tokens, prob_bits, cache_grow)
        return _encode_scan(lo, f, lengths, prob_bits, tokens.shape[1] + 2)


def lm_decode(cfg: LMConfig, params: Transformer, words, lengths, prob_bits: int,
              t_len: int, cache_grow: int = 0) -> torch.Tensor:
    """Decode B lanes of ``t_len`` positions from their words ([B, cap], in
    decode order); returns the symbols [B, t_len] int64 (0 past a lane's
    length) on the parameters' device."""
    _check_grow(cache_grow)
    dev = _device(params)
    words = _as_tensor(words, torch.int64, dev)
    lengths = _as_tensor(lengths, torch.int64, dev)
    if t_len > cfg.max_seq:
        raise ValueError(f"block tokens {t_len} > context {cfg.max_seq}")
    with _coding(dev):
        return _decode_scan(cfg, params, words, lengths, prob_bits, t_len, cache_grow)


def _windowed_not_ported(t_len: int, cfg: LMConfig) -> NotImplementedError:
    return NotImplementedError(
        f"a block of {t_len} tokens is longer than the model context {cfg.max_seq}: "
        "the windowed schedules (slide, reprime) are not ported to lac_tpu_torch "
        "yet (ROADMAP A6)")


def lm_encode_windowed(cfg: LMConfig, params: Transformer, tokens, lengths, prob_bits: int,
                       overlap: int = 2, cache_grow: int = 0, mode: str = "reprime",
                       slide_seg: int = 0):
    """``lm_encode`` for blocks within the model context; a longer block
    needs the windowed schedules (``mode``, ``overlap``, ``slide_seg``),
    ROADMAP A6, and raises."""
    if tokens.shape[1] > cfg.max_seq:
        raise _windowed_not_ported(tokens.shape[1], cfg)
    return lm_encode(cfg, params, tokens, lengths, prob_bits, cache_grow)


def lm_decode_windowed(cfg: LMConfig, params: Transformer, words, lengths, prob_bits: int,
                       t_len: int, overlap: int = 2, cache_grow: int = 0,
                       mode: str = "reprime", slide_seg: int = 0) -> torch.Tensor:
    """``lm_decode`` for blocks within the model context (A6 above it)."""
    if t_len > cfg.max_seq:
        raise _windowed_not_ported(t_len, cfg)
    return lm_decode(cfg, params, words, lengths, prob_bits, t_len, cache_grow)


def stack_tag(device: torch.device) -> str:
    """The package and the device kind: the CUDA device's name, or "cpu"."""
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return f"lac_tpu_torch:{kind}"


def lm_fingerprint(cfg: LMConfig, params: Transformer, prob_bits: int, cache_grow: int = 0,
                   slide_seg: int = 0) -> int:
    """Determinism fingerprint stored in the container: the crc32 of the
    quantized CDF of a fixed probe (the BOS step from an empty cache of
    ``cfg.max_seq`` slots, batch 1), with ``cache_grow`` and ``slide_seg``
    folded in as ``lac_tpu`` folds them, and then this stack's tag
    (``stack_tag``).

    The probe is one batch-1 step and can collide across stacks; the tag
    makes every float container of another stack or device kind fail the
    gate every time: ``lac_tpu``'s in the port, the port's in ``lac_tpu``,
    and the port's CPU containers on the card. Whether det8 containers can
    be identical across the stacks is ROADMAP A8's question; its tag
    belongs there."""
    dev = _device(params)
    cache = init_cache(cfg, 1, device=dev)
    with _coding(dev):
        cdf, _ = _step_cdf(cfg, params, cache, _bos(cfg, 1, dev), prob_bits)
    crc = zlib.crc32(cdf.cpu().numpy().astype("<i4").tobytes())
    if cache_grow:
        crc = zlib.crc32(f"cache_grow={cache_grow}".encode(), crc)
    if slide_seg:
        crc = zlib.crc32(f"slide_seg={slide_seg}".encode(), crc)
    return zlib.crc32(stack_tag(dev).encode(), crc)

"""LM coding engine: lock-step batched encode and decode with a transformer.

Ports ``lac_tpu/runtime/lm_engine.py``: the fixed-width and growing-cache
schedules (``GROW_BUCKET``, ``_grow_cache``, ``_check_grow``,
``_grown_segments``, ``_run_grown`` :173-263; the fixed width of
``_encode_intervals`` :49-68 and ``_decode_scan`` :265-286 is the
schedule's one segment at bucket 0), ``lm_encode`` and ``lm_decode``
(:289-326), the windowed schedules for blocks longer than the model
context (ROADMAP A6): ``window_schedule`` (:339-358), ``_reprime_cdf``
(:374-383), ``_slide_cfg`` (:385-394), slide mode, the ring cache, with a
``slide_seg`` (``_encode_intervals_slide_seg`` :518-536,
``_decode_scan_slide_seg`` :486-516) or without (one ring-width scan,
:441-444, :590-591), reprime mode with growth in the first window only
when ``max_seq % cache_grow == 0`` (:445-478, :592-623), and
``lm_encode_windowed`` / ``lm_decode_windowed`` (:396-478, :556-623);
and ``lm_fingerprint`` (:629-672). The int8 modes (kv8, w8) and det8 run
on every schedule: each coding call quantizes a float model once on entry
(``ensure_quantized``: ``ensure_w8``, as the reference's :297, :315, :419,
:563, :644, and det8's weights, which the reference quantizes in every
step), and ``_grow_cache`` copies every buffer of the cache, kv8's scales
too.

det8's encoder runs the chunked encode (``step_graph.SegChunks``, the
reference's ``_seg_intervals_chunked`` and ``_seg_intervals_any``,
:88-128, :221-226) on every schedule: 128 positions a forward, split at
the schedule's growth and re-prime boundaries and, under slide, at the
ring's, on the decoder's cache widths, so the softmax cap ``2 * W`` is the
same on both sides. The decoder steps serially, as for the float path.
``lac_tpu`` decodes det8's slide in 512-step segments only to avoid a TPU
worker fault (:482-516); here every ring step is the same replay, so no
segment is needed, and the bits would not move if there were one.

One function, ``_schedule``, walks every schedule for both directions. The
encoder and the decoder differ only in the runner they hand it
(``step_graph.SegIntervals`` or ``SegDecode``: what a step does with its
CDF), so the geometry (which positions run at which cache width, where a
re-prime prefills) has one owner: the schedule is the bitstream. A
re-prime prefills the kept tokens into the call's full-width cache (slots
past them hold older K/V, masked as a fresh cache's zeros are) and codes
the next position from the prefill's last logits; the decoder takes the
kept tokens from the symbols it has decoded, on the device. ``slide_seg``
bounds ``lac_tpu``'s compiled scans, which changes its float bits; here
every ring step is the same replay whatever the segment, so the value
changes no step. The container records it and the fingerprint folds it,
as in ``lac_tpu``.

Determinism contract (``lac_tpu/runtime/lm_engine.py:1-15``): the encoder
and the decoder run the SAME step, ``step_graph._step_cdf``, on the SAME
shapes (lanes, cache width) and the SAME schedule, one single-token
forward per position, lock-step across the lanes. Given the same weights,
stack and device, the float logits are then identical on both sides, so
the integer CDFs match bit for bit. On CUDA a step is a replay of a graph
captured per (lanes, cache width, direction), the first step at a width
eager on both sides (``step_graph``); no ``torch.compile``, since two
compiled programs may fuse the shared step differently (``lac_tpu``'s
hazard #5). The coding calls run under ``_coding``: deterministic
algorithms on, TF32 and reduced-precision bf16 reductions off;
``lac_tpu_torch/__init__.py`` sets ``CUBLAS_WORKSPACE_CONFIG`` when the
package is imported, before any cuBLAS call of the process. A container
carries the fingerprint of the stack that wrote it, so a decoder on
another stack fails loudly. det8's results do not depend on the device
(``models/transformer.py``), so its fingerprint names the package, not the
device: a det8 container decodes on the CPU and on the card alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib

import torch

from ..coder.vector import _encode_scan
from ..metrics import span
from ..models.transformer import (LMConfig, Transformer, ensure_quantized, forward, init_cache,
                                  kv_heads)
from ..ops.quantize import cdf_from_freq, quantize_logits
from ..ops.step_attention import takes_step
from ..utils.device import as_lanes
from .step_graph import SegChunks, SegDecode, SegIntervals, _Runner, _step_cdf

__all__ = [
    "GROW_BUCKET",
    "lm_encode",
    "lm_decode",
    "lm_encode_windowed",
    "lm_decode_windowed",
    "lm_fingerprint",
    "stack_tag",
    "window_schedule",
]

GROW_BUCKET = 128
# the card's float step attention (ops/step_attention.py), folded into the
# fingerprint (lm_fingerprint)
_STEP_ATTN_TAG = b"lac_tpu_torch:step_attn"
_SLIDE_SEG = 512  # lac_tpu's float slide segment (lm_engine.py:483)


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
    """A cache ``new_w`` wide holding every buffer of ``cache`` (``k`` and
    ``v``, and kv8's ``ks`` and ``vs``) at the front, and its ``pos``
    tensor."""
    with span("lac.engine.grow", width=new_w):
        k = cache["k"]
        grown = init_cache(cfg, k.shape[1], new_w, device=k.device, kv_heads=k.shape[3])
        for key, val in cache.items():
            if key != "pos":
                grown[key][:, :, : k.shape[2]] = val
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


def _run_grown(cfg: LMConfig, cache: dict, t_len: int, bucket: int, run: _Runner) -> dict:
    """Drive the growing-cache schedule: grow the cache to each segment's
    width, then run the segment's steps; returns the last cache.

    This is the ONE owner of the grow-loop geometry for both sides: the
    schedule IS the bitstream, so an encoder copy and a decoder copy that
    could drift apart would be a corruption hazard, not a style issue."""
    for _, steps, w in _grown_segments(t_len, bucket):
        if w is not None and cache["k"].shape[2] < w:
            cache = _grow_cache(cfg, cache, w)
        run.steps(cache, steps)
    return cache


# --------------------------------------------------------------------------
# Windowed schedules: blocks longer than the model context.
#
# reprime (the reference llama_compress.py:31-39 semantics): when the cache
# fills, keep the most recent ``window - window // overlap`` tokens, prefill
# them into the cache (positions re-based to 0..keep-1) and step on; the
# prefill's last logits code the next token. slide: one ``max_seq``-wide
# ring with global RoPE positions (LMConfig.slide), no prefill, the full
# window of context at every token. Both schedules depend only on (t_len,
# window, overlap, bucket), so the two sides replay the same computations.
# --------------------------------------------------------------------------


def window_schedule(t_len: int, window: int, overlap: int = 2):
    """Segments of the windowed run: ([(t0, steps, reprime_before)], keep)."""
    keep = window - window // overlap
    if keep < 1 or keep >= window:
        raise ValueError(f"bad window/overlap: {window}/{overlap}")
    segs = []
    pos = 0
    first = True
    while pos < t_len:
        if first:
            steps = min(window, t_len - pos)
            segs.append((pos, steps, False))
            first = False
        else:
            # re-prime codes 1 token; then step the rest of the refilled room
            steps = min(window - keep, t_len - pos)
            segs.append((pos, steps, True))
        pos += steps
    return segs, keep


def _reprime_cdf(cfg: LMConfig, params: Transformer, kept: torch.Tensor, prob_bits: int,
                 cache: dict):
    """Prefill the kept tokens [B, keep] into ``cache`` (K/V at 0..keep-1,
    ``pos`` keep); returns (the CDF of the next token, cache)."""
    logits, cache = forward(cfg, params, kept, cache, prefill=True)
    return cdf_from_freq(quantize_logits(logits[:, -1, :], prob_bits, det=cfg.det8)), cache


def _slide_cfg(cfg: LMConfig, t_len: int = 0) -> LMConfig:
    """The ring-cache forward for coding past the context (LMConfig.slide);
    raises for learned positions (LMConfig.__post_init__). ``t_len`` sizes
    det8's RoPE tables, which the float path does not have."""
    return dataclasses.replace(cfg, slide=True, rope_positions=t_len if cfg.det8 else 0)


def _step_cfg(cfg: LMConfig, t_len: int, mode: str) -> LMConfig:
    """The forward a block's steps run: the ring past the context in slide
    mode, else ``cfg``."""
    if t_len <= cfg.max_seq:
        return cfg
    if mode == "slide":
        return _slide_cfg(cfg, t_len)
    if mode != "reprime":
        raise ValueError(f"unknown window mode: {mode!r}")
    return cfg


def _schedule(run: _Runner, t_len: int, bucket: int, overlap: int) -> None:
    """Run the block's ``t_len`` positions through ``run`` (its ``cfg`` from
    ``_step_cfg``): within the context the growing-cache schedule of
    ``bucket`` (0: one fixed width); past it the ring (slide) or the
    re-prime schedule of ``overlap``."""
    cfg, b, dev = run.cfg, run.lanes, run.device
    kvh = kv_heads(cfg, run.params)
    mode = ("grow" if bucket else "fixed") if t_len <= cfg.max_seq else (
        "slide" if cfg.slide else "reprime")
    with span("lac.engine.schedule", direction=run.direction, t_len=t_len, bucket=bucket,
              mode=mode):
        if t_len <= cfg.max_seq:
            cache = init_cache(cfg, b, _first_width(t_len, bucket), device=dev, kv_heads=kvh)
            _run_grown(cfg, cache, t_len, bucket, run)
            return
        if cfg.slide:  # the ring is max_seq wide from the first step: no growth
            run.steps(init_cache(cfg, b, device=dev, kv_heads=kvh), t_len)
            return
        segs, keep = window_schedule(t_len, cfg.max_seq, overlap)
        # growth in the first window only (a re-prime fills keep slots, so later
        # windows need the full width), and only where it ends on the window
        grow = bucket if (bucket and cfg.max_seq % bucket == 0) else 0
        cache = init_cache(cfg, b, grow or None, device=dev, kv_heads=kvh)
        for t0, steps, reprime in segs:
            if reprime:
                cdf, cache = _reprime_cdf(cfg, run.params, run.symbols[:, t0 - keep : t0],
                                          run.prob_bits, cache)
                run.code(cdf)
                t0, steps = t0 + 1, steps - 1
            cache = _run_grown(cfg, cache, steps, grow if t0 == 0 else 0, run)


def _encode(cfg: LMConfig, params: Transformer, tokens, lengths, prob_bits: int,
            cache_grow: int, mode: str, overlap: int):
    _check_grow(cache_grow)
    params = ensure_quantized(cfg, params)
    dev = _device(params)
    tokens = as_lanes(tokens, dev)
    lengths = as_lanes(lengths, dev)
    t_len = tokens.shape[1]
    with _coding(dev):
        runner = SegChunks if cfg.det8 else SegIntervals
        run = runner(_step_cfg(cfg, t_len, mode), params, prob_bits, tokens)
        _schedule(run, t_len, cache_grow, overlap)
        out = _encode_scan(run.lo, run.f, lengths, prob_bits, t_len + 2)
        run.release()
        return out


def _decode(cfg: LMConfig, params: Transformer, words, lengths, prob_bits: int, t_len: int,
            cache_grow: int, mode: str, overlap: int) -> torch.Tensor:
    _check_grow(cache_grow)
    params = ensure_quantized(cfg, params)
    dev = _device(params)
    words = as_lanes(words, dev)
    lengths = as_lanes(lengths, dev)
    with _coding(dev):
        run = SegDecode(_step_cfg(cfg, t_len, mode), params, prob_bits, words, lengths, t_len)
        _schedule(run, t_len, cache_grow, overlap)
        run.release()
        return run.symbols


def lm_encode(cfg: LMConfig, params: Transformer, tokens, lengths, prob_bits: int,
              cache_grow: int = 0):
    """Encode B lanes of tokens ([B, T], T <= cfg.max_seq; the model state
    resets per lane). Returns (words [B, T+2] int64 u32 values in decode
    order, nwords [B] int64) on the parameters' device. ``cache_grow``: the
    growing-cache bucket (0 = fixed width); the decoder must use the same
    value (the container records it)."""
    if tokens.shape[1] > cfg.max_seq:
        raise ValueError(f"block tokens {tokens.shape[1]} > context {cfg.max_seq}")
    return _encode(cfg, params, tokens, lengths, prob_bits, cache_grow, "reprime", 2)


def lm_decode(cfg: LMConfig, params: Transformer, words, lengths, prob_bits: int,
              t_len: int, cache_grow: int = 0) -> torch.Tensor:
    """Decode B lanes of ``t_len`` positions from their words ([B, cap], in
    decode order); returns the symbols [B, t_len] int64 (0 past a lane's
    length) on the parameters' device."""
    if t_len > cfg.max_seq:
        raise ValueError(f"block tokens {t_len} > context {cfg.max_seq}")
    return _decode(cfg, params, words, lengths, prob_bits, t_len, cache_grow, "reprime", 2)


def _check_slide_seg(slide_seg) -> None:
    """``slide_seg`` as the LM functions take it: an int >= 0, which changes
    no step of the port (module docstring); anything else is refused."""
    if isinstance(slide_seg, bool) or not isinstance(slide_seg, int) or slide_seg < 0:
        raise ValueError(f"slide_seg must be an int >= 0, got {slide_seg!r}")


def lm_encode_windowed(cfg: LMConfig, params: Transformer, tokens, lengths, prob_bits: int,
                       overlap: int = 2, cache_grow: int = 0, mode: str = "reprime",
                       slide_seg: int = 0):
    """``lm_encode`` for lanes of any length. Past the model context,
    ``mode`` picks the schedule: "reprime" re-primes the cache every
    ``window // overlap`` tokens, "slide" rings a ``cfg.max_seq`` cache with
    global RoPE positions (full-window context at every token; slide
    ignores ``cache_grow``). The mode and ``overlap`` are part of the
    bitstream's schedule: the container records them and the decoder must
    pass the same. ``slide_seg`` is ``lac_tpu``'s argument, checked
    (``_check_slide_seg``): it changes no step here (module docstring)."""
    _check_slide_seg(slide_seg)
    return _encode(cfg, params, tokens, lengths, prob_bits, cache_grow, mode, overlap)


def lm_decode_windowed(cfg: LMConfig, params: Transformer, words, lengths, prob_bits: int,
                       t_len: int, overlap: int = 2, cache_grow: int = 0,
                       mode: str = "reprime", slide_seg: int = 0) -> torch.Tensor:
    """``lm_decode`` for lanes of any length, under the encoder's schedule
    (``lm_encode_windowed``; ``slide_seg`` likewise checked, and no step)."""
    _check_slide_seg(slide_seg)
    return _decode(cfg, params, words, lengths, prob_bits, t_len, cache_grow, mode, overlap)


def stack_tag(device: torch.device) -> str:
    """The package and the device kind: the CUDA device's name, or "cpu"."""
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return f"lac_tpu_torch:{kind}"


def lm_fingerprint(cfg: LMConfig, params: Transformer, prob_bits: int, cache_grow: int = 0,
                   slide_seg: int = 0) -> int:
    """Determinism fingerprint stored in the container: the crc32 of the
    quantized CDF of a fixed probe (the BOS step from an empty cache of
    ``cfg.max_seq`` slots, batch 1, on the model ``ensure_quantized``
    gives), with ``cache_grow``, ``slide_seg`` and the int8 modes' tags
    (``w8v2``, ``kv8v2``) folded in as ``lac_tpu`` folds them, in its order,
    and then this stack's tag: ``stack_tag(device)``, or under det8
    ``lac_tpu_torch:det8``.

    The probe is one batch-1 step and can collide across stacks; the tag
    makes every float container of another stack or device kind fail the
    gate every time: ``lac_tpu``'s in the port, the port's in ``lac_tpu``,
    and the port's CPU containers on the card. det8 gives the same bits on
    the CPU and on the card, so its tag names no device; it still names
    the package, because ``lac_tpu``'s det8 differs from the port's in
    ``det_rsqrt`` (ROADMAP C), and each package refuses the other's det8
    containers. Last, a model whose steps take ``ops/step_attention.py``'s
    kernel (``takes_step``: a float cache on the card) folds
    ``_STEP_ATTN_TAG``: the kernel's sums change the logits' last bits, so
    a card container written by the earlier route (``_attend_float``'s f32
    copies) fails the gate rather than the decode. The probe itself cannot
    tell the routes apart: from an empty cache both give v."""
    params = ensure_quantized(cfg, params)
    dev = _device(params)
    with span("lac.engine.fingerprint"):
        cache = init_cache(cfg, 1, device=dev, kv_heads=kv_heads(cfg, params))
        with _coding(dev):
            bos = torch.full((1,), cfg.bos_id, dtype=torch.int64, device=dev)
            cdf, _ = _step_cdf(cfg, params, cache, bos, prob_bits)
        crc = zlib.crc32(cdf.cpu().numpy().astype("<i4").tobytes())
    if cache_grow:
        crc = zlib.crc32(f"cache_grow={cache_grow}".encode(), crc)
    if slide_seg:
        crc = zlib.crc32(f"slide_seg={slide_seg}".encode(), crc)
    if cfg.w8:
        crc = zlib.crc32(b"w8v2", crc)
    if cfg.kv8:  # the probe's empty cache never reaches the kv8 route
        crc = zlib.crc32(b"kv8v2", crc)
    tag = "lac_tpu_torch:det8" if cfg.det8 else stack_tag(dev)
    crc = zlib.crc32(tag.encode(), crc)
    if takes_step(cfg, dev):
        crc = zlib.crc32(_STEP_ATTN_TAG, crc)
    return crc

"""Distributed (multi-process) compress/decompress on top of the turbo and
LM paths.

Ports ``lac_tpu/runtime/dist.py``: ``_with_retry`` (:50-60),
``_encode_span`` (:63-107), ``compress_distributed`` (:110-152),
``lm_compress_distributed`` (:155-244), ``lm_decompress_distributed``
(:247-295) and ``decompress_distributed`` (:298-345). Every rank of the
process group (``parallel/distributed.py``: ``torchrun``, one rank per
device) makes the same call with the same input, codes its contiguous
span of blocks (``my_block_span``) on its device, and the per-block
payloads are gathered in block order (``allgather_blocks``), so every rank
returns the same container, and it equals the one-process container: a
block's bitstream depends on the block, the model and the wave shape, not
on the rank that coded it.

The byte codecs run the turbo kernels K1-K9 (``ops/rans_kernels.py``): a
span's blocks are one launch's lanes, with the reference's word cap
``block_size // 2 + 3``, raw fallback and codec gate (``*_decode_fits`` at
``turbo._decode_cap_bucket``'s cap: a nibble model the gate refuses is
recorded as order0c). The decoder sizes its grid to the span's longest
payload. The LM path runs ``lm_api.encode_lm_span`` /
``decode_lm_span`` with every forward mode and window schedule. With a
``mesh`` (which spans the process group) the mesh is the parallelism: the
span is the whole input, each ``data`` rank codes its share of each wave
and ``model`` shards the weights (``lm_api``); the header records the
geometry. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.transformer import ensure_quantized
from ..parallel.distributed import allgather_blocks, my_block_span, pack_block, unpack_block
from ..stream.container import (
    CODEC_RANS32,
    CODEC_RANS64,
    BlockEntry,
    ContainerHeader,
    read_container,
    write_container,
)
from ..utils.device import resolve_device
from .lm_api import (_cfg_for_det8, _lm_decode_setup, _mesh_geometry, _model_on, _prepare_mesh,
                     _resolve_slide_seg, _resolve_window_mode, auto_prob_bits, decode_lm_span,
                     encode_lm_span)
from .lm_engine import GROW_BUCKET, lm_fingerprint
from .turbo import _CODECS, _decode_cap_bucket

__all__ = [
    "compress_distributed",
    "decompress_distributed",
    "lm_compress_distributed",
    "lm_decompress_distributed",
]

_PB = 16
_RETRIES = 2


def _with_retry(fn, what: str):
    """Blocks are independent, so a span that fails is coded again from the
    start; after ``_RETRIES`` more tries the last error is raised."""
    last = None
    for _ in range(_RETRIES + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - re-raised after the retries
            last = e
    raise RuntimeError(f"{what} failed after {_RETRIES + 1} attempts") from last


def _local(fn, share, what: str):
    """``_with_retry(fn)`` for a rank's own span; on a mesh (``share``) the
    span's steps and gather are collectives, which one rank cannot redo
    alone, so ``fn`` runs once and a failure raises."""
    return fn() if share is not None else _with_retry(fn, what)


def _encode_span(arr: np.ndarray, start: int, end: int, block_size: int, rate: int,
                 model: str, dev: torch.device) -> list[tuple[int, int, bytes]]:
    """Encode blocks [start, end) of the byte array in one launch of
    ``model``'s fused encode; returns [(raw_len, token_count, payload)]."""
    nblk = end - start
    if nblk <= 0:
        return []
    syms = np.zeros((block_size, nblk), dtype=np.uint8)
    lengths = np.zeros((nblk,), dtype=np.int32)
    for j in range(nblk):
        chunk = arr[(start + j) * block_size : (start + j + 1) * block_size]
        syms[: len(chunk), j] = chunk
        lengths[j] = len(chunk)
    # the cap of turbo_compress: the raw fallback (on nwords, before any
    # slice) makes a lane that needs more than block_size // 2 words moot
    words_d, nwords_d = _CODECS[model][0](torch.from_numpy(syms).to(dev),
                                          torch.from_numpy(lengths).to(dev), rate,
                                          block_size // 2 + 3)
    words, nwords = words_d.cpu().numpy(), nwords_d.cpu().numpy()
    out = []
    for j in range(nblk):
        raw = syms[: lengths[j], j].tobytes()
        if 2 * int(nwords[j]) >= len(raw) and len(raw) > 0:
            out.append((int(lengths[j]), 0, raw))
        else:
            payload = words[j, : nwords[j]].astype(">u2").tobytes()
            out.append((int(lengths[j]), int(lengths[j]), payload))
    return out


def compress_distributed(data: bytes, block_size: int = 1024, rate: int = 4,
                         model: str = "order0n", device=None) -> bytes:
    """Every rank calls this with the same data; returns the container
    (the same on every rank, and ``turbo.turbo_compress``'s)."""
    if model not in _CODECS:
        raise ValueError("dist model must be order0c, order0n, order1n, or order2n")
    fits = _CODECS[model][2]
    if fits is not None and not fits(_decode_cap_bucket(block_size // 2 + 3, block_size),
                                     1 << 30):
        model = "order0c"  # the geometry fallback, as turbo_compress's
    dev = resolve_device(device)
    arr = np.frombuffer(data, dtype=np.uint8)
    nblocks = max(1, -(-len(data) // block_size))
    start, end = my_block_span(nblocks)
    mine = _with_retry(lambda: _encode_span(arr, start, end, block_size, rate, model, dev),
                       f"encode span [{start},{end})")
    gathered = allgather_blocks([pack_block(*t) for t in mine], nblocks)
    blocks = [BlockEntry(*unpack_block(b)) for b in gathered]
    header = ContainerHeader(
        codec=CODEC_RANS32,
        prob_bits=_PB,
        model_id=model,
        config={"block_size": block_size, "rate": rate},
        original_len=len(data),
    )
    return write_container(header, blocks)


def decompress_distributed(container: bytes, device=None) -> bytes:
    """Each rank decodes its span; the bytes are gathered in block order
    (the same result on every rank)."""
    header, blocks = read_container(container)
    if header.codec != CODEC_RANS32 or header.model_id not in _CODECS:
        raise ValueError(f"not a turbo {tuple(_CODECS)} container")
    block_size = header.config["block_size"]
    rate = header.config["rate"]
    dev = resolve_device(device)
    nblocks = len(blocks)
    start, end = my_block_span(nblocks)
    span = blocks[start:end]
    coded = [b for b in span if not (b.token_count == 0 and b.raw_len > 0)]
    syms = None
    if coded:
        # the grid's cap: the span's longest coded payload's bucket
        cap = _decode_cap_bucket(max(len(b.payload) for b in coded) // 2, block_size)
        words = np.zeros((len(coded), cap), dtype=np.uint16)
        lengths = np.zeros((len(coded),), dtype=np.int32)
        for j, blk in enumerate(coded):
            w = np.frombuffer(blk.payload, dtype=">u2")
            words[j, : len(w)] = w
            lengths[j] = blk.token_count
        decode = _CODECS[header.model_id][1]
        syms = _with_retry(
            lambda: decode(torch.from_numpy(words).to(dev), torch.from_numpy(lengths).to(dev),
                           block_size, rate).cpu().numpy(),
            f"decode span [{start},{end})")
    outs: list[bytes] = []
    ci = 0
    for blk in span:
        if blk.token_count == 0 and blk.raw_len > 0:
            outs.append(blk.payload)
        else:
            outs.append(syms[: blk.token_count, ci].tobytes())
            ci += 1
    out = b"".join(allgather_blocks(outs, nblocks))
    if len(out) != header.original_len:
        raise ValueError("decoded length mismatch")
    return out


def lm_compress_distributed(
    data: bytes,
    model_ref: str = "prng:tiny:0",
    block_tokens: int = 512,
    lanes: int = 64,
    prob_bits: int = 16,
    overlap: int = 2,
    max_seq: int | None = None,
    model=None,
    mesh=None,
    det8: bool = False,
    kv8: bool = False,
    w8: bool = False,
    cache_grow: int | None = None,
    window_mode: str = "reprime",
    slide_seg: int | None = None,
    device=None,
) -> bytes:
    """LM compression over the process group: every rank codes its span of
    blocks (with a ``mesh``, the mesh codes every block: module docstring),
    the payloads are gathered in block order, and the container, the same
    on every rank, equals ``lm_api.lm_compress_bytes``'s with the same
    arguments."""
    if cache_grow is None:
        cache_grow = GROW_BUCKET
    dev = resolve_device(device)
    cfg, params = _model_on(model, model_ref, max_seq, dev)
    cfg = _cfg_for_det8(cfg, det8, kv8=kv8, w8=w8)
    params = ensure_quantized(cfg, params)
    window_mode = _resolve_window_mode(window_mode, cfg)
    slide_seg = _resolve_slide_seg(slide_seg, window_mode, cfg, block_tokens)
    if cfg.vocab < 256:
        raise ValueError("byte-level coding needs vocab >= 256")
    prob_bits = auto_prob_bits(cfg, prob_bits)
    params, share = _prepare_mesh(mesh, cfg, params, lanes)
    fingerprint = lm_fingerprint(cfg, params, prob_bits, cache_grow, slide_seg)
    n = len(data)
    nblocks = max(1, -(-n // block_tokens))
    start, end = (0, nblocks) if mesh is not None else my_block_span(nblocks)
    mine = _local(
        lambda: encode_lm_span(cfg, params, data, start, end, block_tokens, lanes, prob_bits,
                               overlap, cache_grow=cache_grow, window_mode=window_mode,
                               slide_seg=slide_seg, share=share),
        share, f"lm encode span [{start},{end})")
    if mesh is None:  # the mesh's ranks gathered over data in encode_lm_span
        mine = [unpack_block(b) for b in allgather_blocks([pack_block(*t) for t in mine],
                                                          nblocks)]
    blocks = [BlockEntry(*t) for t in mine]
    header = ContainerHeader(
        codec=CODEC_RANS64,
        prob_bits=prob_bits,
        model_id="lm",
        config={
            "model_ref": model_ref,
            "max_seq": cfg.max_seq,
            "block_tokens": block_tokens,
            "lanes": lanes,
            "overlap": overlap,
            "fingerprint": fingerprint,
            "mesh": _mesh_geometry(mesh),
            "det8": bool(cfg.det8),
            "kv8": bool(cfg.kv8),
            "w8": bool(cfg.w8),
            "cache_grow": int(cache_grow),
            "window_mode": window_mode,
            "slide_seg": int(slide_seg),
        },
        original_len=n,
    )
    return write_container(header, blocks)


def lm_decompress_distributed(container: bytes, model=None, mesh=None, device=None) -> bytes:
    """Each rank decodes its span of blocks; the bytes are gathered in
    order (the same result on every rank). The container's mesh is rebuilt
    or checked as in ``lm_api.lm_decompress_bytes`` (a float container
    replays its encode geometry; a det8 one decodes on any)."""
    header, blocks = read_container(container)
    c = header.config
    cfg, params, share = _lm_decode_setup(header, model, mesh, resolve_device(device))
    nblocks = len(blocks)
    start, end = (0, nblocks) if share is not None else my_block_span(nblocks)
    outs = _local(
        lambda: decode_lm_span(cfg, params, blocks, start, end, c["block_tokens"], c["lanes"],
                               header.prob_bits, c["overlap"],
                               cache_grow=int(c.get("cache_grow", 0)),
                               window_mode=c.get("window_mode", "reprime"),
                               slide_seg=int(c.get("slide_seg", 0)), share=share),
        share, f"lm decode span [{start},{end})")
    out = b"".join(outs if share is not None else allgather_blocks(outs, nblocks))
    if len(out) != header.original_len:
        raise ValueError("decoded length mismatch")
    return out

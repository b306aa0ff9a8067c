"""LM compression file API: bytes -> .lac container with an LM predictor.

Ports the byte alphabet of ``lac_tpu/runtime/lm_api.py``:
``_cfg_for_det8`` (:116-141), ``_resolve_window_mode`` (:143-160),
``lm_compress_bytes`` (:163-245), ``_resolve_slide_seg`` (:248-258),
``_lm_decode_setup`` (:261-285), ``lm_decompress_bytes`` (:288-304),
``lm_decompress_prefix`` (:307-346), ``auto_prob_bits`` (:492-498),
``encode_lm_span`` and ``decode_lm_span`` (:501-613). The bytes are the
tokens (a byte-level LM, vocab >= 256), split into blocks of
``block_tokens`` coded in lock-step waves of exactly ``lanes`` streams
(the wave shape is part of the determinism contract and travels in the
container). A block longer than the model context runs the windowed
schedule that ``window_mode`` names (``runtime/lm_engine.py``). The
container config holds the same keys as ``lac_tpu``'s.

The kv8 and w8 forwards code through every call (``kv8``, ``w8``; the
header records them, and a decoder resolves the container's modes). Not
ported, and raising with the ROADMAP item that ports them: the det8
forward (A8), a ``mesh`` (A13); the token alphabet and text front-end
are A9. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..coder.rans import encode_capacity
from ..models.lm_registry import resolve_lm
from ..models.transformer import LMConfig, Transformer, ensure_w8
from ..stream.container import (CODEC_RANS64, BlockEntry, ContainerHeader, read_container,
                                scan_container, write_container)
from ..utils.device import resolve_device
from .lm_engine import (_SLIDE_SEG, GROW_BUCKET, lm_decode_windowed, lm_encode_windowed,
                        lm_fingerprint)

__all__ = [
    "lm_compress_bytes",
    "lm_decompress_bytes",
    "lm_decompress_prefix",
    "encode_lm_span",
    "decode_lm_span",
    "auto_prob_bits",
]

def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "LM coding on a device mesh is not ported to lac_tpu_torch yet (ROADMAP A13)")


def _cfg_for_det8(cfg: LMConfig, det8: bool, decoding: bool = False, kv8: bool = False,
                  w8: bool = False) -> LMConfig:
    """The forward-mode handshake (the reference's, :116-141): det8 with
    kv8 or w8 is refused; a requested mode upgrades ``cfg``; at decode, a
    model resolved with a mode the container lacks is refused, naming the
    mode. det8 then raises, naming ROADMAP A8."""
    if det8 and (kv8 or w8):
        raise ValueError("det8 is mutually exclusive with kv8/w8 forward modes")
    for name, want in (("det8", det8), ("kv8", kv8), ("w8", w8)):
        have = getattr(cfg, name)
        if want and not have:
            cfg = dataclasses.replace(cfg, **{name: True})
        elif decoding and have and not want:
            raise ValueError(
                f"container was encoded WITHOUT {name} but the model was resolved with "
                f"{name}=True: the forward modes produce different bitstreams; re-resolve "
                f"the model without {name}")
    if cfg.det8:
        what = "a container coded with" if decoding else "coding with"
        raise NotImplementedError(
            f"{what} the det8 forward is not ported to lac_tpu_torch yet (ROADMAP A8)")
    return cfg


def _resolve_window_mode(window_mode: str, cfg: LMConfig) -> str:
    """"auto" -> slide for rope models, reprime for learned positions; the
    container records the resolved mode, never "auto"."""
    if window_mode != "auto":
        return window_mode
    return "slide" if cfg.pos_embedding == "rope" else "reprime"


def _resolve_slide_seg(slide_seg: int | None, window_mode: str, cfg: LMConfig,
                       block_tokens: int) -> int:
    """The float slide segment length: the engine default when the float
    slide path runs windowed, else 0; an explicit value passes through."""
    if slide_seg is not None:
        return int(slide_seg)
    if window_mode == "slide" and not cfg.det8 and block_tokens > cfg.max_seq:
        return _SLIDE_SEG
    return 0


def auto_prob_bits(cfg: LMConfig, prob_bits: int) -> int:
    """Raise prob_bits until 2**pb >= 2 * vocab (every symbol >= 1 count,
    half the budget left for the distribution); the header records it."""
    while (1 << prob_bits) < 2 * cfg.vocab:
        prob_bits += 1
    return prob_bits


def _model_on(model, model_ref: str, max_seq, dev: torch.device):
    """(cfg, params) on ``dev``: a pre-resolved model must already be there."""
    if model is None:
        return resolve_lm(model_ref, max_seq, device=dev)
    cfg, params = model
    have = params.embed.device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the model's parameters are on {have}, the call asks for {dev}")
    return cfg, params


def lm_compress_bytes(
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
    cache_grow: int = GROW_BUCKET,
    window_mode: str = "reprime",
    slide_seg: int | None = None,
    device=None,
) -> bytes:
    """Compress ``data`` with an LM predictor. ``model``: an optional
    pre-resolved (cfg, params) on ``device``, used instead of resolving
    ``model_ref`` (which the container still records). ``cache_grow``: the
    KV-cache growth bucket (0 = fixed width; slide ignores it past the
    context). ``window_mode`` ("reprime", "slide" or "auto": slide for rope
    models) picks the schedule of blocks longer than the model context.
    ``slide_seg`` (None: 512 for slide past the context) bounds
    ``lac_tpu``'s compiled scans and changes no step here. Both resolve and
    are recorded as in ``lac_tpu`` (the fingerprint folds ``slide_seg``),
    and the decoder replays the recorded mode. ``kv8`` and ``w8`` code with
    the int8 KV cache and the int8 weights (``models/transformer.py``;
    the model is quantized once for the call); ``det8`` raises (A8)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    cfg, params = _model_on(model, model_ref, max_seq, dev)
    cfg = _cfg_for_det8(cfg, det8, kv8=kv8, w8=w8)
    params = ensure_w8(cfg, params)  # once for the call, not once a wave
    window_mode = _resolve_window_mode(window_mode, cfg)
    slide_seg = _resolve_slide_seg(slide_seg, window_mode, cfg, block_tokens)
    if cfg.vocab < 256:
        raise ValueError("byte-level coding needs vocab >= 256")
    prob_bits = auto_prob_bits(cfg, prob_bits)
    n = len(data)
    nblocks = max(1, -(-n // block_tokens))
    fingerprint = lm_fingerprint(cfg, params, prob_bits, cache_grow, slide_seg)
    blocks = [
        BlockEntry(*t)
        for t in encode_lm_span(cfg, params, data, 0, nblocks, block_tokens, lanes,
                                prob_bits, overlap, cache_grow=cache_grow,
                                window_mode=window_mode)
    ]
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
            "mesh": None,
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


def _lm_decode_setup(header: ContainerHeader, model, mesh, dev: torch.device):
    """Decode-side setup (byte alphabet): resolve the model, check the
    forward mode and the fingerprint against the container's config."""
    _no_mesh(mesh)
    c = header.config
    if header.model_id != "lm" or header.codec != CODEC_RANS64:
        raise ValueError("not an LM container")
    if c.get("alphabet", "bytes") != "bytes":
        raise ValueError("container holds a token-alphabet stream; lm_decompress_tokens "
                         "is not ported to lac_tpu_torch yet (ROADMAP A9)")
    if c.get("mesh") is not None and not c.get("det8"):
        raise NotImplementedError(
            f"the container was coded on a {c['mesh']} mesh; meshes are not ported to "
            "lac_tpu_torch yet (ROADMAP A13)")
    cfg, params = _model_on(model, c["model_ref"], c["max_seq"], dev)
    cfg = _cfg_for_det8(cfg, bool(c.get("det8")), decoding=True, kv8=bool(c.get("kv8")),
                        w8=bool(c.get("w8")))
    params = ensure_w8(cfg, params)
    fp = lm_fingerprint(cfg, params, header.prob_bits, int(c.get("cache_grow", 0)),
                        int(c.get("slide_seg", 0)))
    if fp != c["fingerprint"]:
        raise ValueError(
            "model fingerprint mismatch: decoder weights/stack differ from the "
            f"encoder's (got {fp}, container has {c['fingerprint']})")
    return cfg, params


def _decode_blocks(cfg, params, header, blocks, ngood: int) -> bytes:
    c = header.config
    parts = decode_lm_span(
        cfg, params, blocks, 0, ngood, c["block_tokens"], c["lanes"], header.prob_bits,
        c["overlap"], cache_grow=int(c.get("cache_grow", 0)),
        window_mode=c.get("window_mode", "reprime"))
    return b"".join(parts)


def lm_decompress_bytes(container: bytes, model=None, mesh=None, device=None) -> bytes:
    header, blocks = read_container(container)
    cfg, params = _lm_decode_setup(header, model, mesh, resolve_device(device))
    out = _decode_blocks(cfg, params, header, blocks, len(blocks))
    if len(out) != header.original_len:
        raise ValueError("decoded length mismatch")
    return out


def lm_decompress_prefix(container: bytes, model=None, mesh=None, device=None):
    """Recover the good PREFIX of a truncated or corrupt LM container: every
    intact block before the first damaged one (blocks are independent
    streams with CRCs). Returns ``(bytes, report)``, report = {ok,
    recovered_blocks, total_blocks, bad_blocks, recovered_bytes,
    original_len}. Raises only when nothing is decodable (unparseable
    header, wrong model or fingerprint)."""
    header, blocks, bad = scan_container(container)
    cfg, params = _lm_decode_setup(header, model, mesh, resolve_device(device))
    ngood = bad[0] if bad else len(blocks)
    out = _decode_blocks(cfg, params, header, blocks, ngood) if ngood else b""
    report = {
        "ok": not bad and len(out) == header.original_len,
        "recovered_blocks": ngood,
        "total_blocks": len(blocks),
        "bad_blocks": bad,
        "recovered_bytes": len(out),
        "original_len": header.original_len,
    }
    return out, report


def encode_lm_span(cfg: LMConfig, params: Transformer, data: bytes, start: int, end: int,
                   block_tokens: int, lanes: int, prob_bits: int, overlap: int,
                   cache_grow: int = 0, window_mode: str = "reprime"):
    """Encode blocks [start, end) of ``data`` in fixed-shape waves of
    ``lanes`` on the parameters' device; returns ``[(raw_len, token_count,
    payload)]`` in block order (token_count 0 marks the raw fallback, taken
    when the words are no shorter than the bytes). One-wave pipeline: wave
    i+1 is dispatched before wave i's words are fetched (CUDA launches are
    asynchronous, so the card runs ahead while the host packs)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    dev = params.embed.device
    out: list[tuple[int, int, bytes]] = []

    def finish(w0: int, nb: int, words_d, nwords_d) -> None:
        words, nwords = words_d.cpu().numpy(), nwords_d.cpu().numpy()
        for j in range(nb):
            s0 = (w0 + j) * block_tokens
            length = min(block_tokens, n - s0)
            payload = words[j, : nwords[j]].astype(">u4").tobytes()
            if len(payload) >= length and length > 0:
                out.append((length, 0, bytes(data[s0 : s0 + length])))
            else:
                out.append((length, length, payload))

    pending = None
    for w0 in range(start, end, lanes):
        nb = min(lanes, end - w0)
        tokens = np.zeros((lanes, block_tokens), dtype=np.int64)
        lengths = np.zeros((lanes,), dtype=np.int64)
        for j in range(nb):
            chunk = arr[(w0 + j) * block_tokens : (w0 + j + 1) * block_tokens]
            tokens[j, : len(chunk)] = chunk
            lengths[j] = len(chunk)
        words_d, nwords_d = lm_encode_windowed(
            cfg, params, torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev),
            prob_bits, overlap, cache_grow, mode=window_mode)
        if pending is not None:
            finish(*pending)
        pending = (w0, nb, words_d, nwords_d)
    if pending is not None:
        finish(*pending)
    return out


def decode_lm_span(cfg: LMConfig, params: Transformer, blocks, start: int, end: int,
                   block_tokens: int, lanes: int, prob_bits: int, overlap: int,
                   cache_grow: int = 0, window_mode: str = "reprime") -> list[bytes]:
    """Decode container blocks [start, end); returns their bytes in block
    order (the same wave pipeline as the encoder)."""
    cap = encode_capacity(block_tokens)
    dev = params.embed.device
    parts: list[bytes] = [b""] * (end - start)

    def finish(w0: int, nb: int, syms_d) -> None:
        syms = None if syms_d is None else syms_d.cpu().numpy()
        for j in range(nb):
            blk = blocks[w0 + j]
            if blk.token_count == 0 and blk.raw_len > 0:
                parts[w0 + j - start] = blk.payload
            else:
                parts[w0 + j - start] = syms[j, : blk.token_count].astype(np.uint8).tobytes()

    pending = None
    for w0 in range(start, end, lanes):
        nb = min(lanes, end - w0)
        words = np.zeros((lanes, cap), dtype=np.int64)
        lengths = np.zeros((lanes,), dtype=np.int64)
        any_coded = False
        for j in range(nb):
            blk = blocks[w0 + j]
            if blk.token_count == 0 and blk.raw_len > 0:
                continue
            w = np.frombuffer(blk.payload, dtype=">u4")
            words[j, : len(w)] = w
            lengths[j] = blk.token_count
            any_coded = True
        syms_d = None
        if any_coded:
            syms_d = lm_decode_windowed(
                cfg, params, torch.from_numpy(words).to(dev), torch.from_numpy(lengths).to(dev),
                prob_bits, block_tokens, overlap, cache_grow, mode=window_mode)
        if pending is not None:
            finish(*pending)
        pending = (w0, nb, syms_d)
    if pending is not None:
        finish(*pending)
    return parts

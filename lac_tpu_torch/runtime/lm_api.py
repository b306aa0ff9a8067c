"""LM compression file API: bytes or token ids -> .lac container with an LM
predictor.

Ports ``lac_tpu/runtime/lm_api.py``: ``_cfg_for_det8`` (:116-141),
``_resolve_window_mode`` (:143-160), ``lm_compress_bytes`` (:163-245),
``_resolve_slide_seg`` (:248-258), ``_lm_decode_setup`` (:261-285),
``lm_decompress_bytes`` (:288-304), ``lm_decompress_prefix`` (:307-346),
the token alphabet, ``_raw_dtype`` (:348-355), ``lm_compress_tokens`` /
``lm_decompress_tokens`` (:357-470) and the text front-end
``lm_compress_text`` / ``lm_decompress_text`` (:473-490),
``auto_prob_bits`` (:492-498), ``encode_lm_span`` and ``decode_lm_span``
(:501-613). The symbols are the bytes (a byte-level LM, vocab >= 256) or
a 1-D array of model token ids (any vocab; ``original_len`` counts
tokens, and ``auto_prob_bits`` raises ``prob_bits`` until ``2**pb >= 2 *
vocab``: 18 for Llama-3's 128,256). They are split into blocks of
``block_tokens`` coded in lock-step waves of exactly ``lanes`` streams
(the wave shape is part of the determinism contract and travels in the
container). A block longer than the model context runs the windowed
schedule that ``window_mode`` names (``runtime/lm_engine.py``). A block
whose words are no shorter than its symbols is stored raw: the bytes, or
the ids as minimal-width big-endian integers (``>u1``, ``>u2`` or ``>u4``
by vocab). The container config holds the same keys as ``lac_tpu``'s; a
token container adds ``"alphabet": "tokens"`` and ``"vocab"``, and each
decoder refuses the other alphabet's containers, ``recover`` (through
``lm_decompress_prefix``) a token container, as the reference's.

The kv8, w8 and det8 forwards code through every call (``kv8``, ``w8``,
``det8``; the header records them, and a decoder resolves the container's
modes, as the reference's :272-274). A ``mesh`` raises, naming ROADMAP
A13. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..coder.rans import encode_capacity
from ..models.lm_registry import resolve_lm
from ..models.transformer import LMConfig, Transformer, ensure_quantized
from ..stream.container import (CODEC_RANS64, BlockEntry, ContainerHeader, read_container,
                                scan_container, write_container)
from ..utils.device import resolve_device
from .lm_engine import (_SLIDE_SEG, GROW_BUCKET, lm_decode_windowed, lm_encode_windowed,
                        lm_fingerprint)

__all__ = [
    "lm_compress_bytes",
    "lm_decompress_bytes",
    "lm_decompress_prefix",
    "lm_compress_tokens",
    "lm_decompress_tokens",
    "lm_compress_text",
    "lm_decompress_text",
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
    mode."""
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


def _raw_dtype(vocab: int) -> np.dtype:
    """Minimal big-endian id width for the token alphabet's raw fallback."""
    if vocab <= 1 << 8:
        return np.dtype(">u1")
    if vocab <= 1 << 16:
        return np.dtype(">u2")
    return np.dtype(">u4")


def _token_array(tokens, vocab: int) -> np.ndarray:
    """The ids as a 1-D int32 array in [0, vocab), with the reference's
    refusals."""
    arr = np.ascontiguousarray(tokens, dtype=np.int32)
    if arr.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() >= vocab):
        raise ValueError(f"token ids must be in [0, {vocab}); got [{arr.min()}, {arr.max()}]")
    return arr


def _compress(symbols, tokens: bool, model_ref: str, block_tokens: int, lanes: int,
              prob_bits: int, overlap: int, max_seq, model, mesh, det8: bool, kv8: bool,
              w8: bool, cache_grow: int, window_mode: str, slide_seg, device) -> bytes:
    """One owner of both alphabets' encode (``lm_compress_bytes`` and
    ``lm_compress_tokens``)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    cfg, params = _model_on(model, model_ref, max_seq, dev)
    cfg = _cfg_for_det8(cfg, det8, kv8=kv8, w8=w8)
    params = ensure_quantized(cfg, params)  # once for the call, not once a wave
    window_mode = _resolve_window_mode(window_mode, cfg)
    slide_seg = _resolve_slide_seg(slide_seg, window_mode, cfg, block_tokens)
    if tokens:
        symbols = _token_array(symbols, cfg.vocab)
    elif cfg.vocab < 256:
        raise ValueError("byte-level coding needs vocab >= 256")
    prob_bits = auto_prob_bits(cfg, prob_bits)
    n = len(symbols)
    nblocks = max(1, -(-n // block_tokens))
    fingerprint = lm_fingerprint(cfg, params, prob_bits, cache_grow, slide_seg)
    blocks = [
        BlockEntry(*t)
        for t in encode_lm_span(cfg, params, symbols, 0, nblocks, block_tokens, lanes,
                                prob_bits, overlap, cache_grow=cache_grow,
                                window_mode=window_mode)
    ]
    config = {
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
    }
    if tokens:
        config.update(alphabet="tokens", vocab=cfg.vocab)
    header = ContainerHeader(codec=CODEC_RANS64, prob_bits=prob_bits, model_id="lm",
                             config=config, original_len=n)
    return write_container(header, blocks)


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
    the int8 KV cache and the int8 weights, ``det8`` with the
    integer-reduction forward, whose containers are the same on the CPU and
    on the card (``models/transformer.py``; the model is quantized once for
    the call)."""
    return _compress(data, False, model_ref, block_tokens, lanes, prob_bits, overlap,
                     max_seq, model, mesh, det8, kv8, w8, cache_grow, window_mode,
                     slide_seg, device)


def lm_compress_tokens(
    tokens,
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
    """Compress a 1-D sequence of model token ids (the reference's flagship
    interface: a tokenizer's output) with the engine, schedule and
    container of ``lm_compress_bytes``, whose arguments these are; the
    alphabet is the model's vocabulary, ``original_len`` counts tokens, and
    a raw block stores minimal-width big-endian ids."""
    return _compress(tokens, True, model_ref, block_tokens, lanes, prob_bits, overlap,
                     max_seq, model, mesh, det8, kv8, w8, cache_grow, window_mode,
                     slide_seg, device)


def _lm_decode_setup(header: ContainerHeader, model, mesh, dev: torch.device,
                     alphabet: str = "bytes"):
    """Decode-side setup: refuse another alphabet's container, resolve the
    model, check the forward mode, the vocab (tokens) and the fingerprint
    against the container's config."""
    _no_mesh(mesh)
    c = header.config
    if header.model_id != "lm" or header.codec != CODEC_RANS64:
        raise ValueError("not an LM container")
    if c.get("alphabet", "bytes") != alphabet:
        if alphabet == "bytes":
            raise ValueError("container holds a token-alphabet stream; use "
                             "lm_decompress_tokens")
        raise ValueError("container holds a byte-alphabet stream; use lm_decompress_bytes")
    if c.get("mesh") is not None and not c.get("det8"):
        raise NotImplementedError(
            f"the container was coded on a {c['mesh']} mesh; meshes are not ported to "
            "lac_tpu_torch yet (ROADMAP A13)")
    cfg, params = _model_on(model, c["model_ref"], c["max_seq"], dev)
    cfg = _cfg_for_det8(cfg, bool(c.get("det8")), decoding=True, kv8=bool(c.get("kv8")),
                        w8=bool(c.get("w8")))
    if alphabet == "tokens" and cfg.vocab != c["vocab"]:
        raise ValueError(f"model vocab {cfg.vocab} != container vocab {c['vocab']}")
    params = ensure_quantized(cfg, params)
    fp = lm_fingerprint(cfg, params, header.prob_bits, int(c.get("cache_grow", 0)),
                        int(c.get("slide_seg", 0)))
    if fp != c["fingerprint"]:
        raise ValueError(
            "model fingerprint mismatch: decoder weights/stack differ from the "
            f"encoder's (got {fp}, container has {c['fingerprint']})")
    return cfg, params


def _decode_blocks(cfg, params, header, blocks, ngood: int, sym_dtype=np.uint8) -> bytes:
    c = header.config
    parts = decode_lm_span(
        cfg, params, blocks, 0, ngood, c["block_tokens"], c["lanes"], header.prob_bits,
        c["overlap"], sym_dtype=sym_dtype, cache_grow=int(c.get("cache_grow", 0)),
        window_mode=c.get("window_mode", "reprime"))
    return b"".join(parts)


def lm_decompress_bytes(container: bytes, model=None, mesh=None, device=None) -> bytes:
    header, blocks = read_container(container)
    cfg, params = _lm_decode_setup(header, model, mesh, resolve_device(device))
    out = _decode_blocks(cfg, params, header, blocks, len(blocks))
    if len(out) != header.original_len:
        raise ValueError("decoded length mismatch")
    return out


def lm_decompress_tokens(container: bytes, model=None, mesh=None, device=None) -> np.ndarray:
    """Inverse of ``lm_compress_tokens``: the int32 token id array."""
    header, blocks = read_container(container)
    cfg, params = _lm_decode_setup(header, model, mesh, resolve_device(device), "tokens")
    rdt = _raw_dtype(cfg.vocab)
    out = np.frombuffer(_decode_blocks(cfg, params, header, blocks, len(blocks), rdt),
                        dtype=rdt).astype(np.int32)
    if out.size != header.original_len:
        raise ValueError("decoded length mismatch")
    return out


def lm_compress_text(text: str, tokenizer, **kw) -> bytes:
    """Tokenizer front-end (duck-typed: ``encode(str) -> ids``,
    ``decode(ids) -> str``). Refuses a tokenizer that does not give this
    text back exactly (a normalising tokenizer is lossy): compress the
    UTF-8 bytes with ``lm_compress_bytes`` then."""
    ids = list(tokenizer.encode(text))
    if tokenizer.decode(ids) != text:
        raise ValueError("tokenizer round-trip is not lossless for this text; "
                         "compress the UTF-8 bytes instead (lm_compress_bytes)")
    return lm_compress_tokens(np.asarray(ids, dtype=np.int32), **kw)


def lm_decompress_text(container: bytes, tokenizer, **kw) -> str:
    return tokenizer.decode([int(i) for i in lm_decompress_tokens(container, **kw)])


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


def encode_lm_span(cfg: LMConfig, params: Transformer, data, start: int, end: int,
                   block_tokens: int, lanes: int, prob_bits: int, overlap: int,
                   cache_grow: int = 0, window_mode: str = "reprime"):
    """Encode blocks [start, end) of ``data`` (bytes, or a 1-D int array of
    token ids) in fixed-shape waves of ``lanes`` on the parameters' device;
    returns ``[(raw_len, token_count, payload)]`` in block order
    (token_count 0 marks the raw fallback, taken when the words are no
    shorter than the block's raw symbols: bytes, or ids as
    ``_raw_dtype(cfg.vocab)``). One-wave pipeline: wave i+1 is dispatched
    before wave i's words are fetched (CUDA launches are asynchronous, so
    the card runs ahead while the host packs)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr, rdt = np.frombuffer(data, dtype=np.uint8), np.dtype(np.uint8)
    else:
        arr, rdt = np.ascontiguousarray(data, dtype=np.int32), _raw_dtype(cfg.vocab)
    n = len(arr)
    dev = params.embed.device
    out: list[tuple[int, int, bytes]] = []

    def finish(w0: int, nb: int, words_d, nwords_d) -> None:
        words, nwords = words_d.cpu().numpy(), nwords_d.cpu().numpy()
        for j in range(nb):
            s0 = (w0 + j) * block_tokens
            length = min(block_tokens, n - s0)
            payload = words[j, : nwords[j]].astype(">u4").tobytes()
            if len(payload) >= length * rdt.itemsize and length > 0:
                out.append((length, 0, arr[s0 : s0 + length].astype(rdt).tobytes()))
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
                   sym_dtype=np.uint8, cache_grow: int = 0,
                   window_mode: str = "reprime") -> list[bytes]:
    """Decode container blocks [start, end); returns their symbols packed as
    ``sym_dtype`` (uint8 for the byte alphabet, ``_raw_dtype(vocab)`` for
    the token alphabet: the encoder's raw packing) in block order, with the
    encoder's wave pipeline."""
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
                parts[w0 + j - start] = syms[j, : blk.token_count].astype(sym_dtype).tobytes()

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

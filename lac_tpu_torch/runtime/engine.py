"""Batched block engine and the file-level byte API.

Ports ``lac_tpu/runtime/engine.py``: the scan engine, ``_model_intervals``
(:53-67), ``_decode_lanes`` (:70-86), ``encode_lanes`` and
``decode_lanes`` (:89-108), ``_blockify`` (:116-123); and the file API,
``compress_bytes`` (:125-155), ``decompress_bytes`` (:158-185) and
``decompress_blocks`` (:187-212). The turbo model ids (order0c, order0n,
order1n, order2n) go to ``runtime/turbo.py`` (codec rANS-32) with the
``min(block_size, 1 << 12)`` clamp of :135-140; every other id of
``models/registry.py`` runs the scan engine (codec rANS-64).

The scan engine is ``lac_tpu``'s ``lax.scan`` as ``utils/scan.py``'s loop
of torch ops over ``[B, ...]`` lane tensors on the device (on the card a
chunk of 64 steps is one CUDA graph replay): each block is a lane, and a
step runs the model's CDF, the coder and the model's update for every lane
at once. The encoder gathers each position's interval from the model and
hands the ``[B, T]`` intervals to ``coder/vector._encode_scan``; the
decoder runs ``coder/vector._decode_step`` between the model's CDF and its
update. Every value is an integer, so the containers equal ``lac_tpu``'s
byte for byte on any device. A step writes the model's tables in place
(``update_``); no two lanes write one entry, so no result depends on the
order of a write, and the engine runs under inference mode only. The loop
stops at the longest lane: past it no lane is coded, the reference's
steps there change no word, and a decoded symbol there is 0, as the
reference's.

A container is parsed once: the reference parses it here for the codec and
again in ``turbo_decompress``. An LM container (also rANS-64) is refused
with the name of ``runtime.lm_api.lm_decompress_bytes``, which decodes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coder.rans import encode_capacity
from ..coder.vector import RansDecState, _decode_step, _encode_scan, rans_decode_init
from ..models.functional import ScanModel
from ..models.registry import get_scan_model, model_config
from ..ops.quantize import gather_intervals
from ..stream.container import (CODEC_RANS32, CODEC_RANS64, BlockEntry, ContainerHeader,
                                read_container, write_container)
from ..utils.device import as_lanes, resolve_device
from ..utils.scan import scan

__all__ = [
    "compress_bytes",
    "decompress_bytes",
    "decompress_blocks",
    "encode_lanes",
    "decode_lanes",
]

_TURBO_IDS = ("order0c", "order0n", "order1n", "order2n")


def _steps(lengths: torch.Tensor) -> int:
    """The steps that code a position: the longest lane's length."""
    return int(lengths.max()) if lengths.numel() else 0


def _leaves(state) -> tuple:
    """A model state as a flat tuple: a bare tensor, or its tuple."""
    return state if isinstance(state, tuple) else (state,)


def _model_intervals(syms: torch.Tensor, lengths: torch.Tensor, model: ScanModel):
    """The model over all lanes: (cdf_lo, freq) [B, n] int32 of the known
    symbols [B, T], for the first n = max(lengths) positions."""
    b = syms.shape[0]
    n = _steps(lengths)
    if not n:
        empty = torch.zeros((b, 0), dtype=torch.int32, device=syms.device)
        return empty, empty
    state = model.init_state(b, syms.device)
    bare = not isinstance(state, tuple)

    def step(leaves, x):
        state = leaves[0] if bare else leaves
        lo, f = gather_intervals(model.cdf(state), x[0])
        return _leaves(model.update_(state, x[0])), (lo, f)

    _, (lo, f) = scan(step, _leaves(state), (syms[:, :n].t().contiguous(),))
    return lo.t(), f.t()


def _decode_lanes(words: torch.Tensor, lengths: torch.Tensor, model: ScanModel,
                  t_len: int) -> torch.Tensor:
    """Lock-step decode: model cdf -> rANS step -> model update."""
    b, dev = words.shape[0], words.device
    n = min(t_len, _steps(lengths))
    out = torch.zeros((b, t_len), dtype=torch.int64, device=dev)
    if not n:
        return out
    x, words, pos = rans_decode_init(words)
    state = model.init_state(b, dev)
    bare = not isinstance(state, tuple)
    m = len(_leaves(state))

    def step(carry, xt):
        state = carry[0] if bare else carry[:m]
        sym, (x, _, pos) = _decode_step(RansDecState(carry[m], words, carry[m + 1]),
                                        model.cdf(state), model.prob_bits, xt[0])
        return (*_leaves(model.update_(state, sym)), x, pos), (sym,)

    active = torch.arange(n, device=dev)[:, None] < lengths[None, :]
    _, (syms,) = scan(step, (*_leaves(state), x, pos), (active,))
    out[:, :n] = syms.t()
    return out


def encode_lanes(syms, lengths, model: ScanModel, device=None):
    """syms [B, T] -> (words [B, T+2] int64 u32 values in decode order,
    nwords [B] int64), on ``device`` (cuda unless the caller passes
    "cpu")."""
    dev = resolve_device(device)
    syms, lengths = as_lanes(syms, dev), as_lanes(lengths, dev)
    with torch.inference_mode():
        lo, f = _model_intervals(syms, lengths, model)
        return _encode_scan(lo, f, lengths, model.prob_bits, syms.shape[1] + 2)


def decode_lanes(words, lengths, model: ScanModel, t_len: int, device=None) -> torch.Tensor:
    """words [B, cap] (decode order) -> symbols [B, t_len] int64, 0 past a
    lane's length, on ``device``."""
    dev = resolve_device(device)
    words, lengths = as_lanes(words, dev), as_lanes(lengths, dev)
    with torch.inference_mode():
        return _decode_lanes(words, lengths, model, t_len)


# --------------------------------------------------------------------------
# File-level API
# --------------------------------------------------------------------------


def _blockify(data: bytes, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """bytes -> (syms [B, block_size] int32 zero-padded, lengths [B] int32),
    at least one block."""
    n = len(data)
    b = max(1, -(-n // block_size))
    syms = np.zeros(b * block_size, dtype=np.int32)
    syms[:n] = np.frombuffer(data, dtype=np.uint8)
    lengths = np.clip(n - np.arange(b, dtype=np.int64) * block_size, 0, block_size)
    return syms.reshape(b, block_size), lengths.astype(np.int32)


def compress_bytes(
    data: bytes,
    model_id: str = "order0",
    block_size: int = 1 << 16,
    prob_bits: int = 16,
    device=None,
    **model_kw,
) -> bytes:
    """Compress raw bytes into a .lac container. The turbo model ids go to
    the turbo path with the block size clamped to 4096; the others run the
    scan engine on ``device`` (cuda unless the caller passes "cpu")."""
    if model_id in _TURBO_IDS:
        from .turbo import turbo_compress

        return turbo_compress(
            data, block_size=min(block_size, 1 << 12), model=model_id,
            device=device, **model_kw,
        )
    model = get_scan_model(model_id, prob_bits=prob_bits, **model_kw)
    syms, lengths = _blockify(data, block_size)
    words_d, nwords_d = encode_lanes(syms, lengths, model, device)
    nwords = nwords_d.cpu().numpy()
    words = words_d[:, : int(nwords.max())].cpu().numpy()
    blocks = [BlockEntry(int(lengths[i]), int(lengths[i]),
                         words[i, : nwords[i]].astype(">u4").tobytes())
              for i in range(syms.shape[0])]
    header = ContainerHeader(
        codec=CODEC_RANS64,
        prob_bits=prob_bits,
        model_id=model_id,
        config={"block_size": block_size, **model_config(model_id, **model_kw)},
        original_len=len(data),
    )
    return write_container(header, blocks)


def _codec_check(header: ContainerHeader) -> None:
    if header.model_id == "lm":
        raise ValueError("an LM container: decode it with "
                         "lac_tpu_torch.runtime.lm_api.lm_decompress_bytes")
    if header.codec not in (CODEC_RANS32, CODEC_RANS64):
        raise ValueError(f"unsupported codec {header.codec}")


def _scan_decode(header: ContainerHeader, blocks: list[BlockEntry], device) -> list[bytes]:
    """The scan engine's decode of ``blocks`` of a rANS-64 container."""
    cfg = dict(header.config)
    block_size = cfg.pop("block_size")
    model = get_scan_model(header.model_id, prob_bits=header.prob_bits, **cfg)
    words = np.zeros((len(blocks), encode_capacity(block_size)), dtype=np.uint32)
    lengths = np.zeros((len(blocks),), dtype=np.int32)
    for i, blk in enumerate(blocks):
        w = np.frombuffer(blk.payload, dtype=">u4")
        words[i, : len(w)] = w
        lengths[i] = blk.token_count
    syms = decode_lanes(words, lengths, model, block_size, device).cpu().numpy()
    return [syms[i, : blk.token_count].astype(np.uint8).tobytes()
            for i, blk in enumerate(blocks)]


def decompress_bytes(container: bytes, device=None) -> bytes:
    header, blocks = read_container(container)
    _codec_check(header)
    if header.codec == CODEC_RANS32:
        from .turbo import decompress_parsed

        return decompress_parsed(header, blocks, device=device)
    out = b"".join(_scan_decode(header, blocks, device))
    if len(out) != header.original_len:
        raise ValueError("decoded length mismatch")
    return out


def decompress_blocks(container: bytes, indices, device=None) -> list[bytes]:
    """Random-access decode of selected blocks. Blocks are independent
    streams, so this is also the resume/recovery primitive."""
    header, blocks = read_container(container)
    _codec_check(header)
    if header.codec == CODEC_RANS32:
        from .turbo import decompress_blocks_parsed

        return decompress_blocks_parsed(header, blocks, indices, device=device)
    return _scan_decode(header, [blocks[i] for i in indices], device)

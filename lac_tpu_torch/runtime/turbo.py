"""Turbo byte path: file bytes -> blocks -> one coding lane each.

Ports ``lac_tpu/runtime/turbo.py`` for its four codecs (order0c, order0n,
order1n, order2n):
``turbo_compress`` (:113-245), ``turbo_decompress`` (:288-295),
``turbo_decompress_blocks`` (:298-303), ``_encode_wave`` / ``_decode_wave``
(:78-95), ``_decode_cap_bucket`` (:68-75) and ``MAX_WAVE`` (:58), with the
rules that shape the container:

- ``block_size % 256 == 0`` (:119);
- encode word capacity ``cap = block_size // 2 + 3`` (:193);
- a block is stored raw, with ``token_count`` 0, unless
  ``2 * nwords < max(len, 1)`` (:151, 157-162);
- an empty input is one block of length 0 whose payload is the state words
  ``[1, 0]``;
- the codec gate of :123-128: where a nibble model's ``*_decode_fits``
  refuses the geometry (order0n and order1n above block 4096; order2n's
  gate admits block 8192), the container records order0c instead, which
  has no gate.

The reference's waves, cap buckets for the decode grid, 2048-lane
sub-kernels and order0c's chunked decode exist for the TPU's compile shapes
and memory and never reach the bitstream. Here the lanes of a file go to
the kernels in one launch per step, in groups of at most
``_LANES_PER_LAUNCH`` to bound device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rans_kernels as rk
from ..stream.container import (
    CODEC_RANS32,
    BlockEntry,
    ContainerHeader,
    read_container,
    write_container,
)
from ..utils.device import resolve_device

__all__ = [
    "turbo_compress",
    "turbo_decompress",
    "turbo_decompress_blocks",
    "decompress_parsed",
    "decompress_blocks_parsed",
    "MAX_WAVE",
]

MAX_WAVE = 8192  # the reference's lanes per dispatch; read by the codec gate
_DEFAULT_BLOCK = 1024
_DEFAULT_RATE = 4
_DEFAULT_MODEL = "order0n"
_PB = 16
# model -> (fused encode, fused decode, codec gate or None)
_CODECS = {
    "order0c": (rk.o0c_encode_fused, rk.o0c_rans32_decode, None),
    "order0n": (rk.o0n_encode_fused, rk.o0n_rans32_decode, rk.o0n_decode_fits),
    "order1n": (rk.o1n_encode_fused, rk.o1n_rans32_decode, rk.o1n_decode_fits),
    "order2n": (rk.o2n_encode_fused, rk.o2n_rans32_decode, rk.o2n_decode_fits),
}
_TURBO_MODELS = tuple(_CODECS)
# device memory per lane is about 9 * block_size bytes during encode
_LANES_PER_LAUNCH = 1 << 16

_CAP_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def _decode_cap_bucket(maxw: int, block_size: int) -> int:
    # coded lanes never exceed block_size//2+3 words (raw fallback), so the
    # terminal bucket is that, not block_size+2
    top = block_size // 2 + 3
    for c in _CAP_BUCKETS:
        if top >= c >= max(maxw, 3):
            return c
    return top


def turbo_compress(
    data: bytes,
    block_size: int = _DEFAULT_BLOCK,
    rate: int = _DEFAULT_RATE,
    model: str = _DEFAULT_MODEL,
    device=None,
) -> bytes:
    if block_size % 256:
        raise ValueError("turbo block_size must be a multiple of 256")
    if model not in _TURBO_MODELS:
        raise ValueError(f"turbo model must be one of {_TURBO_MODELS}")
    fits = _CODECS[model][2]
    if fits is not None and not fits(_decode_cap_bucket(block_size // 2 + 3, block_size),
                                     MAX_WAVE):
        model = "order0c"  # geometry fallback, as the reference's
    encode_fused = _CODECS[model][0]
    dev = resolve_device(device)
    n = len(data)
    nblocks = max(1, -(-n // block_size))
    padded = np.zeros(nblocks * block_size, dtype=np.uint8)
    padded[:n] = np.frombuffer(data, dtype=np.uint8)
    starts = np.arange(nblocks, dtype=np.int64) * block_size
    lengths = np.clip(n - starts, 0, block_size).astype(np.int32)
    cap = block_size // 2 + 3  # any lane needing more words is stored raw
    nwords = np.empty(nblocks, dtype=np.int32)
    words = np.empty((nblocks, cap), dtype=np.uint16)
    for b0 in range(0, nblocks, _LANES_PER_LAUNCH):
        b1 = min(b0 + _LANES_PER_LAUNCH, nblocks)
        host = torch.from_numpy(padded[b0 * block_size : b1 * block_size])
        # [B, T] rows -> time-major [T, B] on the device
        syms_tb = host.to(dev).view(b1 - b0, block_size).t().contiguous()
        len_d = torch.from_numpy(lengths[b0:b1]).to(dev)
        words_d, nwords_d = encode_fused(syms_tb, len_d, rate, cap)
        nwords[b0:b1] = nwords_d.cpu().numpy()
        coded = 2 * nwords[b0:b1] < np.maximum(lengths[b0:b1], 1)
        maxw = int(nwords[b0:b1][coded].max()) if coded.any() else 0
        # fetch only the columns that coded lanes use
        bucket = _decode_cap_bucket(maxw, block_size)
        words[b0:b1, :bucket] = words_d[:, :bucket].cpu().numpy()
    words_be = words.astype(">u2")
    blocks: list[BlockEntry] = []
    for j in range(nblocks):
        length, start = int(lengths[j]), int(starts[j])
        if 2 * nwords[j] >= max(length, 1) and length > 0:
            # raw fallback: token_count 0 marks an uncoded block
            blocks.append(BlockEntry(length, 0, data[start : start + length]))
        else:
            blocks.append(BlockEntry(length, length, words_be[j, : nwords[j]].tobytes()))
    header = ContainerHeader(
        codec=CODEC_RANS32,
        prob_bits=_PB,
        model_id=model,
        config={"block_size": block_size, "rate": rate},
        original_len=n,
    )
    return write_container(header, blocks)


def _is_raw(blk: BlockEntry) -> bool:
    return blk.token_count == 0 and blk.raw_len > 0


def _decode_block_list(header, blocks, device) -> list[bytes]:
    """Decode a list of independent blocks, in any order and any subset of
    the container's blocks (the random-access primitive)."""
    rate = header.config["rate"]
    decode = _CODECS[header.model_id][1]
    dev = resolve_device(device)
    results = [blk.payload if _is_raw(blk) else b"" for blk in blocks]
    coded = [j for j, blk in enumerate(blocks) if not _is_raw(blk)]
    for g0 in range(0, len(coded), _LANES_PER_LAUNCH):
        group = coded[g0 : g0 + _LANES_PER_LAUNCH]
        payloads = [blocks[j].payload for j in group]
        cap = max(2, max(len(p) for p in payloads) // 2)
        words = np.zeros((len(group), cap), dtype=np.uint16)
        flat = np.frombuffer(b"".join(payloads), dtype=">u2").astype(np.uint16)
        off = 0
        for i, p in enumerate(payloads):
            k = len(p) // 2
            words[i, :k] = flat[off : off + k]
            off += k
        lengths = np.array([blocks[j].token_count for j in group], dtype=np.int32)
        t_len = int(lengths.max())
        if t_len == 0:
            continue
        syms_tb = decode(
            torch.from_numpy(words).to(dev), torch.from_numpy(lengths).to(dev),
            t_len, rate,
        )
        syms_bt = syms_tb.t().contiguous().cpu().numpy()
        for i, j in enumerate(group):
            results[j] = syms_bt[i, : lengths[i]].tobytes()
    return results


def _check_turbo(header: ContainerHeader) -> None:
    if header.codec != CODEC_RANS32 or header.model_id not in _TURBO_MODELS:
        raise ValueError(f"not a turbo {_TURBO_MODELS} container")


def decompress_parsed(header: ContainerHeader, blocks: list[BlockEntry], device=None) -> bytes:
    """``turbo_decompress`` of a container that ``read_container`` has
    already parsed, so that a caller who read the header parses once."""
    _check_turbo(header)
    out = b"".join(_decode_block_list(header, blocks, device))
    if len(out) != header.original_len:
        raise ValueError("decoded length mismatch")
    return out


def decompress_blocks_parsed(
    header: ContainerHeader, blocks: list[BlockEntry], indices, device=None
) -> list[bytes]:
    """``turbo_decompress_blocks`` of an already parsed container."""
    _check_turbo(header)
    return _decode_block_list(header, [blocks[i] for i in indices], device)


def turbo_decompress(container: bytes, device=None) -> bytes:
    return decompress_parsed(*read_container(container), device=device)


def turbo_decompress_blocks(container: bytes, indices, device=None) -> list[bytes]:
    """Random-access decode of selected blocks only."""
    return decompress_blocks_parsed(*read_container(container), indices, device=device)

"""`.lac` container format (v1), PyTorch port.

Ports ``lac_tpu/stream/container.py`` (whole file) as an independent copy:
the port imports nothing of ``lac_tpu``. The bytes written here must equal
the reference's for the same header and blocks.

The reference has no container at all — its bitstreams are bare bit-packed
payloads whose symbol count the caller must know out-of-band, a verified
defect class (SURVEY.md §2.6.2/3/5, reference arith_code.py:327-334). The
container fixes that and carries everything decode needs:

    magic "LACU" | version u8 | codec u8 | prob_bits u8 | flags u8
    model_id: u16-prefixed utf-8   (registry key, e.g. "order0" / "lm:gpt2")
    config:   u32-prefixed bytes   (canonical JSON: model+engine params; the
                                    decoder rebuilds the identical pipeline)
    original_len u64 | n_blocks u32
    per block: raw_len u32 | token_count u32 | payload_len u32 | crc32 u32
    payloads (byte-aligned, concatenated)

Per-block framing is also the checkpoint/recovery story (SURVEY.md §5):
blocks are independent streams, so a corrupt block (crc mismatch) fails
alone and any block can be re-encoded or decoded in isolation.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass, field

from ..metrics import span

MAGIC = b"LACU"
VERSION = 1

CODEC_ORACLE_AC = 0
CODEC_RANS64 = 1   # u64 state, u32 words (LM path / XLA scan path)
CODEC_RANS32 = 2   # u32 state, u16 words (fused Pallas byte path)


@dataclass
class BlockEntry:
    raw_len: int        # original bytes covered by this block
    token_count: int    # coded symbols in this block
    payload: bytes      # coded bytes (rANS: u32 words big-endian; AC: bits)

    @property
    def crc(self) -> int:
        return zlib.crc32(self.payload)


@dataclass
class ContainerHeader:
    codec: int
    prob_bits: int
    model_id: str
    config: dict = field(default_factory=dict)
    original_len: int = 0
    flags: int = 0


def write_container(header: ContainerHeader, blocks: list[BlockEntry]) -> bytes:
    with span("lac.container.write", blocks=len(blocks)) as sp:
        out = bytearray()
        out += MAGIC
        out += struct.pack("<BBBB", VERSION, header.codec, header.prob_bits, header.flags)
        mid = header.model_id.encode()
        out += struct.pack("<H", len(mid)) + mid
        cfg = json.dumps(header.config, sort_keys=True, separators=(",", ":")).encode()
        out += struct.pack("<I", len(cfg)) + cfg
        out += struct.pack("<QI", header.original_len, len(blocks))
        for b in blocks:
            out += struct.pack("<IIII", b.raw_len, b.token_count, len(b.payload), b.crc)
        for b in blocks:
            out += b.payload
        sp.set(bytes=len(out))
        return bytes(out)


def scan_container(
    data: bytes,
) -> tuple[ContainerHeader, list[BlockEntry], list[int]]:
    """Tolerant parse: returns (header, blocks, bad_block_indices) without
    raising on payload corruption OR truncation past the header. Block
    independence makes this the failure-detection/recovery primitive
    (SURVEY.md §5): a corrupt/missing block is reported by index and every
    other block remains decodable. A truncated file (download cut short,
    partial write) yields its intact prefix blocks with the rest marked bad
    — the capability of the reference's ``(sampler, exception, partial)``
    debug return (arithmetic_coding.py:331-336), made a contract."""
    if data[:4] != MAGIC:
        raise ValueError("not a .lac container (bad magic)")
    version, codec, prob_bits, flags = struct.unpack_from("<BBBB", data, 4)
    if version != VERSION:
        raise ValueError(f"unsupported container version {version}")
    off = 8
    try:
        (midlen,) = struct.unpack_from("<H", data, off)
        off += 2
        model_id = data[off : off + midlen].decode()
        off += midlen
        (cfglen,) = struct.unpack_from("<I", data, off)
        off += 4
        config = json.loads(data[off : off + cfglen]) if cfglen else {}
        off += cfglen
        original_len, n_blocks = struct.unpack_from("<QI", data, off)
        off += 12
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"container header truncated/corrupt: {e}") from e
    entries = []
    for i in range(n_blocks):
        try:
            entries.append(struct.unpack_from("<IIII", data, off))
        except struct.error:
            entries.append(None)  # block table itself truncated
        off += 16
    blocks = []
    bad = []
    for i, ent in enumerate(entries):
        if ent is None:
            bad.append(i)
            blocks.append(BlockEntry(0, 0, b""))
            continue
        raw_len, token_count, plen, crc = ent
        payload = data[off : off + plen]
        off += plen
        if len(payload) != plen or zlib.crc32(payload) != crc:
            bad.append(i)
        blocks.append(BlockEntry(raw_len, token_count, payload))
    header = ContainerHeader(codec, prob_bits, model_id, config, original_len, flags)
    return header, blocks, bad


def read_container(data: bytes) -> tuple[ContainerHeader, list[BlockEntry]]:
    with span("lac.container.read", bytes=len(data)) as sp:
        header, blocks, bad = scan_container(data)
        sp.set(blocks=len(blocks))
    if bad:
        raise ValueError(f"block checksum mismatch: corrupt payload (blocks {bad})")
    return header, blocks


def verify_container(data: bytes) -> dict:
    """Integrity report: header metadata, per-block checksum results, and
    the byte span each block covers (for resume/random access)."""
    header, blocks, bad = scan_container(data)
    spans = []
    pos = 0
    for b in blocks:
        spans.append((pos, pos + b.raw_len))
        pos += b.raw_len
    return {
        "ok": not bad and pos == header.original_len,
        "codec": header.codec,
        "model_id": header.model_id,
        "n_blocks": len(blocks),
        "bad_blocks": bad,
        "original_len": header.original_len,
        "block_spans": spans,
    }

"""The comparison that decides ``correct``.

Every call of the window is held to its round trip: the decoded bytes or
ids equal the input, no call raised, no block fell back to raw storage
(a raw block is decoded without the model). A sample of the window's
files, drawn from the seed, is held to the plain reference: for every
coded position, the frequency the program's encoder handed the rANS coder
(tapped from the timed calls) against the frequency the reference's
float32 forward gives the same symbol under the coder's integer rule,
as the gap ``|log2 f_program - log2 f_reference|`` in bits, and as the
code length the program pays beyond the reference's; and each
sampled block's payload against the code length those frequencies imply
(rANS-64/32 flushes a 64-bit state, so a block costs 32 to 64 bits more
than ``sum(prob_bits - log2 f)``). The cell's file (``workloads/<cell>.json``)
sets the sample and the limits.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib

import numpy as np
import torch

# rANS-64/32 (the program's coder spec): a block's payload exceeds the sum of
# its symbols' costs by the flushed state, in (32, 64] bits; 0.5 bit of room
# for the coder's rounding
EXCESS_MIN_BITS = 31.5
EXCESS_MAX_BITS = 64.5


@dataclasses.dataclass
class Block:
    raw_len: int
    token_count: int      # 0: stored raw
    payload: bytes


def parse_container(data: bytes):
    """(prob_bits, blocks) of a ``.lac`` v1 container: magic ``LACU``,
    version, codec, prob_bits, flags; model id (u16 length); config (u32
    length); original length u64, block count u32; per block raw length,
    symbol count, payload length and crc32 (u32 each); then the payloads.
    Raises on a bad magic or a payload whose crc32 differs."""
    if data[:4] != b"LACU":
        raise ValueError("not a .lac container")
    prob_bits = data[6]
    off = 8
    (n,) = struct.unpack_from("<H", data, off)
    off += 2 + n
    (n,) = struct.unpack_from("<I", data, off)
    off += 4 + n
    _, n_blocks = struct.unpack_from("<QI", data, off)
    off += 12
    table = [struct.unpack_from("<IIII", data, off + 16 * i) for i in range(n_blocks)]
    off += 16 * n_blocks
    blocks = []
    for raw_len, count, plen, crc in table:
        payload = data[off : off + plen]
        off += plen
        if len(payload) != plen or zlib.crc32(payload) != crc:
            raise ValueError("a block's payload fails its crc32")
        blocks.append(Block(raw_len, count, payload))
    return prob_bits, blocks


def prob_bits_for(coding: dict, vocab: int) -> int:
    """The API's rule: the requested ``prob_bits`` raised until
    ``2**pb >= 2 * vocab``."""
    pb = coding.get("prob_bits", 16)
    while (1 << pb) < 2 * vocab:
        pb += 1
    return pb


def symbols_of(item) -> np.ndarray:
    if isinstance(item, (bytes, bytearray)):
        return np.frombuffer(item, dtype=np.uint8).astype(np.int64)
    return np.asarray(item, dtype=np.int64)


def blocks_of(item, block: int):
    """The item's blocks as [N, block] int64 (zero-padded) and their lengths."""
    s = symbols_of(item)
    n = max(1, -(-len(s) // block))
    out = np.zeros((n, block), dtype=np.int64)
    lengths = []
    for b in range(n):
        chunk = s[b * block : (b + 1) * block]
        out[b, : len(chunk)] = chunk
        lengths.append(len(chunk))
    return out, lengths


def tapped_freqs(waves: list, lanes: int, n_blocks: int) -> list:
    """Per block, the frequencies its encode wave handed the coder, on the host."""
    out = []
    for b in range(n_blocks):
        _, freq, lengths = waves[b // lanes]
        j = b % lanes
        out.append(freq[j, : int(lengths[j])].to("cpu", torch.int64).numpy())
    return out


def sample(n_calls: int, k: int, seed: int) -> list:
    """``k`` of the window's calls, drawn from the seed, in order."""
    rng = np.random.default_rng([seed, 0x5EED])
    return sorted(rng.choice(n_calls, size=min(k, n_calls), replace=False).tolist())


def gaps(prog: list, ref: list) -> np.ndarray:
    """|log2 f_program - log2 f_reference| of every coded position."""
    return np.concatenate([np.abs(np.log2(p) - np.log2(r[: len(p)])) for p, r in zip(prog, ref)])


def extra_bits(prog: list, ref: list) -> float:
    """The program's code length over the reference's, in bits a symbol:
    the mean of ``log2 f_reference - log2 f_program`` (a model that predicts
    worse than the reference pays more)."""
    d = np.concatenate([np.log2(r[: len(p)]) - np.log2(p) for p, r in zip(prog, ref)])
    return float(d.mean())


def coder_excess(blocks, prog: list, prob_bits: int) -> list:
    """Payload bits minus the code length of the tapped frequencies, of each
    coded block."""
    out = []
    for blk, f in zip(blocks, prog):
        if blk.token_count == 0:
            continue
        ideal = float(np.sum(prob_bits - np.log2(f.astype(np.float64))))
        out.append(8 * len(blk.payload) - ideal)
    return out


def reference_freqs(family, weights, model, item, block, prob_bits, rows, device,
                    quant=None) -> list:
    syms, lengths = blocks_of(item, block)
    f = _coded(family, weights, model, torch.from_numpy(syms).to(device), prob_bits, rows, quant)
    return [f[b, :n].cpu().numpy() for b, n in enumerate(lengths)]


def _coded(family, weights, model, blocks, prob_bits, rows, quant):
    from reference.common import coded_freqs

    return coded_freqs(family, weights, model, blocks, prob_bits, rows, quant)


def judge(numbers: dict, limits: dict) -> dict:
    """name -> {value, limit, ok}: a number passes when it is within its
    limit (``max`` or ``min`` bounds); a missing number fails."""
    out = {}
    for name, lim in limits.items():
        v = numbers.get(name)
        ok = v is not None and not (isinstance(v, float) and math.isnan(v))
        if ok and "max" in lim:
            ok = v <= lim["max"]
        if ok and "min" in lim:
            ok = v >= lim["min"]
        out[name] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out

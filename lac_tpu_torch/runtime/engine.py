"""File-level byte API: compress, decompress and random access.

Ports the turbo part of ``lac_tpu/runtime/engine.py``: ``compress_bytes``
(:125-155), ``decompress_bytes`` (:158-185) and ``decompress_blocks``
(:187-212) for the four turbo model ids (order0c, order0n, order1n,
order2n), with the ``min(block_size, 1 << 12)`` clamp of :135-140. A
container is parsed once: the reference parses it here for the codec and
again in ``turbo_decompress``. The XLA-scan models (codec rANS-64) are a
later slice of the port and raise ``NotImplementedError`` here; an LM
container (also rANS-64) is refused with the name of
``runtime.lm_api.lm_decompress_bytes``, which decodes it.
"""

from __future__ import annotations

from ..stream.container import CODEC_RANS32, CODEC_RANS64, read_container

__all__ = ["compress_bytes", "decompress_bytes", "decompress_blocks"]

_TURBO_IDS = ("order0c", "order0n", "order1n", "order2n")


def _scan_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the XLA-scan byte models (codec rANS-64) "
        "come with the port's host-only slice (ROADMAP A14)"
    )


def compress_bytes(
    data: bytes,
    model_id: str = "order0",
    block_size: int = 1 << 16,
    prob_bits: int = 16,
    device=None,
    **model_kw,
) -> bytes:
    """Compress raw bytes into a .lac container. The turbo model ids go to
    the turbo path with the block size clamped to 4096."""
    if model_id in _TURBO_IDS:
        from .turbo import turbo_compress

        return turbo_compress(
            data, block_size=min(block_size, 1 << 12), model=model_id,
            device=device, **model_kw,
        )
    raise _scan_not_ported(f"model {model_id!r}")


def _codec_check(header) -> None:
    if header.model_id == "lm":
        raise ValueError("an LM container: decode it with "
                         "lac_tpu_torch.runtime.lm_api.lm_decompress_bytes")
    if header.codec == CODEC_RANS64:
        raise _scan_not_ported(f"codec {header.codec} (model {header.model_id!r})")
    if header.codec != CODEC_RANS32:
        raise ValueError(f"unsupported codec {header.codec}")


def decompress_bytes(container: bytes, device=None) -> bytes:
    header, blocks = read_container(container)
    _codec_check(header)
    from .turbo import decompress_parsed

    return decompress_parsed(header, blocks, device=device)


def decompress_blocks(container: bytes, indices, device=None) -> list[bytes]:
    """Random-access decode of selected blocks. Blocks are independent
    streams, so this is also the resume/recovery primitive."""
    header, blocks = read_container(container)
    _codec_check(header)
    from .turbo import decompress_blocks_parsed

    return decompress_blocks_parsed(header, blocks, indices, device=device)

"""ctypes binding and build of the native (C++) host coder.

Ports ``lac_tpu/native/host.py``. ``lac_native.cpp`` is the port's own
copy of ``lac_tpu/native/lac_native.cpp``, byte for byte: the turbo
models' arithmetic and the rANS-32/16 spec in C++ with OpenMP over blocks,
so its containers equal the port's turbo path's (``runtime/turbo.py``) and
``lac_tpu``'s.

The library is built with ``g++ -O3 -march=native -fopenmp`` at the first
call that needs it, never at import, into ``native/build/`` under a name
that holds a hash of the source and the flags. The build runs under a file
lock beside it, writes a temporary name and renames it into place, so
processes that build at once never load a half-written library (the race
of ``lac_tpu/native/host.py:58-72``). A failed build raises with g++'s
message, and a later call tries again.

Only an explicit ``native_compress`` / ``native_decompress`` reaches this
coder: no path of the port falls back to it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..stream.container import (
    CODEC_RANS32,
    BlockEntry,
    ContainerHeader,
    read_container,
    write_container,
)

__all__ = ["native_available", "native_compress", "native_decompress"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "lac_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
MODELS = ("order0c", "order0n", "order1n", "order2n")

_lock = threading.Lock()
_lib = None


def so_path() -> str:
    """The library's path: ``build/liblac_native-<hash>.so``."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"liblac_native-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """g++ into a temporary name, then one rename, under the file lock."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}) on {_SRC}:\n"
                                   f"{res.stderr[-4000:]}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = so_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.o0c_encode_blocks.argtypes = [p, p, p, i, i, i, i, p, p]
        lib.o0c_decode_blocks.argtypes = [p, p, i, i, i, i, p, p]
        for m in ("o0n", "o1n", "o2n"):
            getattr(lib, f"{m}_encode_blocks").argtypes = [p, p, p, i, i, i, p, p]
            getattr(lib, f"{m}_decode_blocks").argtypes = [p, p, i, i, i, p, p]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def native_compress(
    data: bytes, block_size: int = 1024, rate: int = 4, model: str = "order0n"
) -> bytes:
    """The container of ``runtime.turbo.turbo_compress`` for the same
    (model, block_size, rate), byte for byte, coded on the host."""
    if model not in MODELS:
        raise ValueError("native model must be order0c, order0n, order1n, or order2n")
    # the turbo path's codec gate, so that both producers record one codec
    from ..ops.rans_kernels import o0n_decode_fits, o1n_decode_fits, o2n_decode_fits
    from ..runtime.turbo import MAX_WAVE, _decode_cap_bucket

    fits = {"order0n": o0n_decode_fits, "order1n": o1n_decode_fits,
            "order2n": o2n_decode_fits}
    if model in fits and not fits[model](
        _decode_cap_bucket(block_size // 2 + 3, block_size), MAX_WAVE
    ):
        model = "order0c"
    lib = _load()
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    nblocks = max(1, -(-n // block_size))
    cap = block_size + 2
    offsets = np.arange(nblocks, dtype=np.int32) * block_size
    lengths = np.maximum(np.minimum(block_size, n - offsets), 0).astype(np.int32)
    words = np.zeros((nblocks, cap), dtype=np.uint16)
    nwords = np.zeros((nblocks,), dtype=np.int32)
    if n:
        args = (arr.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, nblocks, cap, rate)
        out = (words.ctypes.data, nwords.ctypes.data)
        if model == "order0c":
            lib.o0c_encode_blocks(*args, 16, *out)
        else:
            getattr(lib, f"o{model[5]}n_encode_blocks")(*args, *out)
    else:
        nwords[:] = 2
        words[:, 0] = 1  # x = RANS32_L
    blocks = []
    for i in range(nblocks):
        payload = words[i, : nwords[i]].astype(">u2").tobytes()
        raw = arr[offsets[i] : offsets[i] + lengths[i]].tobytes()
        if len(payload) >= len(raw) and len(raw) > 0:
            blocks.append(BlockEntry(int(lengths[i]), 0, raw))
        else:
            blocks.append(BlockEntry(int(lengths[i]), int(lengths[i]), payload))
    header = ContainerHeader(
        codec=CODEC_RANS32, prob_bits=16, model_id=model,
        config={"block_size": block_size, "rate": rate}, original_len=n,
    )
    return write_container(header, blocks)


def native_decompress(container: bytes) -> bytes:
    """Decode a turbo container (any of the four models) on the host."""
    header, blocks = read_container(container)
    if header.codec != CODEC_RANS32 or header.model_id not in MODELS:
        raise ValueError("not a turbo (order0c/order0n/order1n/order2n) container")
    lib = _load()
    block_size, rate = header.config["block_size"], header.config["rate"]
    cap = block_size + 2
    coded = [(i, b) for i, b in enumerate(blocks)
             if not (b.token_count == 0 and b.raw_len > 0)]
    out_parts: dict[int, bytes] = {
        i: b.payload for i, b in enumerate(blocks)
        if b.token_count == 0 and b.raw_len > 0
    }
    if coded:
        nc = len(coded)
        words = np.zeros((nc, cap), dtype=np.uint16)
        lengths = np.zeros((nc,), dtype=np.int32)
        out_offsets = np.zeros((nc,), dtype=np.int32)
        total = 0
        for j, (_, b) in enumerate(coded):
            w = np.frombuffer(b.payload, dtype=">u2")
            words[j, : len(w)] = w
            lengths[j] = b.token_count
            out_offsets[j] = total
            total += b.token_count
        out = np.zeros((total,), dtype=np.uint8)
        args = (words.ctypes.data, lengths.ctypes.data, nc, cap, rate)
        dst = (out_offsets.ctypes.data, out.ctypes.data)
        if header.model_id == "order0c":
            lib.o0c_decode_blocks(*args, 16, *dst)
        else:
            getattr(lib, f"o{header.model_id[5]}n_decode_blocks")(*args, *dst)
        for j, (i, b) in enumerate(coded):
            out_parts[i] = out[out_offsets[j] : out_offsets[j] + lengths[j]].tobytes()
    res = b"".join(out_parts[i] for i in range(len(blocks)))
    if len(res) != header.original_len:
        raise ValueError("decoded length mismatch")
    return res

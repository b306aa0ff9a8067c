"""Turbo coding kernels: one wrapper per CUDA kernel, its plain PyTorch
version beside it, a launch count, and the codec gates.

Ports ``lac_tpu/ops/pallas_rans.py``:

- ``o0c_encode_intervals`` (:113-171) -> K8, ``lac_o0c_intervals``;
- ``o0c_rans32_decode`` (:562-630), both its fused kernel (:377-438) and
  its chunked fallback (:493-560) -> K9, ``lac_o0c_decode``: a lane keeps a
  pointer into its own word row, so one kernel covers every ``cap``;
- ``o0c_encode_fused`` (:316-339) -> K8 then K2;
- ``o0n_encode_intervals`` (:742-822) -> K1, ``lac_o0n_intervals``;
- ``rans32_encode_dense`` (:179-267) followed by ``compact_words``
  (:271-310) -> K2, ``rans32_encode``, one kernel whose result equals
  ``compact_words(rans32_encode_dense(...))``. Neither name is kept: the
  dense grid (a word or ``SENTINEL``, 0xFFFFFFFF, at every position) is
  the Pallas kernel's storage layout, which ``compact_words`` then squeezes
  into decode order; K2 writes each lane's words in decode order through a
  per-lane pointer, so no dense grid, no ``SENTINEL`` and no compaction
  pass exist for a caller to use;
- ``o0n_rans32_decode`` (:849-1030) -> K3, ``lac_o0n_decode``;
- ``o1n_encode_intervals`` (:1044-1141) -> K4, ``lac_o1n_intervals``;
- ``o1n_rans32_decode`` (:1148-1258) -> K5, ``lac_o1n_decode``;
- ``o2n_encode_intervals`` (:1277-1375) -> K6, ``lac_o2n_intervals``;
- ``o2n_rans32_decode`` (:1382-1495) -> K7, ``lac_o2n_decode``;
- ``o0n_encode_fused`` / ``o1n_encode_fused`` / ``o2n_encode_fused``
  (``_nib_encode_fused`` :825-846), each its intervals kernel -> K2;
- the codec gates ``o0n_decode_fits`` (:921-931), ``o1n_decode_fits``
  (:1229-1238), ``o2n_decode_fits`` (:1465-1475) and the sub-lane splitter
  ``_nib_sub_lanes`` (:969-976) that the order2n gate asks, with the
  constants they read (``_FUSED_VMEM_LIMIT`` :438, ``_FIFO`` :61,
  ``_MAX_KERNEL_LANES`` :313, ``_NV`` :626, ``_NL2`` :1270). A gate is the
  reference's pure formula, not a check of GPU memory: it decides which
  codec a container records (``runtime/turbo.py:123-128``).

The plain versions are one loop per direction, ``_intervals_plain`` and
``_decode_plain``, that step any model of ``models/functional.py`` with
the codec's interval and search: the nibble models' through their
``hi_row`` / ``lo_row`` selectors, composed into one 16-bit step;
order0c's (``Order0CDF``) on its 257-entry CDF, at the reference turbo
path's fixed ``v = 256`` and ``prob_bits = 16``. The reference's order0c
wrappers also take ``v`` and ``prob_bits``, static arguments of its Pallas
kernels; K8 and K9 are built for that one geometry, so the port's take
neither.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (``csrc/nib_rans32.cu``: K1 and K3-K7, one
template over the hi rows and lo contexts, 1 and 16 for order0n, 16 and 16
for order1n, 16 and 64 for order2n; ``csrc/rans32_encode.cu``: K2;
``csrc/o0c_rans32.cu``: K8, K9) or raises; it never falls back.
``launches[name]`` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import torch

from ..models.functional import (
    NIB_V,
    Order0CDF,
    Order0NibCDF,
    Order1NibCDF,
    Order2NibCDF,
    nib_state_to_coder,
)
from . import _build

__all__ = [
    "o0c_encode_intervals",
    "o0c_encode_fused",
    "o0c_rans32_decode",
    "o0c_intervals_plain",
    "o0c_decode_plain",
    "o0n_encode_intervals",
    "o1n_encode_intervals",
    "o2n_encode_intervals",
    "rans32_encode",
    "o0n_rans32_decode",
    "o1n_rans32_decode",
    "o2n_rans32_decode",
    "o0n_encode_fused",
    "o1n_encode_fused",
    "o2n_encode_fused",
    "o0n_decode_fits",
    "o1n_decode_fits",
    "o2n_decode_fits",
    "launches",
    "reset_launches",
    "o0n_intervals_plain",
    "o1n_intervals_plain",
    "o2n_intervals_plain",
    "rans32_encode_plain",
    "o0n_decode_plain",
    "o1n_decode_plain",
    "o2n_decode_plain",
]

# reference constants (lac_tpu/ops/pallas_rans.py) read by the codec gates
_FIFO = 128
_FUSED_VMEM_LIMIT = 64 * 1024 * 1024
_MAX_KERNEL_LANES = 2048
_NV = NIB_V
_NL2 = 4 * NIB_V  # order2n lo contexts


launches = {
    "o0n_intervals": 0, "rans32_encode": 0, "o0n_decode": 0,
    "o1n_intervals": 0, "o1n_decode": 0, "o2n_intervals": 0, "o2n_decode": 0,
    "o0c_intervals": 0, "o0c_decode": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------------------
# Codec gates (pure formulas)
# --------------------------------------------------------------------------

_VMEM_BUDGET = _FUSED_VMEM_LIMIT - 4 * 1024 * 1024


def _o0n_vmem_ok(cap: int, b: int) -> bool:
    cap2 = (cap + 1) // 2
    need = 4 * (5 * cap2 * b + 5 * 8 * _NV * b + 2 * _FIFO * b + 16 * b)
    return need <= _VMEM_BUDGET


def _o1n_vmem_ok(cap: int, b: int) -> bool:
    cap2 = (cap + 1) // 2
    need = 4 * (5 * cap2 * b + 9 * 8 * _NV * b + 2 * _FIFO * b + 24 * b)
    return need <= _VMEM_BUDGET


def _o2n_vmem_ok(cap: int, b: int) -> bool:
    cap2 = (cap + 1) // 2
    need = 4 * (5 * cap2 * b + 9 * 8 * (_NV + _NL2) * b + 2 * _FIFO * b + 24 * b)
    return need <= _VMEM_BUDGET


def _nib_sub_lanes(fits_one, cap: int) -> int:
    """Largest power-of-two lane count from 256 up to ``_MAX_KERNEL_LANES``
    whose budget fits ``cap``; 0 if none does."""
    sub = _MAX_KERNEL_LANES
    while sub >= 256 and not fits_one(cap, sub):
        sub //= 2
    return sub if sub >= 256 else 0


def o0n_decode_fits(cap: int, b: int) -> bool:
    """Whether the reference's order0n decode geometry admits (cap, B); the
    compressor records order0c instead when it does not."""
    return _o0n_vmem_ok(cap, min(b, _MAX_KERNEL_LANES))


def o1n_decode_fits(cap: int, b: int) -> bool:
    """As ``o0n_decode_fits``, for order1n."""
    return _o1n_vmem_ok(cap, min(b, _MAX_KERNEL_LANES))


def o2n_decode_fits(cap: int, b: int) -> bool:
    """The order2n gate ignores ``b``: the reference narrows its sub-kernels
    until the budget fits, so it asks whether any width from 256 lanes up
    fits ``cap``."""
    del b
    return _nib_sub_lanes(_o2n_vmem_ok, cap) > 0


# --------------------------------------------------------------------------
# Argument checks and the launch path
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on an unsupported device {t.device}")


def _same_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``lac_<name>`` on the device's current stream;
    raise on any non-zero cudaError_t. Counts the launch."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"lac_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    launches[name] += 1


def _interval(eff: torch.Tensor, k: torch.Tensor):
    """(eff[k], eff[k+1] - eff[k]) per lane of a [B, V+1] boundary table."""
    lo = eff.gather(1, k[:, None])[:, 0]
    return lo, eff.gather(1, k[:, None] + 1)[:, 0] - lo


def _search(eff: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The last k in [0, V) with eff[k] <= v, per lane of a [B, V+1]
    boundary table."""
    return (eff[:, :-1] <= v[:, None]).sum(1) - 1


def _nib_interval(model, state, s: torch.Tensor):
    """A byte's two nibble intervals, composed: (lo12, f12)."""
    h, l = s >> 4, s & 15
    loh, fh = _interval(nib_state_to_coder(model.hi_row(state)), h)
    lol, fl = _interval(nib_state_to_coder(model.lo_row(state, h)), l)
    return (loh << 8) + fh * lol, fh * fl


def _nib_search(model, state, slot: torch.Tensor):
    """The byte whose composed interval holds ``slot``: (byte, lo12, f12)."""
    effh = nib_state_to_coder(model.hi_row(state))
    h = _search(effh, slot >> 8)
    loh, fh = _interval(effh, h)
    sc = fh[:, None] * nib_state_to_coder(model.lo_row(state, h))  # sc[16] = fh << 8
    l = _search(sc, slot - (loh << 8))
    lo_s, f12 = _interval(sc, l)
    return (h << 4) | l, (loh << 8) + lo_s, f12


def _o0c_interval(model, state, s: torch.Tensor):
    return _interval(model.cdf(state), s)


def _o0c_search(model, state, slot: torch.Tensor):
    cdf = model.cdf(state)
    s = _search(cdf, slot)
    return (s, *_interval(cdf, s))


# codec -> (model, its interval of a byte, its search for a slot)
_CODEC_MODELS = {
    "o0n": (Order0NibCDF, _nib_interval, _nib_search),
    "o1n": (Order1NibCDF, _nib_interval, _nib_search),
    "o2n": (Order2NibCDF, _nib_interval, _nib_search),
    "o0c": (Order0CDF, _o0c_interval, _o0c_search),
}


# --------------------------------------------------------------------------
# Model forward -> (lo, fr): K1 (order0n), K4 (order1n), K6 (order2n),
# K8 (order0c)
# --------------------------------------------------------------------------


def _intervals_plain(codec: str, syms_tb: torch.Tensor, rate: int):
    """Plain version of the intervals kernels: the codec's model stepped
    over all T steps (the zero padding past a lane's length too, as the
    reference does), vectorised over the B lanes."""
    model_cls, interval, _ = _CODEC_MODELS[codec]
    model = model_cls(rate)
    t_len, b = syms_tb.shape
    dev = syms_tb.device
    state = model.init_state(b, dev)
    lo = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    fr = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    for t in range(t_len):
        s = syms_tb[t].to(torch.int64)
        lo[t], fr[t] = interval(model, state, s)
        state = model.update_(state, s)
    return lo, fr


def o0n_intervals_plain(syms_tb: torch.Tensor, rate: int):
    return _intervals_plain("o0n", syms_tb, rate)


def o1n_intervals_plain(syms_tb: torch.Tensor, rate: int):
    return _intervals_plain("o1n", syms_tb, rate)


def o2n_intervals_plain(syms_tb: torch.Tensor, rate: int):
    return _intervals_plain("o2n", syms_tb, rate)


def o0c_intervals_plain(syms_tb: torch.Tensor, rate: int):
    return _intervals_plain("o0c", syms_tb, rate)


def _intervals(codec: str, syms_tb: torch.Tensor, rate: int):
    _check(syms_tb, "syms_tb", torch.uint8, 2)
    if syms_tb.device.type == "cpu":
        return _intervals_plain(codec, syms_tb, rate)
    t_len, b = syms_tb.shape
    lo = torch.empty((t_len, b), dtype=torch.int32, device=syms_tb.device)
    fr = torch.empty((t_len, b), dtype=torch.int32, device=syms_tb.device)
    if t_len and b:
        _launch(f"{codec}_intervals", syms_tb.device,
                syms_tb.data_ptr(), lo.data_ptr(), fr.data_ptr(), t_len, b, rate)
    return lo, fr


def o0n_encode_intervals(syms_tb: torch.Tensor, rate: int):
    """syms_tb: [T, B] uint8 bytes. Returns composed (lo12, f12) [T, B]
    int32 with total 2**16, the input of ``rans32_encode``."""
    return _intervals("o0n", syms_tb, rate)


def o1n_encode_intervals(syms_tb: torch.Tensor, rate: int):
    """As ``o0n_encode_intervals``, for the order1n model."""
    return _intervals("o1n", syms_tb, rate)


def o2n_encode_intervals(syms_tb: torch.Tensor, rate: int):
    """As ``o0n_encode_intervals``, for the order2n model."""
    return _intervals("o2n", syms_tb, rate)


def o0c_encode_intervals(syms_tb: torch.Tensor, rate: int):
    """syms_tb: [T, B] uint8 bytes. Returns order0c's (lo, fr) [T, B] int32
    with total 2**16, the input of ``rans32_encode``."""
    return _intervals("o0c", syms_tb, rate)


# --------------------------------------------------------------------------
# K2: rANS-32/16 reverse encode + word compaction
# --------------------------------------------------------------------------


def rans32_encode_plain(lo_tb: torch.Tensor, fr_tb: torch.Tensor,
                        lengths: torch.Tensor, cap: int):
    """Plain version of K2: the reverse encode over a dense [T, B] grid of
    emitted words, then compaction by a prefix count and a scatter."""
    t_len, b = lo_tb.shape
    dev = lo_tb.device
    x = torch.full((b,), 1 << 16, dtype=torch.int64, device=dev)
    emit = torch.zeros((t_len, b), dtype=torch.bool, device=dev)
    dense = torch.zeros((t_len, b), dtype=torch.int64, device=dev)
    n = lengths.to(torch.int64)
    for t in range(t_len - 1, -1, -1):
        active = t < n
        f = torch.where(active, fr_tb[t].to(torch.int64), 1)
        lo = lo_tb[t].to(torch.int64)
        e = active & (x >= (f << 16))
        emit[t] = e
        dense[t] = x & 0xFFFF
        x = torch.where(e, x >> 16, x)
        xn = (((x // f) << 16) + x % f + lo) & 0xFFFFFFFF
        x = torch.where(active, xn, x)
    words = torch.zeros((b, cap), dtype=torch.int64, device=dev)
    words[:, 0] = x >> 16
    words[:, 1] = x & 0xFFFF
    col = 2 + torch.cumsum(emit.to(torch.int64), dim=0) - 1  # [T, B]
    keep = emit & (col < cap)
    tt, bb = keep.nonzero(as_tuple=True)
    words[bb, col[tt, bb]] = dense[tt, bb]
    nwords = (2 + emit.sum(dim=0)).to(torch.int32)
    return words.to(torch.uint16), nwords


def rans32_encode(lo_tb: torch.Tensor, fr_tb: torch.Tensor,
                  lengths: torch.Tensor, cap: int):
    """Reverse-order batched rANS-32/16 encode with compaction.

    lo_tb, fr_tb: [T, B] int32 intervals (prob_bits 16); lengths: [B] int32.
    Returns (words [B, cap] uint16, nwords [B] int32): per lane
    ``[x >> 16, x & 0xFFFF, words in ascending t]`` and zeros after them.
    ``nwords`` counts every word, even past ``cap``; the row holds the
    first ``cap``."""
    _check(lo_tb, "lo_tb", torch.int32, 2)
    _check(fr_tb, "fr_tb", torch.int32, 2)
    _check(lengths, "lengths", torch.int32, 1)
    _same_device(lo_tb, fr_tb, lengths)
    t_len, b = lo_tb.shape
    if fr_tb.shape != lo_tb.shape or lengths.shape != (b,):
        raise ValueError("lo_tb, fr_tb must be [T, B] and lengths [B]")
    if cap < 2:
        raise ValueError("cap must hold the two state words")
    if lo_tb.device.type == "cpu":
        return rans32_encode_plain(lo_tb, fr_tb, lengths, cap)
    words = torch.empty((b, cap), dtype=torch.uint16, device=lo_tb.device)
    nwords = torch.empty((b,), dtype=torch.int32, device=lo_tb.device)
    if b:
        _launch("rans32_encode", lo_tb.device,
                lo_tb.data_ptr(), fr_tb.data_ptr(), lengths.data_ptr(),
                words.data_ptr(), nwords.data_ptr(), t_len, b, cap)
    return words, nwords


def o0n_encode_fused(syms_tb: torch.Tensor, lengths: torch.Tensor, rate: int, cap: int):
    """K1 then K2: [T, B] uint8 bytes -> (words [B, cap] uint16, nwords [B])."""
    return rans32_encode(*o0n_encode_intervals(syms_tb, rate), lengths, cap)


def o1n_encode_fused(syms_tb: torch.Tensor, lengths: torch.Tensor, rate: int, cap: int):
    """K4 then K2, as ``o0n_encode_fused``."""
    return rans32_encode(*o1n_encode_intervals(syms_tb, rate), lengths, cap)


def o2n_encode_fused(syms_tb: torch.Tensor, lengths: torch.Tensor, rate: int, cap: int):
    """K6 then K2, as ``o0n_encode_fused``."""
    return rans32_encode(*o2n_encode_intervals(syms_tb, rate), lengths, cap)


def o0c_encode_fused(syms_tb: torch.Tensor, lengths: torch.Tensor, rate: int, cap: int):
    """K8 then K2, as ``o0n_encode_fused``."""
    return rans32_encode(*o0c_encode_intervals(syms_tb, rate), lengths, cap)


# --------------------------------------------------------------------------
# Fused model + rANS-32/16 decode: K3 (order0n), K5 (order1n), K7 (order2n),
# K9 (order0c)
# --------------------------------------------------------------------------


def _decode_plain(codec: str, words: torch.Tensor, lengths: torch.Tensor, t_len: int,
                  rate: int):
    """Plain version of the decode kernels: the codec's model stepped over
    T with the rANS decode, vectorised over the B lanes; a lane reads 0
    past cap. A lane's state after its length is never read again, so the
    model steps every lane."""
    model_cls, _, search = _CODEC_MODELS[codec]
    model = model_cls(rate)
    b, cap = words.shape
    dev = words.device
    state = model.init_state(b, dev)
    w = torch.cat([words.to(torch.int64), torch.zeros((b, 1), dtype=torch.int64, device=dev)], 1)
    pos = torch.full((b,), 2, dtype=torch.int64, device=dev)
    x = (w[:, min(0, cap)] << 16) | w[:, min(1, cap)]
    n = lengths.to(torch.int64)
    syms = torch.zeros((t_len, b), dtype=torch.uint8, device=dev)
    for t in range(t_len):
        active = t < n
        slot = x & 0xFFFF
        s, lo, fr = search(model, state, slot)
        xn = (fr * (x >> 16) + (slot - lo)) & 0xFFFFFFFF
        refill = active & (xn < (1 << 16))
        wv = w.gather(1, pos.clamp(max=cap)[:, None])[:, 0]
        xn = torch.where(refill, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
        pos = pos + refill.to(torch.int64)
        x = torch.where(active, xn, x)
        syms[t] = torch.where(active, s, 0).to(torch.uint8)
        state = model.update_(state, s)
    return syms


def o0n_decode_plain(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    return _decode_plain("o0n", words, lengths, t_len, rate)


def o1n_decode_plain(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    return _decode_plain("o1n", words, lengths, t_len, rate)


def o2n_decode_plain(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    return _decode_plain("o2n", words, lengths, t_len, rate)


def o0c_decode_plain(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    return _decode_plain("o0c", words, lengths, t_len, rate)


def _decode(codec: str, words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    _check(words, "words", torch.uint16, 2)
    _check(lengths, "lengths", torch.int32, 1)
    _same_device(words, lengths)
    b, cap = words.shape
    if lengths.shape != (b,):
        raise ValueError("lengths must be [B]")
    if words.device.type == "cpu":
        return _decode_plain(codec, words, lengths, t_len, rate)
    syms = torch.empty((t_len, b), dtype=torch.uint8, device=words.device)
    if t_len and b:
        _launch(f"{codec}_decode", words.device,
                words.data_ptr(), lengths.data_ptr(), syms.data_ptr(),
                t_len, b, cap, rate)
    return syms


def o0n_rans32_decode(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    """Fused order0n decode. words: [B, cap] uint16 in decode order (a lane
    reads 0 past cap); lengths: [B] int32. Returns syms [T, B] uint8, with 0
    past each lane's length."""
    return _decode("o0n", words, lengths, t_len, rate)


def o1n_rans32_decode(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    """Fused order1n decode, as ``o0n_rans32_decode``."""
    return _decode("o1n", words, lengths, t_len, rate)


def o2n_rans32_decode(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    """Fused order2n decode, as ``o0n_rans32_decode``."""
    return _decode("o2n", words, lengths, t_len, rate)


def o0c_rans32_decode(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    """Fused order0c decode, as ``o0n_rans32_decode``, for any cap: the
    reference's chunked decode for wide rows needs no kernel of its own."""
    return _decode("o0c", words, lengths, t_len, rate)


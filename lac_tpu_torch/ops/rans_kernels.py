"""order0n coding kernels: one wrapper per CUDA kernel, its plain PyTorch
version beside it, a launch count, and the codec gate.

Ports the order0n part of ``lac_tpu/ops/pallas_rans.py``:

- ``o0n_encode_intervals`` (:742-822) -> K1, ``lac_o0n_intervals``;
- ``rans32_encode_dense`` (:179-267) followed by ``compact_words``
  (:271-310) -> K2, ``rans32_encode``, one kernel whose result equals
  ``compact_words(rans32_encode_dense(...))``;
- ``o0n_rans32_decode`` (:849-1030) -> K3, ``lac_o0n_decode``;
- ``o0n_encode_fused`` (:825-846), the chain K1 -> K2;
- the codec gate ``o0n_decode_fits`` / ``_o0n_vmem_ok`` (:921-931) and the
  constants it reads (``_FUSED_VMEM_LIMIT`` :438, ``_FIFO`` :61,
  ``_MAX_KERNEL_LANES`` :313, ``_NV`` :626). The gate is the reference's
  pure formula, not a check of GPU memory: it decides which codec a
  container records (``runtime/turbo.py:123-128``).

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (``csrc/o0n_rans32.cu``) or raises; it never
falls back. ``launches[name]`` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import torch

from ..models.functional import NIB_V, Order0NibCDF, nib_state_to_coder
from . import _build

__all__ = [
    "o0n_encode_intervals",
    "rans32_encode",
    "o0n_rans32_decode",
    "o0n_encode_fused",
    "o0n_decode_fits",
    "launches",
    "reset_launches",
    "o0n_intervals_plain",
    "rans32_encode_plain",
    "o0n_decode_plain",
]

# reference constants (lac_tpu/ops/pallas_rans.py) read by the codec gate
_FIFO = 128
_FUSED_VMEM_LIMIT = 64 * 1024 * 1024
_MAX_KERNEL_LANES = 2048
_NV = NIB_V

launches = {"o0n_intervals": 0, "rans32_encode": 0, "o0n_decode": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------------------
# Codec gate (pure formula)
# --------------------------------------------------------------------------


def _o0n_vmem_ok(cap: int, b: int) -> bool:
    cap2 = (cap + 1) // 2
    need = 4 * (5 * cap2 * b + 5 * 8 * _NV * b + 2 * _FIFO * b + 16 * b)
    return need <= _FUSED_VMEM_LIMIT - 4 * 1024 * 1024


def o0n_decode_fits(cap: int, b: int) -> bool:
    """Whether the reference's order0n decode geometry admits (cap, B); the
    compressor records order0c instead when it does not."""
    return _o0n_vmem_ok(cap, min(b, _MAX_KERNEL_LANES))


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


def _launch(name: str, c_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on the device's current stream; raise on any
    non-zero cudaError_t. Counts the launch."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, c_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    launches[name] += 1


# --------------------------------------------------------------------------
# K1: order0n forward -> composed (lo12, f12)
# --------------------------------------------------------------------------


def _interval(eff: torch.Tensor, k: torch.Tensor):
    """(eff[k], eff[k+1] - eff[k]) per lane of a [B, 17] boundary table."""
    lo = eff.gather(1, k[:, None])[:, 0]
    return lo, eff.gather(1, k[:, None] + 1)[:, 0] - lo


def _search(eff: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The last k in [0, 16) with eff[k] <= v, per lane."""
    return (eff[:, :_NV] <= v[:, None]).sum(1) - 1


def o0n_intervals_plain(syms_tb: torch.Tensor, rate: int):
    """Plain version of K1: ``Order0NibCDF`` stepped over T, vectorised
    over the B lanes, giving each symbol's two nibble intervals composed."""
    t_len, b = syms_tb.shape
    dev = syms_tb.device
    model = Order0NibCDF(rate)
    state = model.init_state(b, dev)
    lane = torch.arange(b, device=dev)
    lo = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    fr = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    for t in range(t_len):
        s = syms_tb[t].to(torch.int64)
        h, l = s >> 4, s & 15
        sh, sl, _, _ = state
        loh, fh = _interval(nib_state_to_coder(sh), h)
        lol, fl = _interval(nib_state_to_coder(sl[lane, h]), l)
        lo[t] = (loh << 8) + fh * lol
        fr[t] = fh * fl
        state = model.update(state, s)
    return lo, fr


def o0n_encode_intervals(syms_tb: torch.Tensor, rate: int):
    """syms_tb: [T, B] uint8 bytes. Returns composed (lo12, f12) [T, B]
    int32 with total 2**16, the input of ``rans32_encode``."""
    _check(syms_tb, "syms_tb", torch.uint8, 2)
    if syms_tb.device.type == "cpu":
        return o0n_intervals_plain(syms_tb, rate)
    t_len, b = syms_tb.shape
    lo = torch.empty((t_len, b), dtype=torch.int32, device=syms_tb.device)
    fr = torch.empty((t_len, b), dtype=torch.int32, device=syms_tb.device)
    if t_len and b:
        _launch("o0n_intervals", "lac_o0n_intervals", syms_tb.device,
                syms_tb.data_ptr(), lo.data_ptr(), fr.data_ptr(), t_len, b, rate)
    return lo, fr


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
        _launch("rans32_encode", "lac_rans32_encode", lo_tb.device,
                lo_tb.data_ptr(), fr_tb.data_ptr(), lengths.data_ptr(),
                words.data_ptr(), nwords.data_ptr(), t_len, b, cap)
    return words, nwords


def o0n_encode_fused(syms_tb: torch.Tensor, lengths: torch.Tensor, rate: int, cap: int):
    """K1 then K2: [T, B] uint8 bytes -> (words [B, cap] uint16, nwords [B])."""
    lo, fr = o0n_encode_intervals(syms_tb, rate)
    return rans32_encode(lo, fr, lengths, cap)


# --------------------------------------------------------------------------
# K3: fused order0n model + rANS-32/16 decode
# --------------------------------------------------------------------------


def o0n_decode_plain(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    """Plain version of K3: ``Order0NibCDF`` stepped over T with the rANS
    decode, vectorised over the B lanes. A lane's state after its length is
    never read again, so the model steps every lane."""
    b, cap = words.shape
    dev = words.device
    model = Order0NibCDF(rate)
    state = model.init_state(b, dev)
    lane = torch.arange(b, device=dev)
    w = torch.cat([words.to(torch.int64), torch.zeros((b, 1), dtype=torch.int64, device=dev)], 1)
    pos = torch.full((b,), 2, dtype=torch.int64, device=dev)
    x = (w[:, min(0, cap)] << 16) | w[:, min(1, cap)]
    n = lengths.to(torch.int64)
    syms = torch.zeros((t_len, b), dtype=torch.uint8, device=dev)
    for t in range(t_len):
        active = t < n
        slot = x & 0xFFFF
        sh, sl, _, _ = state
        effh = nib_state_to_coder(sh)
        h = _search(effh, slot >> 8)
        loh, fh = _interval(effh, h)
        r = slot - (loh << 8)
        sc = fh[:, None] * nib_state_to_coder(sl[lane, h])  # sc[16] = fh << 8
        l = _search(sc, r)
        lo_s, f12 = _interval(sc, l)
        xn = (f12 * (x >> 16) + (r - lo_s)) & 0xFFFFFFFF
        refill = active & (xn < (1 << 16))
        wv = w.gather(1, pos.clamp(max=cap)[:, None])[:, 0]
        xn = torch.where(refill, ((xn << 16) | wv) & 0xFFFFFFFF, xn)
        pos = pos + refill.to(torch.int64)
        x = torch.where(active, xn, x)
        s = (h << 4) | l
        syms[t] = torch.where(active, s, 0).to(torch.uint8)
        state = model.update(state, s)
    return syms


def o0n_rans32_decode(words: torch.Tensor, lengths: torch.Tensor, t_len: int, rate: int):
    """Fused order0n decode. words: [B, cap] uint16 in decode order (a lane
    reads 0 past cap); lengths: [B] int32. Returns syms [T, B] uint8, with 0
    past each lane's length."""
    _check(words, "words", torch.uint16, 2)
    _check(lengths, "lengths", torch.int32, 1)
    _same_device(words, lengths)
    b, cap = words.shape
    if lengths.shape != (b,):
        raise ValueError("lengths must be [B]")
    if words.device.type == "cpu":
        return o0n_decode_plain(words, lengths, t_len, rate)
    syms = torch.empty((t_len, b), dtype=torch.uint8, device=words.device)
    if t_len and b:
        _launch("o0n_decode", "lac_o0n_decode", words.device,
                words.data_ptr(), lengths.data_ptr(), syms.data_ptr(),
                t_len, b, cap, rate)
    return syms

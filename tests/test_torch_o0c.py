"""The port's order0c model and the plain versions of its two kernels
(lac_tpu_torch.ops.rans_kernels), held exactly to lac_tpu: the functional
model, the Pallas kernels in interpret mode (the decode on both its fused
path and its chunked fallback) and the native coder. Every quantity is an
integer, so every comparison is exact. Inputs come from a numpy seed and go
to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lac_tpu.models.functional import Order0CDF as RefOrder0CDF
from lac_tpu.native.host import native_compress
from lac_tpu.ops import pallas_rans as ref_ops
from lac_tpu.stream.container import read_container as ref_read
from lac_tpu_torch import convert
from lac_tpu_torch.coder import rans as port_rans
from lac_tpu_torch.models import functional as F
from lac_tpu_torch.models.functional import Order0CDF
from lac_tpu_torch.ops import rans_kernels as rk
from lac_tpu_torch.runtime import engine, turbo
from lac_tpu_torch.smoke import smoke_corpus

RATE = 4
V, PB = 256, 16  # the turbo path's order0c alphabet and precision
B, T = 8, 256
# ragged, with 0, 1 and T-1; lanes 0 and 4 are random bytes and overflow CAP_OVER
LENGTHS = np.array([256, 0, 1, 255, 256, 137, 256, 60], np.int32)
CAP_OVER = 100


def _syms(seed, b=B, t_len=T):
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"def update(self, state, syms):\n    return state\n" * 8, np.uint8)
    syms = np.resize(text, (b, t_len)).T.copy()
    syms[:, 0] = rng.integers(0, 256, t_len)
    if b > 4:
        syms[:, 4] = rng.integers(0, 256, t_len)
        syms[:, 2] = (rng.integers(0, 4, t_len) * 17 + 64) & 0xFF  # skewed
        syms[:, 6] = 255  # one byte, the top of the alphabet, T times
    return syms


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.int32))


def _ref_words(syms, cap):
    words, nwords = ref_ops.o0c_encode_fused(_j(syms), _j(LENGTHS)[None, :], V, PB, RATE, cap)
    return np.asarray(words), np.asarray(nwords)


@pytest.mark.parametrize("k", [1, 17, 150])
def test_model_state_after_k_steps_equals_lac_tpu(k):
    """Step lac_tpu's model k times, carry its state over with convert, then
    step both packages on and compare states and CDFs."""
    syms = _syms(12, 3, k + 20)
    ref_m = RefOrder0CDF(vocab=V, prob_bits=PB, rate=RATE)
    upd, cdf = jax.jit(ref_m.update), jax.jit(ref_m.cdf)
    m = Order0CDF(rate=RATE)
    rst = ref_m.init_state(3)
    st = m.init_state(3)
    for t in range(k):
        rst = upd(rst, _j(syms[t]))
        st = m.update(st, _t(syms[t]))
    carried = convert.state_from_jax(*(np.asarray(a) for a in rst))
    assert torch.equal(st[0], carried[0]) and st[1] == carried[1] == k
    for t in range(k, k + 20):
        rst = upd(rst, _j(syms[t]))
        carried = m.update_(carried, _t(syms[t]))
        np.testing.assert_array_equal(m.cdf(carried).numpy(), np.asarray(cdf(rst)))
    back = convert.state_to_jax(carried)
    assert len(back) == 2 and back[1] == k + 20
    for a, b in zip(back, rst):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.int32


def test_pure_update_leaves_its_input_alone():
    m = Order0CDF(rate=RATE)
    st = m.init_state(2)
    before = st[0].clone()
    m.update(st, torch.tensor([0, 255]))
    assert torch.equal(st[0], before)
    m.update_(st, torch.tensor([0, 255]))
    assert not torch.equal(st[0], before)


def test_convert_checks_shapes():
    cdf, step = convert.state_to_jax(Order0CDF().init_state(2))
    assert cdf.shape == (2, 257)
    with pytest.raises(ValueError):
        convert.state_from_jax(cdf[:, :256], step)


def test_intervals_equal_pallas():
    syms = _syms(7)
    lo, fr = ref_ops.o0c_encode_intervals(_j(syms), V, PB, RATE)
    plo, pfr = rk.o0c_encode_intervals(_t(syms), RATE)
    assert plo.dtype == pfr.dtype == torch.int32 and plo.shape == (T, B)
    np.testing.assert_array_equal(plo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(pfr.numpy(), np.asarray(fr))
    assert int(pfr.min()) >= 1 and int((plo + pfr).max()) <= 1 << PB


@pytest.mark.parametrize("cap", [T + 2, CAP_OVER])
def test_encode_equals_pallas_fused(cap):
    syms = _syms(8)
    words, nwords = _ref_words(syms, cap)
    pw, pnw = rk.o0c_encode_fused(_t(syms), _t(LENGTHS), RATE, cap)
    assert pw.dtype == torch.uint16 and pw.shape == (B, cap)
    np.testing.assert_array_equal(pw.numpy(), words)
    np.testing.assert_array_equal(pnw.numpy(), nwords)
    if cap == CAP_OVER:
        assert (pnw.numpy() > cap).sum() == 2


@pytest.mark.parametrize("cap", [T + 2, CAP_OVER])
def test_decode_equals_pallas_fused_kernel(cap):
    """The reference's fused decode (B10); past cap its word buffer wraps,
    so lanes whose words overflow cap are left out."""
    syms = _syms(10)
    words, nwords = _ref_words(syms, cap)
    assert ref_ops._fused_vmem_ok(cap, B, V)
    ref = np.asarray(ref_ops.o0c_rans32_decode(jnp.asarray(words), _j(LENGTHS), T, V, PB, RATE))
    got = rk.o0c_rans32_decode(_t(words), _t(LENGTHS), T, RATE)
    assert got.dtype == torch.uint8 and got.shape == (T, B)
    fits = nwords <= cap
    np.testing.assert_array_equal(got.numpy()[:, fits], ref[:, fits])
    for lane in np.flatnonzero(fits):
        n = LENGTHS[lane]
        np.testing.assert_array_equal(got[:n, lane].numpy(), syms[:n, lane])
        assert not got[n:, lane].numpy().any()


@pytest.mark.parametrize("cap", [T + 2, CAP_OVER])
def test_decode_equals_pallas_chunked_kernel(monkeypatch, cap):
    """The reference's chunked fallback (B11), which it takes when its VMEM
    gate refuses the cap; past cap it repeats the last word, so lanes whose
    words overflow cap are left out."""
    syms = _syms(11)
    words, nwords = _ref_words(syms, cap)
    monkeypatch.setattr(ref_ops, "_fused_vmem_ok", lambda *a: False)
    ref = np.asarray(ref_ops.o0c_rans32_decode.__wrapped__(
        jnp.asarray(words), _j(LENGTHS), T, V, PB, RATE))
    got = rk.o0c_rans32_decode(_t(words), _t(LENGTHS), T, RATE).numpy()
    fits = nwords <= cap
    assert fits.sum() >= 6
    np.testing.assert_array_equal(got[:, fits], ref[:, fits])
    live = np.arange(T)[:, None] < LENGTHS[None, :]
    np.testing.assert_array_equal(got[:, fits], (syms * live)[:, fits])


def test_plain_decode_equals_spec_decoder():
    """The plain decode against the NumPy spec decoder driven by the port's
    Order0CDF: the model checked against the generic coder."""
    t_len = 128
    syms = _syms(13, 1, t_len)
    words, _ = rk.o0c_encode_fused(_t(syms), _t([t_len]).to(torch.int32), RATE, t_len + 2)
    m = Order0CDF(rate=RATE)
    holder = {"st": m.init_state(1)}

    def cdf_provider(t, out):
        if t > 0:
            holder["st"] = m.update(holder["st"], torch.tensor([out[-1]]))
        return m.cdf(holder["st"])[0].numpy()

    spec = port_rans.rans32_decode_np(words[0].numpy(), t_len, cdf_provider, PB)
    got = rk.o0c_rans32_decode(words, _t([t_len]).to(torch.int32), t_len, RATE)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.array(spec, np.uint8))
    np.testing.assert_array_equal(got[:, 0].numpy(), syms[:, 0])


def test_block_8192_container_beyond_the_fused_decode():
    """A block-8192 order0c container from lac_tpu's native coder, whose
    coded lanes need more words than the reference's fused decode holds at
    2048 lanes (2656), so that lac_tpu decodes it in chunks: the port
    decodes it to the input, on the whole and block by block."""
    rng = np.random.default_rng(14)
    six_bits = rng.integers(0, 64, 3 * 8192, dtype=np.uint8).tobytes()  # ~6 bits/byte
    data = smoke_corpus(8192) + six_bits + smoke_corpus(3000)
    ref = native_compress(data, block_size=8192, model="order0c")
    header, blocks = ref_read(ref)
    assert header.model_id == "order0c" and len(blocks) == 5
    coded_words = [len(b.payload) // 2 for b in blocks if b.token_count]
    assert len(coded_words) == 5 and sum(w > 2656 for w in coded_words) == 3
    assert not ref_ops._fused_vmem_ok(8192 // 2 + 3, 2048, V)
    assert engine.decompress_bytes(ref, device="cpu") == data
    assert turbo.turbo_decompress_blocks(ref, [4, 2], device="cpu") == [
        data[4 * 8192 :], data[2 * 8192 : 3 * 8192]]


def test_wrappers_check_arguments_and_count_no_plain_launches():
    before = dict(rk.launches)
    with pytest.raises(TypeError):
        rk.o0c_encode_intervals(torch.zeros((4, 2), dtype=torch.int32), RATE)
    with pytest.raises(ValueError):
        rk.o0c_encode_intervals(torch.zeros((4, 2), dtype=torch.uint8).t(), RATE)
    with pytest.raises(TypeError):
        rk.o0c_rans32_decode(torch.zeros((2, 8), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32), 4, RATE)
    with pytest.raises(ValueError):
        rk.o0c_rans32_decode(torch.zeros((2, 8), dtype=torch.uint16),
                             torch.zeros(3, dtype=torch.int32), 4, RATE)
    words, _ = rk.o0c_encode_fused(_t(_syms(1, 2, 16)), torch.full((2,), 16, dtype=torch.int32),
                                   RATE, 18)
    rk.o0c_rans32_decode(words, torch.full((2,), 16, dtype=torch.int32), 16, RATE)
    assert rk.launches == before  # CPU tensors run the plain versions


# --------------------------------------------------------------------------
# The packed-pair arithmetic of K8 and K9 (ops/csrc/o0c_rans32.cu), written
# out on int64 tensors holding the kernels' 32-bit words: word g of a lane's
# 128 holds entry 2g in its low half and 2g + 1 in its high half (K8's
# thread i holds words 4i .. 4i+3, K9's words 8i .. 8i+7). No card is
# needed for it.
# --------------------------------------------------------------------------

M = (1 << 16) - V
# every r the rate schedule reaches from base rates 0-12: 0 .. 16
SCHEDULE_RATES = sorted({F.adaptive_rate(base, t) for base in range(13) for t in range(0, 129, 16)})


def _half_signs(x):
    """prmt.b32 with selector 0xBB99: each half's bit 15 over the half."""
    return torch.where(x & 0x8000 != 0, 0xFFFF, 0) | torch.where(x & 0x80000000 != 0, 0xFFFF << 16, 0)


def _down_masks(s):
    """K8's [R, 128] down masks for bytes s [R]: s * 0x10001 plus each
    word's offset 0x7FFF8000 - k * 0x10001 (k = 2g), as a 32-bit sum, then
    each half's bit 15 over the half."""
    k = 2 * torch.arange(V // 2, dtype=torch.int64)
    return _half_signs((s[:, None] * 0x10001 + (0x7FFF8000 - k * 0x10001)) & 0xFFFFFFFF)


def _table_masks(s):
    """K9's [R, 128] down masks: thread i (16 entries) takes row n =
    clamp(s + 1 - 16i, 0, 16) of a 17-row table whose word p has its low
    half if n > 2p and its high half if n > 2p + 1."""
    n_, p = torch.arange(17)[:, None], torch.arange(8)[None, :]
    table = torch.where(n_ > 2 * p, 0xFFFF, 0) | torch.where(n_ > 2 * p + 1, 0xFFFF << 16, 0)
    n = torch.clamp(s[:, None] + 1 - 16 * torch.arange(16)[None, :], 0, 16)  # [R, 16]
    return table[n].reshape(len(s), V // 2)


def _packed_update(w, down, r):
    """state_update on words w with down masks ``down`` at rate r: q = st
    or M - st, x = ((q >> r) & mask) ^ down, then st + x - down."""
    mask = (0xFFFF >> r) * 0x10001 if r < 16 else 0
    q = (w & down) | ((M * 0x10001 - w) & ~down & 0xFFFFFFFF)
    return (w + (((q >> min(r, 16)) & mask) ^ down) - down) & 0xFFFFFFFF


def _pack(state):
    return state[:, 0:V:2] | (state[:, 1:V:2] << 16)


def _unpack(w):
    return torch.stack([w & 0xFFFF, w >> 16], 2).reshape(w.shape[0], V)


def test_schedule_rates_run_from_0_to_16():
    assert SCHEDULE_RATES == list(range(17))


@pytest.mark.parametrize("r", SCHEDULE_RATES)
def test_packed_pair_update_equals_cdf_state_update(r):
    """Every state value in [0, M] sits in a low half and in a high half,
    moving toward 0 (byte 255: every k <= s), toward M (byte 0: every k > 0)
    and on both sides of every byte s; K8's and K9's down masks are k <= s,
    and the words after one packed step equal functional.cdf_state_update's
    entries."""
    rows = torch.arange(256, dtype=torch.int64)
    k = torch.arange(V, dtype=torch.int64)
    states, syms = [], []
    for shift in (0, 1):  # each value in an even column, then in an odd one
        vals = (rows[:, None] * V + k[None, :] + shift) % (M + 1)
        for s in (rows, torch.full((256,), 255), torch.zeros(256, dtype=torch.int64)):
            states.append(vals)
            syms.append(s)
    state = torch.cat(states)
    s = torch.cat(syms)
    assert bool((torch.bincount(state[:, 0::2].flatten(), minlength=M + 1) > 0).all())
    assert bool((torch.bincount(state[:, 1::2].flatten(), minlength=M + 1) > 0).all())
    full = torch.cat([state, torch.full((state.shape[0], 1), M)], 1).to(torch.int32)
    want = F.cdf_state_update(full, s, r)
    for down in (_down_masks(s), _table_masks(s)):
        assert torch.equal(_unpack(down) == 0xFFFF, k[None, :] <= s[:, None])
        assert bool(((_unpack(down) == 0) | (_unpack(down) == 0xFFFF)).all())
        got = _unpack(_packed_update(_pack(state), down, r))
        assert torch.equal(got, want[:, :V].to(torch.int64)) and bool((want[:, V] == M).all())


def test_two_ballot_search_equals_the_plain_search():
    """K9's search, on half a warp: the owner is the last of 16 threads
    whose first boundary (entry 16i) is <= slot; its 16 boundaries go to
    the half's 16 lanes, and the count c of those <= slot gives s = 16 *
    owner + c - 1, lane c - 1 the interval's low end and lane c its high end,
    or entry 16 * owner + 16 when c = 16 (2^16 after byte 255). Held to the
    plain search on states the model reaches at base rates 0, 4 and 12, for
    slots across [0, 2^16)."""
    rng = np.random.default_rng(15)
    slots = torch.from_numpy(np.concatenate([[0, 1, 65534, 65535], rng.integers(0, 1 << 16, 252)]))
    syms = torch.from_numpy(np.stack([rng.integers(0, 256, 300), np.full(300, 255),
                                      np.zeros(300, np.int64), rng.integers(60, 70, 300)], 1))
    hl = torch.arange(16)
    counts = set()
    for rate in (0, 4, 12):
        model = Order0CDF(rate)
        state = model.init_state(4)
        for t in range(300):
            if t % 50 == 49:
                for lane in range(4):
                    st = (state[0][lane][None, :].expand(len(slots), -1), t)
                    eff = model.cdf(st).to(torch.int64)  # eff[:, 256] = 2^16
                    base = 16 * ((eff[:, 0:V:16] <= slots[:, None]).sum(1) - 1)
                    look = eff.gather(1, base[:, None] + hl[None, :])
                    after = eff.gather(1, base[:, None] + 16)[:, 0]
                    c = (look <= slots[:, None]).sum(1)
                    lo = look.gather(1, (c - 1)[:, None])[:, 0]
                    hi = torch.where(c < 16, look.gather(1, (c % 16)[:, None])[:, 0], after)
                    ps, plo, pfr = rk._o0c_search(model, st, slots)
                    assert torch.equal(base + c - 1, ps) and torch.equal(lo, plo.to(torch.int64))
                    assert torch.equal(hi - lo, pfr.to(torch.int64))
                    counts.update(c.tolist())
            state = model.update_(state, syms[t])
    assert {1, 16} <= counts  # the owner's first entry, and its last

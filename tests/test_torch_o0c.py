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

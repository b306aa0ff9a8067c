"""The port's order0n model and the plain versions of its three kernels
(lac_tpu_torch.ops.rans_kernels), held exactly to lac_tpu: the Pallas
kernels in interpret mode, the functional model and the NumPy rANS spec.
Inputs come from a numpy seed and go to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lac_tpu.coder import rans as ref_rans
from lac_tpu.models.functional import Order0NibCDF as RefOrder0NibCDF
from lac_tpu.ops import pallas_rans as ref_ops
from lac_tpu_torch import convert
from lac_tpu_torch.coder import rans as port_rans
from lac_tpu_torch.models.functional import Order0NibCDF
from lac_tpu_torch.ops import rans_kernels as rk

RATE = 4
B, T = 4, 256


def _syms(seed, b=B, t_len=T):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 256, (t_len, b)).astype(np.uint8)
    syms[:, 0] = (rng.integers(0, 4, t_len) * 17 + 64) & 0xFF  # skewed lane
    return syms


def _t(a):
    return torch.from_numpy(np.array(a))


def test_k1_intervals_equal_pallas():
    syms = _syms(7)
    lo, fr = ref_ops.o0n_encode_intervals(jnp.asarray(syms.astype(np.int32)), RATE)
    plo, pfr = rk.o0n_encode_intervals(_t(syms), RATE)
    np.testing.assert_array_equal(plo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(pfr.numpy(), np.asarray(fr))


@pytest.mark.parametrize("cap", [T + 2, 40])
def test_k2_encode_equals_pallas_fused(cap):
    """Ragged lengths with 0 and 1; at cap 40 two lanes overflow the row."""
    syms = _syms(8)
    lengths = np.array([256, 0, 1, 137], np.int32)
    words, nwords = ref_ops.o0n_encode_fused(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lengths)[None, :], RATE, cap)
    pw, pnw = rk.o0n_encode_fused(_t(syms), _t(lengths), RATE, cap)
    assert pw.dtype == torch.uint16 and pw.shape == (B, cap)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(words))
    np.testing.assert_array_equal(pnw.numpy(), np.asarray(nwords))
    if cap == 40:
        assert (pnw.numpy() > cap).sum() == 2


def test_k2_equals_numpy_spec_per_lane():
    syms = _syms(9)
    lengths = np.array([256, 3, 100, 1], np.int32)
    lo, fr = rk.o0n_encode_intervals(_t(syms), RATE)
    words, nwords = rk.rans32_encode(lo, fr, _t(lengths), T + 2)
    for lane in range(B):
        n = lengths[lane]
        spec = port_rans.rans32_encode_np(lo[:n, lane].numpy(), fr[:n, lane].numpy(), 16)
        assert nwords[lane] == len(spec)
        np.testing.assert_array_equal(words[lane, : len(spec)].numpy(), spec)
        assert not words[lane, len(spec):].numpy().any()


def test_k3_decode_equals_pallas():
    syms = _syms(10)
    lengths = np.array([256, 1, 0, 200], np.int32)
    words, _ = ref_ops.o0n_encode_fused(
        jnp.asarray(syms.astype(np.int32)), jnp.asarray(lengths)[None, :], RATE, T + 2)
    ref = np.asarray(ref_ops.o0n_rans32_decode(words, jnp.asarray(lengths), T, RATE))
    got = rk.o0n_rans32_decode(_t(np.asarray(words)), _t(lengths), T, RATE)
    assert got.dtype == torch.uint8 and got.shape == (T, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    for lane in range(B):
        n = lengths[lane]
        np.testing.assert_array_equal(got[:n, lane].numpy(), syms[:n, lane])
        assert not got[n:, lane].numpy().any()


def test_k3_decode_equals_spec_decoder():
    """K3's plain version against the NumPy spec decoder driven by the
    port's Order0NibCDF: composition checked against the generic coder."""
    t_len = 128
    syms = _syms(11, 1, t_len)
    words, _ = rk.o0n_encode_fused(_t(syms), _t([t_len]).to(torch.int32), RATE, t_len + 2)
    m = Order0NibCDF(rate=RATE)
    holder = {"st": m.init_state(1)}

    def cdf_provider(t, out):
        if t > 0:
            holder["st"] = m.update(holder["st"], torch.tensor([out[-1]]))
        return m.cdf(holder["st"])[0].numpy()

    spec = port_rans.rans32_decode_np(words[0].numpy(), t_len, cdf_provider, 16)
    got = rk.o0n_rans32_decode(words, _t([t_len]).to(torch.int32), t_len, RATE)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.array(spec, np.uint8))
    np.testing.assert_array_equal(got[:, 0].numpy(), syms[:, 0])


@pytest.mark.parametrize("k", [1, 17, 150])
def test_model_state_after_k_steps_equals_lac_tpu(k):
    syms = _syms(12, 3, k)
    ref_m = RefOrder0NibCDF(vocab=256, prob_bits=16, rate=RATE)
    upd = jax.jit(ref_m.update)
    rst = ref_m.init_state(3)
    m = Order0NibCDF(rate=RATE)
    st = m.init_state(3)
    for t in range(k):
        rst = upd(rst, jnp.asarray(syms[t].astype(np.int32)))
        st = m.update(st, _t(syms[t]))
    rsh, rsl, rcnt, rstep = (np.asarray(a) for a in rst)
    want = convert.state_from_jax(rsh, rsl, rcnt, int(rstep))
    for a, b in zip(st[:3], want[:3]):
        assert torch.equal(a, b)
    assert st[3] == want[3] == k
    np.testing.assert_array_equal(m.cdf(st).numpy(), np.asarray(jax.jit(ref_m.cdf)(rst)))
    back = convert.state_to_jax(st)
    for a, b in zip(back, (rsh, rsl, rcnt, rstep)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32


def test_decode_fits_grid_equals_lac_tpu():
    for cap in (3, 64, 515, 1024, 1026, 2051, 2052, 3000, 4099, 8195):
        for b in (1, 256, 2048, 8192, 32768):
            assert rk.o0n_decode_fits(cap, b) == ref_ops.o0n_decode_fits(cap, b), (cap, b)


@pytest.mark.parametrize("seed", range(3))
def test_rans32_spec_equals_lac_tpu(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    freq = rng.integers(1, 1 << 12, n)
    lo = rng.integers(0, (1 << 16) - freq)
    words = port_rans.rans32_encode_np(lo, freq, 16)
    np.testing.assert_array_equal(words, ref_rans.rans32_encode_np(lo, freq, 16))
    assert port_rans.RANS32_L == ref_rans.RANS32_L


def test_wrappers_check_arguments_and_count_no_plain_launches():
    before = dict(rk.launches)
    with pytest.raises(TypeError):
        rk.o0n_encode_intervals(torch.zeros((4, 2), dtype=torch.int32), RATE)
    with pytest.raises(ValueError):
        rk.o0n_encode_intervals(torch.zeros((4, 2), dtype=torch.uint8).t(), RATE)
    lo = torch.ones((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        rk.rans32_encode(lo, lo, torch.zeros(3, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        rk.rans32_encode(lo, lo, torch.zeros(2, dtype=torch.int32), 1)
    with pytest.raises(TypeError):
        rk.o0n_rans32_decode(torch.zeros((2, 8), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32), 4, RATE)
    rk.o0n_encode_fused(_t(_syms(1, 2, 16)), torch.full((2,), 16, dtype=torch.int32), RATE, 18)
    assert rk.launches == before  # CPU tensors run the plain versions

"""The port's order1n and order2n models and the plain versions of their four
kernels (lac_tpu_torch.ops.rans_kernels), held exactly to lac_tpu: the
Pallas kernels in interpret mode, the functional models and the codec
gates. Inputs come from a numpy seed and go to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lac_tpu.models import functional as ref_functional
from lac_tpu.ops import pallas_rans as ref_ops
from lac_tpu_torch import convert
from lac_tpu_torch.coder import rans as port_rans
from lac_tpu_torch.models import functional
from lac_tpu_torch.ops import rans_kernels as rk

RATE = 4
B, T = 8, 256
CODECS = ("o1n", "o2n")
MODEL = {"o1n": "Order1NibCDF", "o2n": "Order2NibCDF"}
# ragged, with 0 and 1; lanes 0 and 4 are random bytes and overflow CAP_OVER
LENGTHS = np.array([256, 0, 1, 137, 256, 200, 256, 60], np.int32)
CAP_OVER = 100


def _syms(seed, b=B, t_len=T):
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"def update(self, state, syms):\n    return state\n" * 8, np.uint8)
    syms = np.resize(text, (b, t_len)).T.copy()
    syms[:, 0] = rng.integers(0, 256, t_len)
    if b > 4:
        syms[:, 4] = rng.integers(0, 256, t_len)
        syms[:, 2] = (rng.integers(0, 4, t_len) * 17 + 64) & 0xFF  # skewed
        syms[:, 6] = ord("e")  # one context visited T times
    return syms


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_model(codec):
    return getattr(ref_functional, MODEL[codec])(vocab=256, prob_bits=16, rate=RATE)


def _ref_call(codec, what, *args):
    return getattr(ref_ops, f"{codec}_{what}")(*args)


@pytest.mark.parametrize("k", [1, 17, 150])
@pytest.mark.parametrize("codec", CODECS)
def test_model_state_after_k_steps_equals_lac_tpu(codec, k):
    """Step lac_tpu's model k times, carry its state over with convert, then
    step both packages on and compare states and CDFs."""
    syms = _syms(12, 3, k + 20)
    ref_m = _ref_model(codec)
    upd, cdf = jax.jit(ref_m.update), jax.jit(ref_m.cdf)
    m = getattr(functional, MODEL[codec])(rate=RATE)
    rst = ref_m.init_state(3)
    st = m.init_state(3)
    for t in range(k):
        rst = upd(rst, jnp.asarray(syms[t].astype(np.int32)))
        st = m.update(st, _t(syms[t]))
    carried = convert.state_from_jax(*(np.asarray(a) for a in rst))
    for a, b in zip(st, carried):
        assert torch.equal(a, b)
    for t in range(k, k + 20):
        rst = upd(rst, jnp.asarray(syms[t].astype(np.int32)))
        carried = m.update(carried, _t(syms[t]))
        np.testing.assert_array_equal(m.cdf(carried).numpy(), np.asarray(cdf(rst)))
    back = convert.state_to_jax(carried)
    assert len(back) == 5
    for a, b in zip(back, rst):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.int32


def test_pure_update_leaves_its_input_alone():
    m = functional.Order2NibCDF(rate=RATE)
    st = m.init_state(2)
    before = [a.clone() for a in st]
    m.update(st, torch.tensor([0x41, 0xF3]))
    for a, b in zip(st, before):
        assert torch.equal(a, b)


def test_convert_checks_shapes():
    st = functional.Order1NibCDF().init_state(2)
    sh, sl, cnth, cntl, prev_h = convert.state_to_jax(st)
    with pytest.raises(ValueError):
        convert.state_from_jax(sh, sl, cnth, cntl[:, :8], prev_h)
    with pytest.raises(ValueError):
        convert.state_from_jax(sh, sl)


@pytest.mark.parametrize("codec", CODECS)
def test_intervals_equal_pallas(codec):
    syms = _syms(7)
    lo, fr = _ref_call(codec, "encode_intervals", jnp.asarray(syms.astype(np.int32)), RATE)
    plo, pfr = getattr(rk, f"{codec}_encode_intervals")(_t(syms), RATE)
    np.testing.assert_array_equal(plo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(pfr.numpy(), np.asarray(fr))


@pytest.mark.parametrize("cap", [T + 2, CAP_OVER])
@pytest.mark.parametrize("codec", CODECS)
def test_encode_equals_pallas_fused(codec, cap):
    """Ragged lengths with 0 and 1; at CAP_OVER two lanes overflow the row."""
    syms = _syms(8)
    words, nwords = _ref_call(codec, "encode_fused", jnp.asarray(syms.astype(np.int32)),
                              jnp.asarray(LENGTHS)[None, :], RATE, cap)
    pw, pnw = getattr(rk, f"{codec}_encode_fused")(_t(syms), _t(LENGTHS), RATE, cap)
    assert pw.dtype == torch.uint16 and pw.shape == (B, cap)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(words))
    np.testing.assert_array_equal(pnw.numpy(), np.asarray(nwords))
    if cap == CAP_OVER:
        assert (pnw.numpy() > cap).sum() == 2


@pytest.mark.parametrize("codec", CODECS)
def test_decode_equals_pallas(codec):
    """At CAP_OVER, on every lane whose words fit: a lane that overflows is
    stored raw by the compressor and never decoded, and past cap the
    reference's word FIFO wraps where the port reads 0."""
    syms = _syms(10)
    words, nwords = getattr(rk, f"{codec}_encode_fused")(_t(syms), _t(LENGTHS), RATE, CAP_OVER)
    fits = nwords.numpy() <= CAP_OVER
    assert (~fits).sum() == 2
    ref = np.asarray(_ref_call(codec, "rans32_decode", jnp.asarray(words.numpy()),
                               jnp.asarray(LENGTHS), T, RATE))
    got = getattr(rk, f"{codec}_rans32_decode")(words, _t(LENGTHS), T, RATE)
    assert got.dtype == torch.uint8 and got.shape == (T, B)
    np.testing.assert_array_equal(got.numpy()[:, fits], ref[:, fits])
    for lane in np.nonzero(fits)[0]:
        n = LENGTHS[lane]
        np.testing.assert_array_equal(got[:n, lane].numpy(), syms[:n, lane])
        assert not got[n:, lane].numpy().any()


@pytest.mark.parametrize("codec", CODECS)
def test_plain_decode_equals_spec_decoder(codec):
    """The plain decode against the NumPy spec decoder driven by the port's
    model CDF: the hi_row/lo_row selectors checked against ``cdf``."""
    t_len = 96
    syms = _syms(11, 1, t_len)
    n = _t([t_len]).to(torch.int32)
    words, _ = getattr(rk, f"{codec}_encode_fused")(_t(syms), n, RATE, t_len + 2)
    m = getattr(functional, MODEL[codec])(rate=RATE)
    holder = {"st": m.init_state(1)}

    def cdf_provider(t, out):
        if t > 0:
            holder["st"] = m.update(holder["st"], torch.tensor([out[-1]]))
        return m.cdf(holder["st"])[0].numpy()

    spec = port_rans.rans32_decode_np(words[0].numpy(), t_len, cdf_provider, 16)
    np.testing.assert_array_equal(np.array(spec, np.uint8), syms[:, 0])
    got = getattr(rk, f"{codec}_rans32_decode")(words, n, t_len, RATE)
    np.testing.assert_array_equal(got[:, 0].numpy(), syms[:, 0])


@pytest.mark.parametrize("codec", ["o0n", "o1n", "o2n"])
def test_decode_fits_grid_equals_lac_tpu(codec):
    ours, ref = getattr(rk, f"{codec}_decode_fits"), getattr(ref_ops, f"{codec}_decode_fits")
    for cap in (3, 64, 515, 1024, 1026, 2051, 2052, 3000, 4099, 8195, 16387, 40000):
        for b in (1, 256, 2048, 8192, 32768):
            assert ours(cap, b) == ref(cap, b), (codec, cap, b)


def test_order2n_gate_admits_block_8192_where_order1n_refuses():
    cap = 8192 // 2 + 3  # the cap bucket of block 8192
    assert rk.o2n_decode_fits(cap, 8192) and not rk.o1n_decode_fits(cap, 8192)
    assert not rk.o0n_decode_fits(cap, 8192)
    assert rk._nib_sub_lanes(rk._o2n_vmem_ok, cap) == ref_ops._nib_sub_lanes(
        ref_ops._o2n_vmem_ok, cap) == 512


def test_wrappers_count_no_plain_launches():
    before = dict(rk.launches)
    syms = _t(_syms(1, 2, 16))
    n = torch.full((2,), 16, dtype=torch.int32)
    for codec in CODECS:
        words, _ = getattr(rk, f"{codec}_encode_fused")(syms, n, RATE, 18)
        getattr(rk, f"{codec}_rans32_decode")(words, n, 16, RATE)
        with pytest.raises(TypeError):
            getattr(rk, f"{codec}_encode_intervals")(syms.to(torch.int32), RATE)
        with pytest.raises(TypeError):
            getattr(rk, f"{codec}_rans32_decode")(words.to(torch.int32), n, 16, RATE)
    assert rk.launches == before  # CPU tensors run the plain versions

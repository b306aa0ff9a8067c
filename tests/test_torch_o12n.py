"""The port's order1n and order2n models and the plain versions of their four
kernels (lac_tpu_torch.ops.rans_kernels), held exactly to lac_tpu: the
Pallas kernels in interpret mode, the functional models and the codec
gates. Inputs come from a numpy seed and go to both packages. Then the
arithmetic of the nibble kernels' template, for order0n too (its Pallas
comparisons are in test_torch_o0n.py)."""

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
MODEL = {"o0n": "Order0NibCDF", "o1n": "Order1NibCDF", "o2n": "Order2NibCDF"}
# the models of the nibble kernels' template (K1 and K3-K7)
TEMPLATE_CODECS = ("o0n", *CODECS)
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


# --------------------------------------------------------------------------
# K1 and K3-K7 (ops/csrc/nib_rans32.cu, one template over the numbers of hi
# rows and lo contexts) mirrored in torch on int64 tensors that hold the
# kernels' 32-bit words: a thread of a lane's group holds words 2j and
# 2j + 1 of a row, word p holding st[2p] in its low half and st[2p + 1] in
# its high half; the half of st[0] holds the row's visit count (for
# order0n's one hi row, the step). No card is needed for these.
# --------------------------------------------------------------------------

NIB_TOP = 1 << 15
# every r the visit-count rates reach from base rates 0-12: 0 .. 16
NIB_RATES = sorted({functional.adaptive_rate(base, c) for base in range(13)
                    for c in (0, 16, 32, 64, 128)})


def _half_signs(x):
    """prmt.b32 with selector 0xBB99: each half's bit 15 over the half."""
    return (torch.where(x & 0x8000 != 0, 0xFFFF, 0)
            | torch.where(x & 0x80000000 != 0, 0xFFFF << 16, 0))


def _pair_update(w, n, k0, r):
    """row_update on words w whose low half is state k0 and high half
    k0 + 1, toward nibble n at shift r: the down mask is the halves' sign
    bits of n * 0x10001 + 0x7FFF8000 - k0 * 0x10001; q = st or 2^15 - st;
    st + (((q >> r) & mask) ^ down) - down."""
    down = _half_signs(torch.tensor((n * 0x10001 + 0x7FFF8000 - k0 * 0x10001) & 0xFFFFFFFF))
    mask = (0xFFFF >> r) * 0x10001 if r < 16 else 0
    q = (w & down) | ((0x80008000 - w) & ~down & 0xFFFFFFFF)
    return (w + (((q >> min(r, 16)) & mask) ^ down) - down) & 0xFFFFFFFF


def _popc(x, bits=32):
    return sum((x >> i) & 1 for i in range(bits))


def _funnel_r(lo, hi, s):
    return ((hi << 32 | lo) >> s) & 0xFFFFFFFF


def test_nibble_rates_run_from_0_to_16():
    assert NIB_RATES == list(range(17))


@pytest.mark.parametrize("r", NIB_RATES)
def test_nibble_pair_update_equals_nib_state_update(r):
    """Every state value in [0, 2^15] sits in a low half and in a high half,
    in a word that moves toward 0 (both k <= n), toward 2^15 (both k > n)
    and split (k0 = n: the low half down, the high half up); the words after
    one packed step equal functional.nib_state_update's states."""
    v = torch.arange(NIB_TOP + 1, dtype=torch.int64)
    other = (v * 7919) % (NIB_TOP + 1)
    for k0, n in ((0, 15), (4, 9), (14, 0), (6, 6), (14, 14)):
        for lo, hi in ((v, other), (other, v)):
            state = torch.zeros((len(v), 17), dtype=torch.int64)
            state[:, 16] = NIB_TOP
            state[:, k0], state[:, k0 + 1] = lo, hi
            nib = torch.full((len(v),), n)
            want = functional.nib_state_update(state.to(torch.int32), nib.to(torch.int32), r)
            got = _pair_update(lo | hi << 16, n, k0, r)
            assert torch.equal(got & 0xFFFF, want[:, k0].to(torch.int64))
            assert torch.equal(got >> 16, want[:, k0 + 1].to(torch.int64))


@pytest.mark.parametrize("rate", [0, 4, 12])
@pytest.mark.parametrize("codec", TEMPLATE_CODECS)
def test_count_slot_stands_for_entry_0(codec, rate):
    """st[0] starts at 0 and moves toward 0, so it is always 0 (and st[16]
    always 2^15): the kernels keep the row's visit count in its half. The
    count stops at 128, where the rate stops growing, so rate_at(base, count)
    = base + the bit length of count >> 4 (shift_of) is the true count's;
    the packed update leaves the high half exact with the count in the low
    one, and the count's boundary reads as st[0]'s: ((c * 240) >> 15) = 0.
    In each model a one-byte lane visits its hi row and its lo row past 255
    times, and the capped counts give the true counts' rates. order0n's hi
    row adapts at the step's rate: its count half, advanced once a step and
    capped, gives adaptive_rate(rate, step) at every step."""
    for r in NIB_RATES:
        for n in range(16):
            st = torch.zeros((1, 17), dtype=torch.int32)
            st[0, 16] = NIB_TOP
            out = functional.nib_state_update(st, torch.tensor([n], dtype=torch.int32), r)
            assert int(out[0, 0]) == 0 and int(out[0, 16]) == NIB_TOP
    visits = torch.arange(5000)
    c = torch.clamp(visits, max=128)
    bitlen = torch.tensor([int(x).bit_length() for x in (c >> 4)])
    assert torch.equal(torch.clamp(rate + bitlen, max=16),
                       torch.clamp(functional.adaptive_rate(rate, visits), max=16))
    assert not ((c * 240) >> 15).any()
    hi = torch.arange(0, NIB_TOP + 1, 97, dtype=torch.int64)
    for count in (0, 1, 127, 128):
        for n in range(16):
            r = min(rate + (count >= 16) + (count >= 32) + (count >= 64) + (count >= 128), 16)
            got = _pair_update(count | hi << 16, n, 0, r)
            st = torch.zeros((len(hi), 17), dtype=torch.int32)
            st[:, 1], st[:, 16] = hi.to(torch.int32), NIB_TOP
            want = functional.nib_state_update(st, torch.full((len(hi),), n, dtype=torch.int32), r)
            assert torch.equal(got >> 16, want[:, 1].to(torch.int64))
            assert bool(((got & 0xFFFF) <= count).all())  # no borrow into st[1]
    model = getattr(functional, MODEL[codec])(rate)
    state = model.init_state(1)
    hi_count = 0  # order0n's hi row: its count half, one more each step
    for _ in range(300):
        if codec == "o0n":
            assert min(rate + (hi_count >> 4).bit_length(), 16) == min(
                functional.adaptive_rate(rate, state[3]), 16)
            hi_count = min(hi_count + 1, 128)
        state = model.update_(state, torch.tensor([ord("e")]))
    # the hi rows' and the lo rows' visit counts (order0n: the step, and
    # its lo rows' counts)
    for cnt in ((torch.tensor(state[3]), state[2]) if codec == "o0n" else state[2:4]):
        true = int(cnt.max())
        assert true > 255
        capped = min(true, 128)
        assert min(rate + (capped >> 4).bit_length(), 16) == min(
            int(functional.adaptive_rate(rate, torch.tensor(true))), 16)


def _row_pair(words, n):
    """K6's (st[n], st[n+1]) from a row's 8 words [R, 8]: the owner n >> 2
    picks word n >> 1 and the one after it (2^15 after word 7) and shifts
    by 16 for odd n."""
    nb = torch.cat([words[:, 1:], torch.full_like(words[:, :1], NIB_TOP)], 1)
    p = n >> 1
    a = words.gather(1, p[:, None])[:, 0]
    b = nb.gather(1, p[:, None])[:, 0]
    return _funnel_r(a, b, (n & 1) * 16)


def _row_search(eff, v):
    """K7's search of a boundary row eff [R, 17] (eff[:, 16] = 256) for v
    [R] in [0, 255]: the owner is the last of 4 threads whose first
    boundary eff[4j] is <= v; it counts its e1..e3 <= v as the guard bits of
    three 10-bit fields of v + 512 less e, and funnel-shifts (eff[4o + c],
    eff[4o + c + 1]) out of its five boundaries packed at 9 bits."""
    owner = (eff[:, 0:16:4] <= v[:, None]).sum(1) - 1
    e = eff.gather(1, 4 * owner[:, None] + torch.arange(5)[None, :])
    fields = e[:, 1] + (e[:, 2] << 10) + (e[:, 3] << 20)
    le = (v * 0x100401 + 0x20080200 - fields) & 0xFFFFFFFF
    c = _popc(le & 0x20080200)
    lo = (e[:, 0] + (e[:, 1] << 9) + (e[:, 2] << 18) + (e[:, 3] << 27)) & 0xFFFFFFFF
    hi = (e[:, 3] >> 5) + (e[:, 4] << 4)
    pair = _funnel_r(lo, hi, 9 * c) & 0x3FFFF
    return 4 * owner + c, pair & 511, pair >> 9


def test_guard_bit_fields_count_boundaries_up_to_v():
    """Each 10-bit field of (v + 512) * 0x100401 less (e1, e2, e3) keeps its
    bit 9 exactly where e <= v, for every v in [0, 255] and e in [0, 256]."""
    v = torch.arange(256)[:, None]
    e = torch.arange(257)[None, :]
    for shift in (0, 10, 20):
        le = (v * 0x100401 + 0x20080200 - (e << shift)) & 0xFFFFFFFF
        assert torch.equal((le >> (shift + 9)) & 1 == 1, e <= v)
        others = le & (0x20080200 & ~(1 << (shift + 9)))
        assert torch.equal(others, torch.full_like(others, 0x20080200 & ~(1 << (shift + 9))))


def test_reciprocal_table_divides_exactly():
    """floor(r / f) = the high word of 2r * ceil(2^31 / f) for f in 1..256
    and every r < 256 f, the remainders K7's lo search divides."""
    for f in range(1, 257):
        r = torch.arange(256 * f, dtype=torch.int64)
        rcp = (0x80000000 + f - 1) // f
        assert torch.equal(((2 * r) * rcp) >> 32, r // f)


@pytest.mark.parametrize("rate", [0, 4, 12])
@pytest.mark.parametrize("codec", TEMPLATE_CODECS)
def test_group_search_and_pairs_equal_the_plain_versions(codec, rate):
    """The decoders' two searches (the hi nibble on slot >> 8, the lo nibble
    on floor(r / f_h) through the reciprocal table) give rk._nib_search's
    byte and interval, and the intervals kernels' pairs give the states
    either side of each nibble, on order0n, order1n and order2n states
    (through model.hi_row and lo_row) at base rates 0, 4 and 12 (random,
    skewed and repeated-byte lanes, whose counts pass 128) for slots across
    [0, 2^16)."""
    rng = np.random.default_rng(rate)
    slots = torch.from_numpy(np.concatenate([[0, 1, 255, 256, 65534, 65535],
                                             rng.integers(0, 1 << 16, 250)]))
    syms = torch.from_numpy(_syms(30 + rate, 8, 400).T.copy())  # [B, T]
    model = getattr(functional, MODEL[codec])(rate)
    state = model.init_state(8)
    counts = set()
    for t in range(400):
        if t % 100 == 99:
            for lane in range(8):
                st = tuple(a[lane:lane + 1].expand(len(slots), *a.shape[1:])
                           if isinstance(a, torch.Tensor) else a for a in state)
                want = rk._nib_search(model, st, slots)
                effh = functional.nib_state_to_coder(model.hi_row(st)).to(torch.int64)
                h, loh, hih = _row_search(effh, slots >> 8)
                fh = hih - loh
                r = slots - (loh << 8)
                q = ((2 * r) * ((0x80000000 + fh - 1) // fh)) >> 32
                lo_row = model.lo_row(st, h)
                effl = functional.nib_state_to_coder(lo_row).to(torch.int64)
                l, lol, hil = _row_search(effl, q)
                assert torch.equal((h << 4) | l, want[0].to(torch.int64))
                assert torch.equal((loh << 8) + fh * lol, want[1].to(torch.int64))
                assert torch.equal(fh * (hil - lol), want[2].to(torch.int64))
                words = lo_row[:, 0:16:2].to(torch.int64) | lo_row[:, 1:17:2].to(torch.int64) << 16
                nib = torch.arange(len(slots)) % 16
                pair = _row_pair(words, nib)
                assert torch.equal(pair & 0xFFFF, lo_row.gather(1, nib[:, None])[:, 0])
                assert torch.equal(pair >> 16, lo_row.gather(1, nib[:, None] + 1)[:, 0])
                counts.update(h.tolist())
        state = model.update_(state, syms[:, t])
    assert len(counts) > 8


# the kernels' hi rows and lo contexts: kHiRows and kLoCtx of the template
_HI_ROWS = {"o0n": 1, "o1n": 16, "o2n": 16}
_LO_CTX = {"o0n": 16, "o1n": 16, "o2n": 64}


def _hi_row(codec, ph):
    """The kernels' hi_ctx<kHiRows>(ph): ph, or order0n's one row 0."""
    return 0 if codec == "o0n" else ph


def _lo_row(codec, h, ph):
    """The kernels' kHiRows + lo_ctx<kLoCtx>(h, ph): the row of a lane's
    tables (its hi rows, then its lo rows) that byte (h, .) uses after hi
    nibble ph."""
    return _HI_ROWS[codec] + (h * 4 + (ph >> 2) if codec == "o2n" else h)


@pytest.mark.parametrize("codec", TEMPLATE_CODECS)
def test_template_lo_row_picks_the_models_lo_row(codec):
    """A lane's tables in the kernels are its hi rows, then its lo rows
    (kHiRows + kLoCtx of them: 1 + 16 for order0n, 16 + 16 for order1n,
    16 + 64 for order2n). For every hi nibble h after every previous hi
    nibble ph, row hi_ctx(ph) (ph, or order0n's row 0) is the row
    model.hi_row returns and row kHiRows + lo_ctx(h, ph), never a hi row,
    the one model.lo_row returns; every table entry is distinct, so no
    other row can stand in for it."""
    model = getattr(functional, MODEL[codec])(RATE)
    state = model.init_state(3)
    sh = torch.arange(state[0].numel(), dtype=torch.int32).reshape(state[0].shape)
    sl = sh.numel() + torch.arange(state[1].numel(), dtype=torch.int32).reshape(state[1].shape)
    tables = torch.cat([sh.reshape(3, -1, 17), sl], 1)
    assert tables.shape[1] == _HI_ROWS[codec] + _LO_CTX[codec]
    for ph in range(16):
        if codec == "o0n":  # no previous nibble in its state
            st = (sh, sl, *state[2:])
        else:
            st = (sh, sl, state[2], state[3], torch.full_like(state[4], ph))
        assert torch.equal(tables[:, _hi_row(codec, ph)], model.hi_row(st))
        for h in range(16):
            row = _lo_row(codec, h, ph)
            assert _HI_ROWS[codec] <= row < tables.shape[1]
            assert torch.equal(tables[:, row], model.lo_row(st, torch.full((3,), h)))

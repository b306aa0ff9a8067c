"""lac_tpu_torch's CUDA kernels on the card. Marked ``gpu``; each test skips
inside itself when no CUDA device is present, so every pytest worker
collects the same tests. Imports no JAX, so it runs on a machine without
it: ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from lac_tpu_torch.ops import rans_kernels as rk
from lac_tpu_torch.runtime import engine, turbo

pytestmark = pytest.mark.gpu

RATE = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(t_len, b, seed=0):
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"the quick brown fox jumps over the lazy dog; " * 64, np.uint8)
    syms = np.resize(text, (t_len, b)).copy()
    syms[:, 1::3] = rng.integers(0, 256, (t_len, len(range(1, b, 3))), dtype=np.uint8)
    lengths = rng.integers(0, t_len + 1, b).astype(np.int32)
    lengths[:3] = (0, 1, t_len - 1)
    syms[:, 3], lengths[3] = ord("e"), t_len  # one context visited T times
    return syms, lengths


@pytest.mark.parametrize("codec", ["o0n", "o1n", "o2n", "o0c"])
@pytest.mark.parametrize("t_len,b,cap", [(256, 67, 258), (1024, 130, 515), (300, 5, 40)])
def test_kernels_equal_plain_versions(cuda, t_len, b, cap, codec):
    syms, lengths = _inputs(t_len, b)
    s, n = torch.from_numpy(syms).to(cuda), torch.from_numpy(lengths).to(cuda)
    before = dict(rk.launches)
    lo, fr = getattr(rk, f"{codec}_encode_intervals")(s, RATE)
    plo, pfr = getattr(rk, f"{codec}_intervals_plain")(s, RATE)
    assert torch.equal(lo, plo) and torch.equal(fr, pfr)
    words, nwords = rk.rans32_encode(lo, fr, n, cap)
    pw, pnw = rk.rans32_encode_plain(lo, fr, n, cap)
    assert torch.equal(words.to(torch.int32), pw.to(torch.int32))
    assert torch.equal(nwords, pnw)
    out = getattr(rk, f"{codec}_rans32_decode")(words, n, t_len, RATE)
    assert torch.equal(out, getattr(rk, f"{codec}_decode_plain")(words, n, t_len, RATE))
    assert torch.equal(out[:, 3], s[:, 3])
    torch.cuda.synchronize()
    assert {k: rk.launches[k] - before[k] for k in before if rk.launches[k] != before[k]} == {
        f"{codec}_intervals": 1, "rans32_encode": 1, f"{codec}_decode": 1}


@pytest.mark.parametrize("t_len,b,cap", [(1000, 101, 300), (4096, 45, 2051), (70, 33, 2)])
def test_rans32_encode_exact_at_ragged_empty_and_overflowing_lanes(cuda, t_len, b, cap):
    """K2 (one warp of lanes a block) on a B that is no multiple of 32:
    ragged lengths, an empty lane, a single-byte lane, lanes of random
    bytes whose words overflow cap (the ring's rotation) and lanes that
    fit; words and nwords exactly those of its plain version."""
    syms, lengths = _inputs(t_len, b, seed=7)
    lengths[4], lengths[5] = t_len, 1  # a random lane at full length; one byte
    s, n = torch.from_numpy(syms).to(cuda), torch.from_numpy(lengths).to(cuda)
    lo, fr = rk.o0n_encode_intervals(s, RATE)
    words, nwords = rk.rans32_encode(lo, fr, n, cap)
    pw, pnw = rk.rans32_encode_plain(lo, fr, n, cap)
    torch.cuda.synchronize()
    assert torch.equal(words.to(torch.int32), pw.to(torch.int32))
    assert torch.equal(nwords, pnw)
    assert int(nwords[0]) == 2 and int(nwords[1]) <= 3  # the empty and one-byte lanes
    assert bool((nwords > cap).any()) and bool((nwords <= cap).any())


def test_o0c_decode_at_block_8192_cap(cuda):
    """K9 at the cap of block 8192's words (4099), where lac_tpu decodes in
    chunks: one kernel for every cap, equal to its plain version."""
    t_len, b, cap = 8192, 40, 4099
    syms, lengths = _inputs(t_len, b, seed=2)
    rng = np.random.default_rng(3)
    syms[:, 5::3] = rng.integers(0, 64, (t_len, len(range(5, b, 3))), dtype=np.uint8)
    lengths[5::3] = t_len  # about 6 bits a byte: more words than 2656, fewer than cap
    lengths[4] = t_len  # random bytes: more words than cap
    s, n = torch.from_numpy(syms).to(cuda), torch.from_numpy(lengths).to(cuda)
    words, nwords = rk.o0c_encode_fused(s, n, RATE, cap)
    out = rk.o0c_rans32_decode(words, n, t_len, RATE)
    assert torch.equal(out, rk.o0c_decode_plain(words, n, t_len, RATE))
    fits = nwords <= cap
    assert bool(((nwords > 2656) & fits).any()) and bool((~fits).any())
    live = torch.arange(t_len, device=cuda)[:, None] < n[None, :]
    assert bool(((out == s) | ~live | ~fits[None, :]).all())


def _o0c_lanes(t_len, b, seed):
    """``_inputs`` with a lane of byte 255 (hi = 2^16 at every step) and a
    lane of byte 0 (lo = 0 at every step), both at full length, and lane 7
    of random bytes at full length (about 8 bits a byte, so T / 2 words)."""
    syms, lengths = _inputs(t_len, b, seed)
    syms[:, 4], syms[:, 5] = 255, 0
    lengths[4] = lengths[5] = lengths[7] = t_len
    return syms, lengths


@pytest.mark.parametrize("rate", range(13))
def test_o0c_kernels_exact_at_every_base_rate(cuda, rate):
    """K8 and K9, which hold the CDF as packed 16-bit pairs, bit-equal to
    their plain versions at base rates 0-12, so r runs from 0 (the one-hot
    jump) to 16 (a half's shift empties it): B 13 (odd, so one of K9's
    warps codes a single lane, and no multiple of K8's 8 lanes a block or
    K9's 16), T 300 (no multiple of 32 or 16); ragged, empty, single-byte,
    all-255, all-0 and cap-overflowing lanes."""
    t_len, b, cap = 300, 13, 140
    syms, lengths = _o0c_lanes(t_len, b, seed=rate)
    s, n = torch.from_numpy(syms).to(cuda), torch.from_numpy(lengths).to(cuda)
    lo, fr = rk.o0c_encode_intervals(s, rate)
    plo, pfr = rk.o0c_intervals_plain(s, rate)
    assert torch.equal(lo, plo) and torch.equal(fr, pfr)
    assert bool((lo[:, 4] + fr[:, 4] == 1 << 16).all()) and bool((lo[:, 5] == 0).all())
    words, nwords = rk.rans32_encode(lo, fr, n, cap)
    out = rk.o0c_rans32_decode(words, n, t_len, rate)
    assert torch.equal(out, rk.o0c_decode_plain(words, n, t_len, rate))
    fits = nwords <= cap
    assert bool((~fits).any()) and bool(fits[[0, 1, 3, 4, 5]].all())
    live = torch.arange(t_len, device=cuda)[:, None] < n[None, :]
    assert bool(((out == s) | ~live | ~fits[None, :]).all())
    assert bool(((out == 0) | live).all())


# every (h, prev_h >> 2) pair, so every one of order2n's 64 lo contexts
# (and every h, so every one of order0n's and order1n's 16): a byte of hi
# nibble 4q (class q), then a byte of hi nibble h
_ALL_LO_CONTEXTS = np.array([x for q in range(4) for h in range(16)
                             for x in (q << 6 | h, h << 4 | (q * 5 + h) % 16)], np.uint8)
_LO_CONTEXTS = {"o0n": 16, "o1n": 16, "o2n": 64}


def _o12n_lanes(t_len, b, seed):
    """``_inputs`` (lane 3 one byte, so one context visited T times and
    every step reads the rows the step before wrote) with lane 4 cycling
    through every lo context and lane 7 random bytes, both at full length."""
    syms, lengths = _inputs(t_len, b, seed)
    syms[:, 4] = np.resize(_ALL_LO_CONTEXTS, t_len)
    lengths[4] = lengths[7] = t_len
    return syms, lengths


def _o12n_exact(cuda, codec, syms, lengths, cap, rate):
    """K1 and K3 (o0n), K4 and K5 (o1n) or K6 and K7 (o2n) against their
    plain versions, and the round trip of the lanes whose words fit cap;
    returns the words' counts."""
    t_len = syms.shape[0]
    s, n = torch.from_numpy(syms).to(cuda), torch.from_numpy(lengths).to(cuda)
    lo, fr = getattr(rk, f"{codec}_encode_intervals")(s, rate)
    plo, pfr = getattr(rk, f"{codec}_intervals_plain")(s, rate)
    assert torch.equal(lo, plo) and torch.equal(fr, pfr)
    words, nwords = rk.rans32_encode(lo, fr, n, cap)
    out = getattr(rk, f"{codec}_rans32_decode")(words, n, t_len, rate)
    assert torch.equal(out, getattr(rk, f"{codec}_decode_plain")(words, n, t_len, rate))
    fits = nwords <= cap
    live = torch.arange(t_len, device=cuda)[:, None] < n[None, :]
    assert bool(((out == s) | ~live | ~fits[None, :]).all())
    assert bool(((out == 0) | live).all())
    return nwords


def _lo_contexts(codec, syms):
    """The lo contexts of order0n and order1n (h) or order2n
    (h*4 + (prev_h >> 2)) that a [T] lane visits, and how often."""
    h = syms.astype(np.int64) >> 4
    prev = np.concatenate([[0], h[:-1]])
    ctx = h * 4 + (prev >> 2) if codec == "o2n" else h
    return np.bincount(ctx, minlength=_LO_CONTEXTS[codec])


@pytest.mark.parametrize("rate", range(13))
@pytest.mark.parametrize("codec", ["o0n", "o1n", "o2n"])
def test_o2n_kernels_exact_at_every_base_rate(cuda, codec, rate):
    """K1 and K3 (order0n), K4 and K5 (order1n), K6 and K7 (order2n), which
    spread a lane over 4 threads and keep each row's visit count (order0n's
    hi row: the step) in the half of its state 0, bit-equal to their plain
    versions at base rates 0-12 (r from 0 to 16): B 13 (no multiple of the
    8 lanes a block, so the last block's warp has lanes past B), T 300 (no
    multiple of the 4 steps a turn); an empty, a one-byte and ragged lanes,
    lanes that overflow cap, a lane through all 16 hi nibbles and all 16 or
    64 lo contexts and one of a single byte, whose contexts count past 255
    visits and whose lo row repeats at every step."""
    t_len, b, cap = 300, 13, 140
    syms, lengths = _o12n_lanes(t_len, b, seed=rate)
    assert bool((_lo_contexts(codec, syms[:, 4]) > 0).all())
    assert _lo_contexts(codec, syms[:, 3]).max() > 255
    nwords = _o12n_exact(cuda, codec, syms, lengths, cap, rate)
    assert bool((nwords > cap).any()) and bool((nwords[[0, 1]] <= cap).all())


@pytest.mark.parametrize("t_len,b,cap", [(1000, 130, 515), (8192, 21, 4099)])
@pytest.mark.parametrize("codec", ["o0n", "o1n", "o2n"])
def test_o2n_kernels_exact_at_block_8192_and_ragged_widths(cuda, codec, t_len, b, cap):
    """K1 and K3-K7 at B 130 (16 blocks and 2 lanes) and at T 8192 with cap
    4099, equal to their plain versions. order2n's codec gate admits that
    block (o2n_decode_fits); order0n's and order1n's record order0c there at
    the corpus's widths, so for K1, K3, K4 and K5 it is a test of the
    kernels alone (T 8192 steps of order0n's hi row, its count half capped)."""
    syms, lengths = _o12n_lanes(t_len, b, seed=5)
    assert codec != "o2n" or rk.o2n_decode_fits(cap, b) or t_len != 8192
    nwords = _o12n_exact(cuda, codec, syms, lengths, cap, RATE)
    assert bool((nwords > cap).any()) and bool((nwords <= cap).any())


@pytest.mark.parametrize("model", ["order0n", "order1n", "order2n", "order0c"])
@pytest.mark.parametrize("block", [1024, 4096])
def test_turbo_on_card_equals_cpu(cuda, block, model):
    rng = np.random.default_rng(1)
    data = (b"lacuna " * 3000) + rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    on_card = engine.compress_bytes(data, model_id=model, block_size=block)
    assert on_card == engine.compress_bytes(
        data, model_id=model, block_size=block, device="cpu")
    assert engine.decompress_bytes(on_card) == data
    assert turbo.turbo_decompress_blocks(on_card, [1]) == [data[block : 2 * block]]


def test_empty_and_tiny_inputs_on_card(cuda):
    for data in (b"", b"a", b"ab" * 700):
        c = turbo.turbo_compress(data)
        assert c == turbo.turbo_compress(data, device="cpu")
        assert turbo.turbo_decompress(c) == data


def test_cuda_tensor_raises_when_the_build_fails(cuda, monkeypatch):
    """No fallback to the plain version on the card: a failed build raises."""
    from lac_tpu_torch.ops import _build

    def broken():
        raise RuntimeError("nvcc failed (simulated)")

    monkeypatch.setattr(_build, "load_library", broken)
    before = dict(rk.launches)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rk.o0n_encode_intervals(torch.zeros((4, 2), dtype=torch.uint8, device=cuda), RATE)
    assert rk.launches == before


# --------------------------------------------------------------------------
# K10-K12, the causal attention of the training path (ops/attention.py).
# Tolerance, as max |kernel - plain| / max(max |plain|, 1): 1e-4 in f32
# (the same f32 math summed in another order) and 1e-2 in bf16 (the outputs
# are rounded once to bf16, 2^-8 of the largest value); lse 1e-4 absolute.
# --------------------------------------------------------------------------


def _attn_inputs(b, h, s, d, dtype, layout, cuda, seed=0):
    g = torch.Generator().manual_seed(seed)

    def one():
        x = (torch.randn(b, s, h, d, generator=g) * 2.0).to(dtype).to(cuda)
        return x.transpose(1, 2) if layout == "bshd" else x.transpose(1, 2).contiguous()

    return one(), one(), one(), one()


def _attn_rel(a, b):
    return float((a.float() - b.float()).abs().max() / max(b.float().abs().max().item(), 1.0))


# bf16 tile edges of the tensor-core K10 (128-query tiles, 128-key stages)
# and K11 (128-key tiles, 64-query stages): every case of the mask and of a
# ragged last tile
TILE_EDGES = [(1, 2, s, d, torch.bfloat16) for s in (1, 63, 64, 65, 127, 128, 129)
              for d in (64, 128)]


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("b,h,s,d,dtype", [
    (2, 4, 1024, 64, torch.bfloat16), (1, 3, 257, 128, torch.bfloat16),
    (2, 2, 130, 64, torch.float32), (1, 2, 1000, 128, torch.float32),
    (1, 1, 1, 64, torch.float32), (1, 2, 7, 128, torch.bfloat16), *TILE_EDGES,
])
def test_attention_kernels_equal_plain_versions(cuda, b, h, s, d, dtype, layout):
    from lac_tpu_torch.ops import attention as A

    q, k, v, do = _attn_inputs(b, h, s, d, dtype, layout, cuda, seed=s + d)
    scale = d ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    before = dict(A.launches)
    o, lse = A.causal_attn_fwd(q, k, v, scale)
    po, plse = A.attention_plain_fwd(q, k, v, scale)
    assert o.dtype == dtype and o.stride() == q.stride()
    assert _attn_rel(o, po) <= tol and float((lse - plse).abs().max()) <= 1e-4
    di = A._di(po, do)
    dk, dv = A.causal_attn_bwd_dkv(q, k, v, do, plse, di, scale)
    pdk, pdv = A.attention_plain_bwd_dkv(q, k, v, do, plse, di, scale)
    dq = A.causal_attn_bwd_dq(q, k, v, do, plse, di, scale)
    pdq = A.attention_plain_bwd_dq(q, k, v, do, plse, di, scale)
    torch.cuda.synchronize()
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert _attn_rel(got, want) <= tol
    assert {n: A.launches[n] - before[n] for n in before} == {
        "causal_attn_fwd": 1, "causal_attn_bwd_dkv": 1, "causal_attn_bwd_dq": 1}
    # the same bits on a second run: no atomics
    assert torch.equal(A.causal_attn_bwd_dkv(q, k, v, do, plse, di, scale)[0], dk)


@pytest.mark.parametrize("d", [64, 128])
def test_attention_variant_follows_the_type(cuda, d):
    """bf16 K10-K12 launch the tensor-core kernels, f32 the scalar ones.
    Both variants count as the kernel."""
    from lac_tpu_torch.ops import attention as A

    for dtype, fwd, dkv, dq in (
            (torch.float32, "lac_attn_fwd", "lac_attn_bwd_dkv", "lac_attn_bwd_dq"),
            (torch.bfloat16, "lac_attn_fwd_sm90", "lac_attn_bwd_dkv_sm90",
             "lac_attn_bwd_dq_sm90")):
        q, k, v, do = _attn_inputs(1, 2, 200, d, dtype, "bshd", cuda)
        A.reset_launches()
        o, lse = A.causal_attn_fwd(q, k, v, d ** -0.5)
        di = A._di(o, do)
        A.causal_attn_bwd_dkv(q, k, v, do, lse, di, d ** -0.5)
        A.causal_attn_bwd_dq(q, k, v, do, lse, di, d ** -0.5)
        torch.cuda.synchronize()
        assert {n: c for n, c in A.symbol_launches.items() if c} == {fwd: 1, dkv: 1, dq: 1}
        assert A.launches == {"causal_attn_fwd": 1, "causal_attn_bwd_dkv": 1,
                              "causal_attn_bwd_dq": 1}


@pytest.mark.parametrize("d", [64, 128])
def test_attention_bwd_dkv_is_deterministic(cuda, d):
    """K11 has one writer per dK and dV row (no atomics): two calls on the
    same inputs give the same bits."""
    from lac_tpu_torch.ops import attention as A

    q, k, v, do = _attn_inputs(4, 4, 1000, d, torch.bfloat16, "bshd", cuda, seed=5)
    o, lse = A.causal_attn_fwd(q, k, v, d ** -0.5)
    di = A._di(o, do)
    dk, dv = A.causal_attn_bwd_dkv(q, k, v, do, lse, di, d ** -0.5)
    dk2, dv2 = A.causal_attn_bwd_dkv(q, k, v, do, lse, di, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("d", [64, 128])
def test_attention_bwd_dq_is_deterministic(cuda, d):
    """K12 has one writer per dQ row (no atomics): two calls on the same
    inputs give the same bits."""
    from lac_tpu_torch.ops import attention as A

    q, k, v, do = _attn_inputs(4, 4, 1000, d, torch.bfloat16, "bshd", cuda, seed=6)
    o, lse = A.causal_attn_fwd(q, k, v, d ** -0.5)
    di = A._di(o, do)
    dq = A.causal_attn_bwd_dq(q, k, v, do, lse, di, d ** -0.5)
    dq2 = A.causal_attn_bwd_dq(q, k, v, do, lse, di, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)


def test_attention_launch_error_raises_without_fallback(cuda, monkeypatch):
    """A bf16 tensor whose tensor-core kernel fails raises: no scalar kernel
    and no plain version runs in its place, and nothing is counted."""
    from lac_tpu_torch.ops import _build
    from lac_tpu_torch.ops import attention as A

    lib = _build.load_library()
    monkeypatch.setattr(lib, "lac_attn_fwd_sm90", lambda *args: 700)
    monkeypatch.setattr(lib, "lac_attn_bwd_dkv_sm90", lambda *args: 1001)
    monkeypatch.setattr(lib, "lac_attn_bwd_dq_sm90", lambda *args: 702)
    q, k, v, do = _attn_inputs(1, 2, 100, 64, torch.bfloat16, "bshd", cuda)
    lse = torch.zeros(1, 2, 100, device=cuda)
    A.reset_launches()
    with pytest.raises(RuntimeError, match="lac_attn_fwd_sm90.*error 700"):
        A.causal_attn_fwd(q, k, v, 0.125)
    with pytest.raises(RuntimeError, match="lac_attn_bwd_dkv_sm90.*error 1001"):
        A.causal_attn_bwd_dkv(q, k, v, do, lse, lse, 0.125)
    with pytest.raises(RuntimeError, match="lac_attn_bwd_dq_sm90.*error 702"):
        A.causal_attn_bwd_dq(q, k, v, do, lse, lse, 0.125)
    assert set(A.launches.values()) == {0} and set(A.symbol_launches.values()) == {0}


def test_attention_kernels_refuse_other_head_dims(cuda):
    from lac_tpu_torch.ops import attention as A

    q = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.causal_attn_fwd(q, q, q, 1.0)


@pytest.mark.parametrize("impl", ["flash", "splash"])
def test_fused_training_loss_runs_the_kernels(cuda, impl):
    """lm_loss(fused=True) on the card: K10 twice a layer (remat) and K11,
    K12 once a layer, near the exact branch's loss."""
    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.ops import attention as A
    from lac_tpu_torch.train import lm_loss

    cfg = T.tiny_config(d_model=256, n_heads=4, n_kv_heads=4, max_seq=300)
    model = T.init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 257))).to(cuda)
    old = T._FUSED["impl"]
    T._FUSED["impl"] = impl
    try:
        A.reset_launches()
        loss = lm_loss(cfg, model, toks, fused=True)
        loss.backward()
        torch.cuda.synchronize()
        assert A.launches == {"causal_attn_fwd": 2 * cfg.n_layers,
                              "causal_attn_bwd_dkv": cfg.n_layers,
                              "causal_attn_bwd_dq": cfg.n_layers}
    finally:
        T._FUSED["impl"] = old
    with torch.no_grad():
        exact = lm_loss(cfg, model, toks)
    assert abs(loss.item() - exact.item()) <= 1e-4


# --------------------------------------------------------------------------
# LM coding on the card (runtime.lm_api / lm_engine; no hand-written kernel)
# --------------------------------------------------------------------------

LM_CKPT = "checkpoints/byte6l-pysrc.npz"
LM_SMALL = dict(block_tokens=64, lanes=4, cache_grow=16)


def _lm_data():
    from lac_tpu_torch.smoke import smoke_corpus

    return smoke_corpus(1 << 16)[-1000:]


def test_lm_round_trip_on_the_card(cuda):
    import os

    from lac_tpu_torch.runtime import lm_api
    from lac_tpu_torch.stream.container import read_container
    from lac_tpu_torch.train import load_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = load_checkpoint(os.path.join(root, LM_CKPT))
    data = _lm_data()
    c = lm_api.lm_compress_bytes(data, model_ref="file:" + LM_CKPT, model=model, **LM_SMALL)
    _, blocks = read_container(c)
    assert all(b.token_count for b in blocks)  # the trained model codes every block
    assert lm_api.lm_decompress_bytes(c, model=model) == data
    assert lm_api.lm_compress_bytes(data, model_ref="file:" + LM_CKPT, model=model,
                                    **LM_SMALL) == c


def test_lm_encode_twice_gives_equal_words(cuda):
    from lac_tpu_torch.models.lm_registry import resolve_lm
    from lac_tpu_torch.runtime import lm_engine

    cfg, params = resolve_lm("prng:tiny:0")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (8, 100))).to(cuda)
    lengths = torch.tensor([100, 0, 1, 99, 50, 100, 7, 100], device=cuda)
    w1, n1 = lm_engine.lm_encode(cfg, params, toks, lengths, 16, 32)
    w2, n2 = lm_engine.lm_encode(cfg, params, toks, lengths, 16, 32)
    assert torch.equal(w1, w2) and torch.equal(n1, n2)
    out = lm_engine.lm_decode(cfg, params, w1, lengths, 16, 100, 32)
    live = torch.arange(100, device=cuda)[None, :] < lengths[:, None]
    assert torch.equal(out, torch.where(live, toks, 0))


def test_lm_cpu_container_is_refused_on_the_card(cuda):
    from lac_tpu_torch.runtime import lm_api

    data = _lm_data()[:300]
    c = lm_api.lm_compress_bytes(data, model_ref="prng:tiny:0", device="cpu", **LM_SMALL)
    assert lm_api.lm_decompress_bytes(c, device="cpu") == data
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        lm_api.lm_decompress_bytes(c)


# --------------------------------------------------------------------------
# Windowed LM coding on the card: the step as a CUDA graph
# (runtime.step_graph), blocks past the model context
# --------------------------------------------------------------------------


@pytest.mark.parametrize("slide", [False, True])
def test_lm_graph_step_equals_the_eager_step(cuda, slide):
    """From one cache (a prefill of the context), 12 coding steps eagerly
    and through the runner's graph (its first step eager): the CDFs and the
    intervals equal bit for bit; on the ring the steps run past its end."""
    import dataclasses

    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.models.lm_registry import resolve_lm
    from lac_tpu_torch.runtime import lm_engine, step_graph

    cfg, params = resolve_lm("prng:tiny:0", max_seq=64)
    cfg = dataclasses.replace(cfg, slide=slide)
    start = 64 if slide else 40
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (6, start + 12))).to(cuda)
    cdfs, runs = [], []
    with lm_engine._coding(cuda):
        base = T.init_cache(cfg, 6, 64, device=cuda)
        T.forward(cfg, params, toks[:, :start], base, prefill=True)
        for graphed in (False, True):
            run = step_graph.SegIntervals(cfg, params, 16, toks[:, start:])
            run.prev.copy_(toks[:, start - 1])
            cache = {k: v.clone() for k, v in base.items()}
            got = []
            for _ in range(12):
                run.steps(cache, 1) if graphed else run._step(cache)
                got.append(run.cdf.clone())
            cdfs.append(torch.stack(got))
            runs.append(run)
    assert torch.equal(cdfs[0], cdfs[1])
    assert torch.equal(runs[0].lo, runs[1].lo) and torch.equal(runs[0].f, runs[1].f)
    assert len(runs[1]._graphs) == 1


@pytest.mark.parametrize("mode", ["slide", "reprime"])
def test_lm_windowed_round_trip_on_the_card(cuda, mode):
    """byte-6l (context 768) at block 1000, 4 lanes, cache_grow 128: every
    block coded, the round trip equal, a second encode equal."""
    import os

    from lac_tpu_torch.runtime import lm_api
    from lac_tpu_torch.smoke import heldout_slice
    from lac_tpu_torch.stream.container import read_container
    from lac_tpu_torch.train import load_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = load_checkpoint(os.path.join(root, LM_CKPT))
    data = heldout_slice()[:3500]
    kw = dict(block_tokens=1000, lanes=4, cache_grow=128, window_mode=mode)
    c = lm_api.lm_compress_bytes(data, model_ref="file:" + LM_CKPT, model=model, **kw)
    header, blocks = read_container(c)
    assert header.config["window_mode"] == mode and all(b.token_count for b in blocks)
    assert lm_api.lm_decompress_bytes(c, model=model) == data
    assert lm_api.lm_compress_bytes(data, model_ref="file:" + LM_CKPT, model=model, **kw) == c


# --------------------------------------------------------------------------
# The int8 LM modes on the card (kv8, w8): the exact int8 products and the
# kv8+w8 step as a CUDA graph
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
def test_int8_mm_exact_on_the_card(cuda, m):
    """ops.int8.int8_mm through its padding against the host's exact product
    (float64: every partial sum of int8 products is below 2^53), seeded and
    at every value +-127, b row- and column-major."""
    from lac_tpu_torch.ops.int8 import int8_mm

    rng = np.random.default_rng(m)
    for n in (61, 256, 32000):
        for k in (64, 2048, 5632):
            for worst in (False, True):
                a = np.full((m, k), 127, np.int8) if worst else rng.integers(
                    -127, 128, (m, k), dtype=np.int8)
                b = np.full((k, n), -127, np.int8) if worst else rng.integers(
                    -127, 128, (k, n), dtype=np.int8)
                want = a.astype(np.float64) @ b.astype(np.float64)
                bt = torch.from_numpy(b).to(cuda)
                for bb in (bt, bt.t().contiguous().t()):
                    got = int8_mm(torch.from_numpy(a).to(cuda), bb)
                    assert np.array_equal(got.cpu().numpy().astype(np.float64), want), (n, k)


@pytest.mark.parametrize("w", [1024, 1040, 2048])
def test_int8_bmm_exact_on_the_card(cuda, w):
    """The chunked product over W terms under the coding context (TF32 off),
    seeded and worst case; with TF32 on it refuses."""
    from lac_tpu_torch.ops.int8 import int8_bmm
    from lac_tpu_torch.runtime.lm_engine import _coding

    rng = np.random.default_rng(w)
    for worst in (False, True):
        a = np.full((2, 4, 8, w), 127, np.int8) if worst else rng.integers(
            -127, 128, (2, 4, 8, w), dtype=np.int8)
        b = np.full((2, 4, w, 64), 127, np.int8) if worst else rng.integers(
            -127, 128, (2, 4, w, 64), dtype=np.int8)
        with _coding(cuda):
            got = int8_bmm(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
        assert np.array_equal(got.cpu().numpy().astype(np.float64),
                              np.matmul(a.astype(np.float64), b.astype(np.float64)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            int8_bmm(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("slide", [False, True])
def test_lm_kv8_w8_graph_step_equals_the_eager_step(cuda, slide):
    """test_lm_graph_step_equals_the_eager_step with the int8 KV cache and
    int8 weights: 12 steps' CDFs and intervals equal bit for bit, the
    four-buffer cache captured and replayed."""
    import dataclasses

    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.models.lm_registry import resolve_lm
    from lac_tpu_torch.runtime import lm_engine, step_graph

    cfg, params = resolve_lm("prng:tiny:0", max_seq=64)
    cfg = dataclasses.replace(cfg, slide=slide, kv8=True, w8=True)
    params = T.ensure_w8(cfg, params)
    start = 64 if slide else 40
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (6, start + 12))).to(cuda)
    cdfs, runs = [], []
    with lm_engine._coding(cuda):
        base = T.init_cache(cfg, 6, 64, device=cuda)
        T.forward(cfg, params, toks[:, :start], base, prefill=True)
        for graphed in (False, True):
            run = step_graph.SegIntervals(cfg, params, 16, toks[:, start:])
            run.prev.copy_(toks[:, start - 1])
            cache = {k: v.clone() for k, v in base.items()}
            got = []
            for _ in range(12):
                run.steps(cache, 1) if graphed else run._step(cache)
                got.append(run.cdf.clone())
            cdfs.append(torch.stack(got))
            runs.append(run)
    assert sorted(base) == ["k", "ks", "pos", "v", "vs"] and base["k"].dtype == torch.int8
    assert torch.equal(cdfs[0], cdfs[1])
    assert torch.equal(runs[0].lo, runs[1].lo) and torch.equal(runs[0].f, runs[1].f)
    assert len(runs[1]._graphs) == 1


def test_lm_int8_round_trip_on_the_card(cuda):
    """byte-6l with kv8 and w8 at LM_SMALL: every block coded, the header's
    flags, the round trip equal, a second encode equal."""
    import os

    from lac_tpu_torch.runtime import lm_api
    from lac_tpu_torch.stream.container import read_container
    from lac_tpu_torch.train import load_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = load_checkpoint(os.path.join(root, LM_CKPT))
    data = _lm_data()
    kw = dict(LM_SMALL, kv8=True, w8=True)
    c = lm_api.lm_compress_bytes(data, model_ref="file:" + LM_CKPT, model=model, **kw)
    header, blocks = read_container(c)
    assert header.config["kv8"] and header.config["w8"] and all(b.token_count for b in blocks)
    assert lm_api.lm_decompress_bytes(c, model=model) == data
    assert lm_api.lm_compress_bytes(data, model_ref="file:" + LM_CKPT, model=model, **kw) == c


# --------------------------------------------------------------------------
# det8: the card against the CPU, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["det_exp", "det_silu", "det_gelu_tanh", "det_sqrt",
                                  "det_rsqrt", "quantize_det"])
def test_det8_math_equals_the_cpus(cuda, name):
    """Each elementwise det8 function and the det8 CDF's float stage on
    2^20 seeded values: the card's bits are the CPU's."""
    from lac_tpu_torch.ops import detmath, quantize

    rng = np.random.default_rng(7)
    n = 1 << 20
    if name == "det_exp":
        x = -np.abs(rng.standard_normal(n)) * rng.choice([0.01, 1.0, 10.0, 100.0], n)
        x[:3] = [-np.inf, 0.0, -87.3]
    elif name in ("det_sqrt", "det_rsqrt"):
        x = np.abs(rng.standard_normal(n)) * np.exp2(rng.integers(-30, 30, n))
    elif name == "quantize_det":
        x = rng.standard_normal((n // 256, 256)) * rng.choice([0.1, 3.0, 20.0], (n // 256, 1))
    else:
        x = rng.standard_normal(n) * rng.choice([0.1, 1.0, 5.0, 30.0], n)
    t = torch.from_numpy(x.astype(np.float32))
    fn = ((lambda v: quantize.quantize_det(v, 16)) if name == "quantize_det"
          else getattr(detmath, name))
    assert torch.equal(fn(t.to(cuda)).cpu(), fn(t))


def _det8_tiny_model(cuda, **kw):
    import dataclasses

    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.models.lm_registry import resolve_lm

    """(det8 cfg, prng:tiny:0's det8 model on the CPU, the same on the card):
    the weights are drawn on the CPU, so the two hold the same values."""
    models = [resolve_lm("prng:tiny:0", max_seq=64, device=dev) for dev in ("cpu", cuda)]
    cfg = dataclasses.replace(models[0][0], det8=True, **kw)
    return (cfg, *(T.ensure_det8(cfg, p) for _, p in models))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_det8_logits_equal_the_cpus(cuda, dtype):
    """prng:tiny:0 with det8 (and in bf16): the prefill, a 20-token cached
    chunk at pos 9 and serial steps give the CPU's logits bit for bit."""
    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.runtime.lm_engine import _coding

    cfg, cpu_p, dev_p = _det8_tiny_model(
        cuda, dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 29)))
    out = []
    for dev, p in ((torch.device("cpu"), cpu_p), (cuda, dev_p)):
        t = toks.to(dev)
        with _coding(dev):
            pre = T.forward(cfg, p, t, prefill=True)
            cache = T.init_cache(cfg, 3, 64, device=dev)
            head = torch.cat([T.forward(cfg, p, t[:, i : i + 1], cache)[0] for i in range(9)], 1)
            chunk = T.forward(cfg, p, t[:, 9:], cache)[0]
        out.append([x.cpu() for x in (pre, head, chunk)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_det8_chunked_encode_equals_serial_steps_on_the_card(cuda):
    """The engine's chunked det8 encode (chunks of 5, split at the ring's
    boundaries) against serial graph-replayed steps, past the context in
    slide mode, and the intervals equal the CPU's."""
    from lac_tpu_torch.runtime import lm_engine as E
    from lac_tpu_torch.runtime import step_graph as G

    cfg, cpu_p, dev_p = _det8_tiny_model(cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 150)))
    got = []
    for dev, p, runner, kw in ((cuda, dev_p, G.SegIntervals, {}),
                               (cuda, dev_p, G.SegChunks, {"chunk": 5}),
                               (torch.device("cpu"), cpu_p, G.SegChunks, {})):
        with E._coding(dev):
            run = runner(E._step_cfg(cfg, 150, "slide"), p, 16, toks.to(dev), **kw)
            E._schedule(run, 150, 0, 2)
        got.append((run.lo.cpu(), run.f.cpu()))
    for lo, f in got[1:]:
        assert torch.equal(lo, got[0][0]) and torch.equal(f, got[0][1])


def test_det8_graph_step_equals_the_eager_step(cuda):
    """12 det8 steps on the ring past its first window: the graph's CDFs
    and intervals equal the eager steps' bit for bit."""
    import dataclasses

    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.runtime import lm_engine, step_graph

    cfg, _, params = _det8_tiny_model(cuda)
    cfg = dataclasses.replace(cfg, slide=True, rope_positions=76)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (6, 76))).to(cuda)
    cdfs, runs = [], []
    with lm_engine._coding(cuda):
        base = T.init_cache(cfg, 6, 64, device=cuda)
        T.forward(cfg, params, toks[:, :64], base, prefill=True)
        for graphed in (False, True):
            run = step_graph.SegIntervals(cfg, params, 16, toks[:, 64:])
            run.prev.copy_(toks[:, 63])
            cache = {k: v.clone() for k, v in base.items()}
            got = []
            for _ in range(12):
                run.steps(cache, 1) if graphed else run._step(cache)
                got.append(run.cdf.clone())
            cdfs.append(torch.stack(got))
            runs.append(run)
    assert torch.equal(cdfs[0], cdfs[1])
    assert torch.equal(runs[0].lo, runs[1].lo) and torch.equal(runs[0].f, runs[1].f)


def test_det8_cpu_container_decodes_on_the_card(cuda, tmp_path):
    """The GOLDEN_DET8_PORT input: the CPU's det8 container (made here on
    the CPU, equal to the golden) decodes on the card, and the card's
    container is the same bytes."""
    import os

    from lac_tpu_torch import smoke
    from lac_tpu_torch.runtime import lm_api
    from lac_tpu_torch.train import load_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = smoke.smoke_corpus(smoke.LM_BPB_BYTES)
    kw = dict(model_ref="file:" + smoke.LM_CHECKPOINT, det8=True, **smoke.LM_CODING)
    cpu = lm_api.lm_compress_bytes(data, model=load_checkpoint(
        os.path.join(root, smoke.LM_CHECKPOINT), device="cpu"), device="cpu", **kw)
    assert smoke.container_digest(cpu) == smoke.GOLDEN_DET8_PORT
    model = load_checkpoint(os.path.join(root, smoke.LM_CHECKPOINT))
    assert lm_api.lm_decompress_bytes(cpu, model=model) == data
    assert lm_api.lm_compress_bytes(data, model=model, **kw) == cpu


@pytest.mark.parametrize("model", ["order0", "markov1", "order0d", "markov1d", "markov1c"])
def test_scan_container_on_the_card_equals_the_cpus(cuda, model):
    """The scan codecs are integer-exact: the card writes the CPU's
    container, and each decodes the other's."""
    from lac_tpu_torch.smoke import smoke_corpus

    data = smoke_corpus(20000)
    card = engine.compress_bytes(data, model_id=model, block_size=4096)
    assert card == engine.compress_bytes(data, model_id=model, block_size=4096, device="cpu")
    assert engine.decompress_bytes(card) == data
    assert engine.decompress_blocks(card, [4, 0]) == [data[16384:], data[:4096]]


def test_token_round_trip_on_the_card_at_prob_bits_18(cuda):
    """Ids above 65,535 (vocab 70,000: prob_bits 18, raw >u4) round-trip
    through lm_compress_tokens on the card."""
    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.runtime import lm_api
    from lac_tpu_torch.stream.container import read_container

    cfg = T.tiny_config(vocab=70000, max_seq=64)
    model = (cfg, T.init_params(cfg, 1, device=cuda))
    ids = np.random.default_rng(0).integers(0, 70000, 130).astype(np.int32)
    ids[0] = 69999
    c = lm_api.lm_compress_tokens(ids, "prng:x:0", block_tokens=64, lanes=4, model=model)
    assert np.array_equal(lm_api.lm_decompress_tokens(c, model=model), ids)
    header, blocks = read_container(c)
    assert header.prob_bits == 18 and header.config["vocab"] == 70000
    # a block of 2 ids: its two state words are no shorter than 2 raw ids
    assert blocks[-1].token_count == 0 and blocks[-1].payload == ids[-2:].astype(">u4").tobytes()


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_scan_replays_equal_the_cpus(cuda, reverse):
    """utils.scan's chunks as CUDA graph replays give the CPU's carry and
    outputs: a table written in place, a new tensor each step, a tail."""
    from lac_tpu_torch.utils.scan import CHUNK, scan

    n = 5 * CHUNK + 7
    xs = torch.from_numpy(np.random.default_rng(3).integers(0, 5, (n, 3)))

    def step(carry, x):
        table, acc = carry
        table[torch.arange(3, device=table.device), x[0]] += 1
        acc = acc * 3 + table.sum(1) + x[0]
        return (table, acc), (acc % 7, table[:, 0] * 2)

    got = []
    for dev in ("cpu", cuda):
        carry = (torch.zeros((3, 5), dtype=torch.int64, device=dev),
                 torch.zeros(3, dtype=torch.int64, device=dev))
        carry, ys = scan(step, carry, (xs.to(dev),), reverse=reverse)
        got.append([t.cpu() for t in (*carry, *ys)])
    assert all(torch.equal(a, b) for a, b in zip(*got, strict=True))

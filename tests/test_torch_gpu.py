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

"""The golden containers of lac_tpu_torch/smoke.py, which chip_smoke.py
holds the card's output to, are what lac_tpu writes for each ported model:
its native coder (bit-identical to the Pallas path) on the 32 MiB smoke
corpus."""

import pytest

from lac_tpu.native.host import native_compress
from lac_tpu_torch import smoke


@pytest.mark.parametrize("model,block", sorted(smoke.GOLDEN))
def test_golden_equals_native_compress(model, block):
    corpus = smoke.smoke_corpus()
    assert len(corpus) == smoke.SMOKE_BYTES
    got = smoke.container_digest(native_compress(corpus, block_size=block, model=model))
    assert got == smoke.GOLDEN[(model, block)]


def test_golden_covers_every_ported_model():
    """Each model at blocks 4096 and 1024, and the order0c fallback of
    order0n at block 8192."""
    from lac_tpu_torch.runtime.turbo import _CODECS

    assert set(smoke.GOLDEN) == {(m, b) for m in _CODECS for b in (4096, 1024)} | {
        ("order0c", 8192)}


def test_golden_order0c_8192_is_order0n_fallback():
    corpus = smoke.smoke_corpus()
    c = native_compress(corpus, block_size=8192, model="order0n")
    assert smoke.container_digest(c) == smoke.GOLDEN[("order0c", 8192)]


def test_corpus_is_prefix_stable():
    assert smoke.smoke_corpus(1000) == smoke.smoke_corpus(5000)[:1000]
    assert smoke.smoke_corpus(0) == b""

"""The golden containers of lac_tpu_torch/smoke.py, which chip_smoke.py
holds the card's output to, are what lac_tpu writes: its native coder
(bit-identical to the Pallas path) on the 32 MiB smoke corpus."""

import pytest

from lac_tpu.native.host import native_compress
from lac_tpu_torch import smoke


@pytest.mark.parametrize("block", [4096, 1024])
def test_golden_equals_native_compress(block):
    corpus = smoke.smoke_corpus()
    assert len(corpus) == smoke.SMOKE_BYTES
    assert smoke.container_digest(native_compress(corpus, block_size=block)) == smoke.GOLDEN[block]


def test_corpus_is_prefix_stable():
    assert smoke.smoke_corpus(1000) == smoke.smoke_corpus(5000)[:1000]
    assert smoke.smoke_corpus(0) == b""

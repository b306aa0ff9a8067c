"""The golden containers of lac_tpu_torch/smoke.py, which chip_smoke.py
holds the card's output to, are what lac_tpu writes for each ported model
on the 32 MiB smoke corpus: for the turbo models its native coder
(bit-identical to the Pallas path), for the scan models its scan engine.
The full-corpus scan containers take minutes of CPU (a test marked slow);
tier-1 holds their blocks over the corpus's first 256 KiB, which lac_tpu's
and the port's containers of that prefix must give."""

import pytest
import torch

from lac_tpu.native.host import native_compress
from lac_tpu.runtime import engine as ref_engine
from lac_tpu.stream.container import read_container as ref_read
from lac_tpu_torch import smoke
from lac_tpu_torch.runtime import engine


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


def _head(blocks, block: int) -> int:
    return smoke.blocks_digest(blocks[: smoke.SCAN_HEAD_BYTES // block])


@pytest.mark.slow
@pytest.mark.parametrize("model,block", sorted(smoke.GOLDEN_SCAN))
def test_golden_scan_equals_lac_tpus_container(model, block):
    c = ref_engine.compress_bytes(smoke.smoke_corpus(), model_id=model, block_size=block)
    assert smoke.container_digest(c) == smoke.GOLDEN_SCAN[(model, block)]
    assert _head(ref_read(c)[1], block) == smoke.GOLDEN_SCAN_HEAD[(model, block)]


@pytest.mark.parametrize("model,block", sorted(smoke.GOLDEN_SCAN))
def test_golden_scan_head_is_lac_tpus_and_the_ports(model, block):
    """Blocks are independent streams: the containers of the corpus's first
    256 KiB hold the golden containers' first blocks, lac_tpu's and the
    port's alike."""
    data = smoke.smoke_corpus(smoke.SCAN_HEAD_BYTES)
    ref = ref_engine.compress_bytes(data, model_id=model, block_size=block)
    assert _head(ref_read(ref)[1], block) == smoke.GOLDEN_SCAN_HEAD[(model, block)]
    # the scan engine's steps are small ops: one intra-op thread runs them
    # fastest, and under several test workers more threads spin on each
    # other's cores (the native coder's threads are left alone)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ours = engine.compress_bytes(data, model_id=model, block_size=block, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert ours == ref


def test_golden_scan_covers_every_scan_model():
    """Each scan model at the CLI's block 4096, and the API's default."""
    from lac_tpu_torch.models.registry import _SCAN_MODELS
    from lac_tpu_torch.runtime.engine import _TURBO_IDS

    assert set(smoke.GOLDEN_SCAN) == set(smoke.GOLDEN_SCAN_HEAD) == {
        (m, 4096) for m in _SCAN_MODELS if m not in _TURBO_IDS} | {("order0", 1 << 16)}

"""smoke.GOLDEN_Q8_BPB, the int8 LM modes' goldens, recomputed with lac_tpu
on the CPU: the bits/byte of lac_tpu's container for the first
smoke.LM_BPB_BYTES of the corpus with the shipped byte-6l checkpoint at
smoke.LM_CODING, with kv8, w8 or both (about a minute a mode on an idle
8-core CPU). Tolerance 1e-3 relative, as tests/test_torch_lm_golden.py:
lac_tpu on a CPU gives them exactly, and another CPU's exp or summation
order may move a block's words. chip_smoke.py's phase 6 holds the port's
containers, made through the CLI on the card, to them within 1 %. A file
of its own, so that the test workers run it beside tests/test_torch_q8.py."""

import os

import pytest

from lac_tpu.runtime.lm_api import lm_compress_bytes
from lac_tpu.train import load_checkpoint
from lac_tpu_torch import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", sorted(smoke.GOLDEN_Q8_BPB))
def test_golden_q8_bpb_is_lac_tpus(mode):
    path = os.path.join(REPO, smoke.LM_CHECKPOINT)
    data = smoke.smoke_corpus(smoke.LM_BPB_BYTES)
    c = lm_compress_bytes(data, model_ref="file:" + smoke.LM_CHECKPOINT,
                          model=load_checkpoint(path), kv8="kv8" in mode, w8="w8" in mode,
                          **smoke.LM_CODING)
    assert abs(8 * len(c) / len(data) / smoke.GOLDEN_Q8_BPB[mode] - 1) <= 1e-3

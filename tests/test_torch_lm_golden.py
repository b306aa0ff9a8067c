"""smoke.GOLDEN_LM_BPB, the LM coding slice's golden, recomputed with
lac_tpu on the CPU: the bits/byte of lac_tpu's container for the first
smoke.LM_BPB_BYTES of the corpus with the shipped byte-6l checkpoint at
smoke.LM_CODING. Tolerance 1e-3 relative: lac_tpu's float path on a CPU
gives it exactly, and another CPU's exp or summation order may move a
block's words. chip_smoke.py holds the port's container on the card to it
within 1 %."""

import os

from lac_tpu.runtime.lm_api import lm_compress_bytes
from lac_tpu.train import load_checkpoint
from lac_tpu_torch import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_lm_bpb_is_lac_tpus():
    path = os.path.join(REPO, smoke.LM_CHECKPOINT)
    data = smoke.smoke_corpus(smoke.LM_BPB_BYTES)
    c = lm_compress_bytes(data, model_ref="file:" + smoke.LM_CHECKPOINT,
                          model=load_checkpoint(path), **smoke.LM_CODING)
    bpb = 8 * len(c) / len(data)
    assert abs(bpb / smoke.GOLDEN_LM_BPB - 1) <= 1e-3

"""The windowed LM coding slice's goldens, recomputed with lac_tpu on the
CPU: ``smoke.GOLDEN_WINDOW_BPB`` (byte-6l past its 768-token context on the
held-out slice's first 64 KiB, block 2048, 32 lanes, reprime and slide;
about 90 s a mode on an idle 8-core CPU) and, in a test marked ``slow``,
``smoke.GOLDEN_SLIDE16_BPB`` (byte-16l in slide mode at block 4096 and 64
lanes on the whole slice, 4,096 steps; 43 minutes on that CPU).
Tolerance 1e-3 relative, as ``tests/test_torch_lm_golden.py``: lac_tpu's
float path on a CPU gives them exactly, and another CPU's exp or summation
order may move a block's words. ``chip_smoke.py``'s phase 5 holds the
port's containers on the card to them within 1 %. A file of its own, so
that the test workers run it beside ``tests/test_torch_window.py``."""

import os

import pytest

from lac_tpu.runtime.lm_api import lm_compress_bytes
from lac_tpu.train import load_checkpoint
from lac_tpu_torch import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lac_tpu_bpb(checkpoint, data, **kw):
    c = lm_compress_bytes(data, model_ref="file:" + checkpoint,
                          model=load_checkpoint(os.path.join(REPO, checkpoint)), **kw)
    return 8 * len(c) / len(data)


@pytest.mark.parametrize("mode", ["reprime", "slide"])
def test_golden_window_bpb_is_lac_tpus(mode):
    """smoke.GOLDEN_WINDOW_BPB recomputed with lac_tpu on the CPU: byte-6l
    (context 768) on the slice's first 64 KiB, block 2048, 32 lanes."""
    data = smoke.heldout_slice()[: smoke.WINDOW_BPB_BYTES]
    bpb = _lac_tpu_bpb(smoke.LM_CHECKPOINT, data, window_mode=mode, **smoke.WINDOW_CODING)
    assert abs(bpb / smoke.GOLDEN_WINDOW_BPB[mode] - 1) <= 1e-3


@pytest.mark.slow
def test_golden_slide16_bpb_is_lac_tpus():
    """smoke.GOLDEN_SLIDE16_BPB recomputed with lac_tpu on the CPU."""
    data = smoke.heldout_slice()[: smoke.SLIDE16_BYTES]
    bpb = _lac_tpu_bpb(smoke.SLIDE16_CHECKPOINT, data, **smoke.SLIDE16_CODING)
    assert abs(bpb / smoke.GOLDEN_SLIDE16_BPB - 1) <= 1e-3

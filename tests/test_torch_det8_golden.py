"""The det8 slice's goldens, recomputed on the CPU: ``smoke.GOLDEN_DET8_BPB``
with lac_tpu's encode (about 25 s on an idle 8-core CPU; its decode, which
took 143 s there, is left out), ``smoke.GOLDEN_DET8_PORT`` with the port's
CLI encode (about 30 s there), and ``smoke.GOLDEN_DET8_ROPE``; and the two
containers block by block: as lac_tpu is, every block's words differ from
the port's (its ``det_rsqrt`` is XLA's rsqrt, ROADMAP C4), and with its
``det_rsqrt`` patched to the documented ``1 / sqrt`` every block equals the
port's (marked ``slow``: another 25 s of lac_tpu's encode). A file of its
own, so that the test workers run it beside tests/test_torch_det8.py.

Tolerances: GOLDEN_DET8_BPB 1e-3 relative, as the other goldens: lac_tpu
on this CPU gives it exactly, and another CPU's XLA rsqrt may move a
block's words. The port's container and the tables: exact, since det8's
bits do not depend on the machine."""

import os
import zlib

import jax
import jax.numpy as jnp
import pytest

from lac_tpu.models import transformer as JT
from lac_tpu.runtime.lm_api import lm_compress_bytes
from lac_tpu.stream.container import read_container as j_read_container
from lac_tpu.train import load_checkpoint
from lac_tpu_torch import cli, smoke
from lac_tpu_torch.models.transformer import rope_table
from lac_tpu_torch.stream.container import read_container

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = smoke.smoke_corpus(smoke.LM_BPB_BYTES)


def _lac_tpu_container() -> bytes:
    return lm_compress_bytes(DATA, model_ref="file:" + smoke.LM_CHECKPOINT,
                             model=load_checkpoint(os.path.join(REPO, smoke.LM_CHECKPOINT)),
                             det8=True, **smoke.LM_CODING)


@pytest.fixture(scope="module")
def lac_tpus():
    return _lac_tpu_container()


@pytest.fixture(scope="module")
def ports(tmp_path_factory):
    """The port's det8 container of DATA, written on the CPU by the CLI at
    smoke.LM_CODING, from the repo's root (the header records the
    checkpoint's relative ref)."""
    path = os.path.join(tmp_path_factory.mktemp("det8"), "det8.bin")
    with open(path, "wb") as f:
        f.write(DATA)
    kw = smoke.LM_CODING
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert cli.main(["compress", path, "--model", "lm", "--model-ref",
                         "file:" + smoke.LM_CHECKPOINT, "--block-tokens",
                         str(kw["block_tokens"]), "--lanes", str(kw["lanes"]), "--prob-bits",
                         str(kw["prob_bits"]), "--cache-grow", str(kw["cache_grow"]),
                         "--window-mode", kw["window_mode"], "--det8", "--device", "cpu",
                         "-o", path + ".lac"]) == 0
    finally:
        os.chdir(cwd)
    with open(path + ".lac", "rb") as f:
        return f.read()


def _blocks(read, c):
    return [(b.raw_len, b.token_count, b.payload) for b in read(c)[1]]


def test_golden_det8_bpb_is_lac_tpus(lac_tpus):
    assert abs(8 * len(lac_tpus) / len(DATA) / smoke.GOLDEN_DET8_BPB - 1) <= 1e-3


def test_golden_det8_port_is_the_ports_cpu_container(ports):
    """The CLI's det8 container on the CPU, byte for byte; its bits/byte
    within 1e-3 of lac_tpu's golden."""
    assert smoke.container_digest(ports) == smoke.GOLDEN_DET8_PORT
    assert 8 * len(ports) / len(DATA) == pytest.approx(smoke.GOLDEN_DET8_BPB, rel=1e-3)


def test_lac_tpus_rsqrt_moves_every_blocks_words(lac_tpus, ports):
    """As lac_tpu is, every coded block's words differ from the port's,
    and each package's blocks hold the same tokens."""
    mine, ref = _blocks(read_container, ports), _blocks(j_read_container, lac_tpus)
    assert [b[:2] for b in mine] == [b[:2] for b in ref]
    assert all(a[2] != b[2] for a, b in zip(mine, ref) if a[1])


@pytest.mark.slow
def test_patched_lac_tpus_blocks_equal_the_ports(ports):
    """With lac_tpu's det_rsqrt the documented 1 / sqrt, every block of
    its container equals the port's, byte for byte."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "det_rsqrt", lambda x: jnp.float32(1.0) / jax.lax.optimization_barrier(
            jnp.sqrt(x.astype(jnp.float32))))
        ref = _lac_tpu_container()
    jax.clear_caches()
    assert _blocks(j_read_container, ref) == _blocks(read_container, ports)


def test_golden_det8_rope_tables():
    for n, crc in smoke.GOLDEN_DET8_ROPE.items():
        cos, sin = rope_table(n, 64, 10000.0)
        assert cos.shape == sin.shape == (n, 32)
        assert zlib.crc32(sin.tobytes(), zlib.crc32(cos.tobytes())) == crc

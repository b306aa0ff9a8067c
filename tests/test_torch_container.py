"""lac_tpu_torch's .lac container against lac_tpu's: a container written by
either package parses the same in the other, byte for byte."""

import os
import subprocess
import sys

import numpy as np
import pytest

from lac_tpu.stream import container as ref
from lac_tpu_torch.stream import container as port


def _random_container(mod, seed: int):
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(int(rng.integers(0, 6))):
        payload = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        raw_len = int(rng.integers(0, 5000))
        blocks.append(mod.BlockEntry(raw_len, int(rng.integers(0, raw_len + 1)), payload))
    header = mod.ContainerHeader(
        codec=int(rng.integers(0, 3)),
        prob_bits=int(rng.integers(1, 32)),
        model_id=["order0n", "order1n", "lm", "ünï"][int(rng.integers(0, 4))],
        config={"block_size": int(rng.integers(1, 1 << 16)), "rate": 4, "z": [1, "a"]},
        original_len=sum(b.raw_len for b in blocks),
        flags=int(rng.integers(0, 256)),
    )
    return header, blocks


def _fields(header, blocks):
    return (
        (header.codec, header.prob_bits, header.model_id, header.config,
         header.original_len, header.flags),
        [(b.raw_len, b.token_count, b.payload, b.crc) for b in blocks],
    )


def test_codec_ids_match():
    assert (port.MAGIC, port.VERSION) == (ref.MAGIC, ref.VERSION)
    assert (port.CODEC_ORACLE_AC, port.CODEC_RANS64, port.CODEC_RANS32) == (
        ref.CODEC_ORACLE_AC, ref.CODEC_RANS64, ref.CODEC_RANS32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("writer,reader", [(ref, port), (port, ref)])
def test_cross_package_parse(seed, writer, reader):
    header, blocks = _random_container(writer, seed)
    data = writer.write_container(header, blocks)
    # the other package writes the same bytes for the same content
    h2 = reader.ContainerHeader(**vars(header))
    b2 = [reader.BlockEntry(b.raw_len, b.token_count, b.payload) for b in blocks]
    assert reader.write_container(h2, b2) == data
    rh, rb = reader.read_container(data)
    assert _fields(rh, rb) == _fields(header, blocks)
    assert reader.verify_container(data) == writer.verify_container(data)


@pytest.mark.parametrize("cut", [0.3, 0.7, 0.95])
def test_truncated_and_corrupt_scan_alike(cut):
    header, blocks = _random_container(ref, 11)
    blocks.append(ref.BlockEntry(10, 10, b"0123456789"))
    data = ref.write_container(header, blocks)
    corrupt = bytearray(data)
    corrupt[-3] ^= 0xFF
    for variant in (data[: max(40, int(len(data) * cut))], bytes(corrupt)):
        try:
            expect = ref.scan_container(variant)
        except ValueError as e:
            with pytest.raises(ValueError):
                port.scan_container(variant)
            assert "truncated" in str(e) or "magic" in str(e)
            continue
        got = port.scan_container(variant)
        assert _fields(got[0], got[1]) == _fields(expect[0], expect[1])
        assert got[2] == expect[2]
        assert port.verify_container(variant) == ref.verify_container(variant)


def test_port_imports_no_jax():
    code = (
        "import sys; import lac_tpu_torch, lac_tpu_torch.cli, lac_tpu_torch.convert, "
        "lac_tpu_torch.smoke, lac_tpu_torch.runtime.engine, lac_tpu_torch.ops._build, "
        "lac_tpu_torch.coder.vector, lac_tpu_torch.ops.quantize, lac_tpu_torch.config, "
        "lac_tpu_torch.runtime.lm_engine, lac_tpu_torch.runtime.lm_api, "
        "lac_tpu_torch.models.lm_registry; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'lac_tpu' or m.startswith('lac_tpu.')]; "
        "sys.exit(f'imported {bad}' if bad else 0)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)

"""The port's CLI (python -m lac_tpu_torch) with --device cpu: compress,
decompress, info and verify, with containers identical to lac_tpu's."""

import os
import subprocess
import sys

import pytest

from lac_tpu.native.host import native_compress
from lac_tpu_torch import cli
from lac_tpu_torch.smoke import smoke_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def corpus_file(tmp_path):
    path = tmp_path / "data.bin"
    path.write_bytes(smoke_corpus(6000))
    return str(path)


def test_compress_decompress_defaults(corpus_file, capsys):
    assert cli.main(["compress", corpus_file, "--device", "cpu"]) == 0
    with open(corpus_file + ".lac", "rb") as f:
        container = f.read()
    # CLI defaults: order0n, block 4096, rate 4
    assert container == native_compress(smoke_corpus(6000), block_size=4096)
    os.remove(corpus_file)
    assert cli.main(["decompress", corpus_file + ".lac", "--device", "cpu"]) == 0
    with open(corpus_file, "rb") as f:
        assert f.read() == smoke_corpus(6000)
    assert "bpb" in capsys.readouterr().out


def test_block_size_option(corpus_file, tmp_path):
    out = str(tmp_path / "b1024.lac")
    assert cli.main(["compress", corpus_file, "-o", out, "--block-size", "1024",
                     "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        assert f.read() == native_compress(smoke_corpus(6000), block_size=1024)


@pytest.mark.parametrize("model", ["order1n", "order2n", "order0c"])
def test_model_option(corpus_file, tmp_path, model):
    out = str(tmp_path / f"{model}.lac")
    assert cli.main(["compress", corpus_file, "-o", out, "--model", model,
                     "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        assert f.read() == native_compress(smoke_corpus(6000), block_size=4096, model=model)
    back = str(tmp_path / f"{model}.out")
    assert cli.main(["decompress", out, "-o", back, "--device", "cpu"]) == 0
    with open(back, "rb") as f:
        assert f.read() == smoke_corpus(6000)


def test_info_and_verify(corpus_file, capsys):
    cli.main(["compress", corpus_file, "--device", "cpu"])
    capsys.readouterr()
    assert cli.main(["info", corpus_file + ".lac"]) == 0
    out = capsys.readouterr().out
    assert "model=order0n" in out and "original_len=6000 blocks=2" in out
    assert cli.main(["verify", corpus_file + ".lac"]) == 0
    assert "all block checksums OK" in capsys.readouterr().out
    with open(corpus_file + ".lac", "rb") as f:
        data = bytearray(f.read())
    data[-5] ^= 0x55
    with open(corpus_file + ".lac", "wb") as f:
        f.write(bytes(data))
    assert cli.main(["verify", corpus_file + ".lac"]) == 1
    assert "CORRUPT blocks" in capsys.readouterr().out


def test_lm_model_not_ported(corpus_file):
    with pytest.raises(SystemExit, match="slice 3"):
        cli.main(["compress", corpus_file, "--model", "lm", "--device", "cpu"])


def test_module_entry_point(corpus_file):
    proc = subprocess.run(
        [sys.executable, "-m", "lac_tpu_torch", "compress", corpus_file,
         "-o", corpus_file + ".m.lac", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    with open(corpus_file + ".m.lac", "rb") as f:
        assert f.read() == native_compress(smoke_corpus(6000), block_size=4096)

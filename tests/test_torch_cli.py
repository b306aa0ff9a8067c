"""The port's CLI (python -m lac_tpu_torch) with --device cpu: compress,
decompress, info and verify, with containers identical to lac_tpu's;
--model lm round trips; recover on truncated turbo and LM containers."""

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


@pytest.fixture
def one_thread():
    """One intra-op thread for the LM runs' many small ops (see
    tests/test_torch_lm.py's ``_one_thread``); the count comes back after."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LM_SMALL = ["--model", "lm", "--model-ref", "prng:tiny:0", "--block-tokens", "64",
            "--lanes", "4", "--cache-grow", "16", "--device", "cpu"]


def test_lm_model_not_ported(one_thread, corpus_file, capsys):
    """Named for what it checked before the LM path was ported (that
    --model lm raised); now --model lm round-trips on the CPU through
    compress and decompress, and the container records the CLI's
    settings."""
    from lac_tpu_torch.stream.container import read_container

    assert cli.main(["compress", corpus_file, *LM_SMALL]) == 0
    with open(corpus_file + ".lac", "rb") as f:
        header, blocks = read_container(f.read())
    assert header.model_id == "lm" and header.prob_bits == 16 and len(blocks) == 94
    assert {k: header.config[k] for k in ("model_ref", "block_tokens", "lanes", "cache_grow",
                                          "window_mode", "slide_seg")} == {
        "model_ref": "prng:tiny:0", "block_tokens": 64, "lanes": 4, "cache_grow": 16,
        "window_mode": "slide", "slide_seg": 0}
    os.remove(corpus_file)
    assert cli.main(["decompress", corpus_file + ".lac", "--device", "cpu"]) == 0
    with open(corpus_file, "rb") as f:
        assert f.read() == smoke_corpus(6000)
    assert "bpb" in capsys.readouterr().out


@pytest.mark.parametrize("flag,item", [("--mesh-model=2", "torchrun --nproc-per-node")])
def test_lm_unported_flags_exit(one_thread, corpus_file, flag, item):
    with pytest.raises(SystemExit, match=item):
        cli.main(["compress", corpus_file, *LM_SMALL, flag])


@pytest.mark.parametrize("flags", [["--kv8"], ["--w8"], ["--kv8", "--w8"]])
def test_lm_int8_flags_round_trip(one_thread, corpus_file, flags):
    """--kv8 and --w8 (alone and together) reach the coding config: the
    header records them, and decompress, which reads the modes from the
    header, gives the bytes back."""
    from lac_tpu_torch.stream.container import read_container

    assert cli.main(["compress", corpus_file, *LM_SMALL, *flags]) == 0
    with open(corpus_file + ".lac", "rb") as f:
        header, _ = read_container(f.read())
    assert (header.config["kv8"], header.config["w8"]) == ("--kv8" in flags, "--w8" in flags)
    os.remove(corpus_file)
    assert cli.main(["decompress", corpus_file + ".lac", "--device", "cpu"]) == 0
    with open(corpus_file, "rb") as f:
        assert f.read() == smoke_corpus(6000)


def test_lm_block_past_the_context_exits(one_thread, corpus_file):
    """Named for what it checked before the windowed schedules were ported
    (that a block past the context exited naming A6); now such a block
    (300 tokens, tiny's context is 256) round-trips through compress and
    decompress on the CPU, and the header records the resolved mode."""
    from lac_tpu_torch.stream.container import read_container

    args = [*LM_SMALL, "--block-tokens", "300", "--lanes", "2"]
    assert cli.main(["compress", corpus_file, *args]) == 0
    with open(corpus_file + ".lac", "rb") as f:
        header, blocks = read_container(f.read())
    assert len(blocks) == 20 and header.config["max_seq"] == 256
    assert {k: header.config[k] for k in ("block_tokens", "lanes", "window_mode",
                                          "slide_seg")} == {
        "block_tokens": 300, "lanes": 2, "window_mode": "slide", "slide_seg": 512}
    os.remove(corpus_file)
    assert cli.main(["decompress", corpus_file + ".lac", "--device", "cpu"]) == 0
    with open(corpus_file, "rb") as f:
        assert f.read() == smoke_corpus(6000)


def test_lm_compress_defaults_to_the_card(corpus_file):
    """No --device means cuda: without a card, compress --model lm raises
    rather than running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["compress", corpus_file, "--model", "lm"])


def test_engine_names_lm_decompress_bytes_for_an_lm_container(one_thread, corpus_file):
    from lac_tpu_torch.runtime import engine

    cli.main(["compress", corpus_file, *LM_SMALL])
    with open(corpus_file + ".lac", "rb") as f:
        container = f.read()
    with pytest.raises(ValueError, match="lm_decompress_bytes"):
        engine.decompress_bytes(container, device="cpu")


def _truncated(path, blocks_kept):
    """The container at ``path`` cut inside the payload of block
    ``blocks_kept``, written beside it."""
    from lac_tpu_torch.stream.container import read_container

    with open(path, "rb") as f:
        data = f.read()
    _, blocks = read_container(data)
    cut = data[: len(data) - sum(len(b.payload) for b in blocks[blocks_kept + 1:]) - 5]
    out = path + ".cut"
    with open(out, "wb") as f:
        f.write(cut)
    return out


def test_recover_turbo_container_matches_lac_tpu(tmp_path, capsys):
    from lac_tpu.cli import main as jmain

    data = smoke_corpus(3 * 4096 + 100)
    src = tmp_path / "t.bin"
    src.write_bytes(data)
    assert cli.main(["compress", str(src), "--device", "cpu"]) == 0
    cut = _truncated(str(src) + ".lac", 2)
    capsys.readouterr()
    rc = cli.main(["recover", cut, "-o", str(tmp_path / "port.out"), "--device", "cpu"])
    port_line = capsys.readouterr().out.replace(str(tmp_path / "port.out"), "OUT")
    jrc = jmain(["recover", cut, "-o", str(tmp_path / "ref.out")])
    ref_line = capsys.readouterr().out.replace(str(tmp_path / "ref.out"), "OUT")
    assert rc == jrc == 1
    assert port_line == ref_line and "recovered 2/4 blocks (8192/12388 bytes)" in port_line
    assert (tmp_path / "port.out").read_bytes() == (tmp_path / "ref.out").read_bytes() == data[:8192]


def test_recover_lm_container_keeps_the_intact_prefix(one_thread, corpus_file, capsys):
    cli.main(["compress", corpus_file, *LM_SMALL])
    cut = _truncated(corpus_file + ".lac", 7)
    capsys.readouterr()
    out = corpus_file + ".rec"
    assert cli.main(["recover", cut, "-o", out, "--device", "cpu"]) == 1
    with open(out, "rb") as f:
        assert f.read() == smoke_corpus(6000)[: 7 * 64]
    assert "recovered 7/94 blocks (448/6000 bytes)" in capsys.readouterr().out
    assert cli.main(["recover", corpus_file + ".lac", "-o", out, "--device", "cpu"]) == 0


def test_module_entry_point(corpus_file):
    proc = subprocess.run(
        [sys.executable, "-m", "lac_tpu_torch", "compress", corpus_file,
         "-o", corpus_file + ".m.lac", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    with open(corpus_file + ".m.lac", "rb") as f:
        assert f.read() == native_compress(smoke_corpus(6000), block_size=4096)

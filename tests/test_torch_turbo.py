"""The port's turbo path (lac_tpu_torch.runtime) on the CPU against lac_tpu,
for each of its four models (order0c, order0n, order1n, order2n): containers
byte-identical to lac_tpu's turbo (Pallas in interpret mode) for small
inputs and to lac_tpu's native coder (bit-identical to the Pallas path) for
larger ones, and each package decodes the other's containers."""

import fcntl
import os
import subprocess

import numpy as np
import pytest

from lac_tpu.native import host as native_host
from lac_tpu.native.host import native_compress, native_decompress
from lac_tpu.runtime import engine as ref_engine
from lac_tpu.runtime import turbo as ref_turbo
from lac_tpu.stream.container import read_container as ref_read
from lac_tpu_torch.runtime import engine, turbo
from lac_tpu_torch.smoke import smoke_corpus
from lac_tpu_torch.stream.container import read_container

CPU = "cpu"
MODELS = ("order0c", "order0n", "order1n", "order2n")


def _load_native_coder_once():
    """Load lac_tpu's native coder under a file lock beside the library, and
    recover it in a process where it was latched off. lac_tpu.native.host
    builds the library on first use with ``g++ -o`` straight into one shared
    path, and a process whose first load fails (it met another process's
    g++ halfway through that file) keeps the coder unavailable for good
    (``_tried``). Under several pytest workers that failed every native
    comparison of a module. A worker may have loaded the coder unlocked
    before it imports this module (tests/test_native.py asks for it while
    it is collected), so under the lock a failed load is tried again, and
    if that fails too, a whole library is built aside and moved into place
    at once before the last try."""
    path = native_host._so_path()
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if native_host._load() is not None:
            return
        native_host._tried = False
        if native_host._load() is not None:
            return
        tmp = f"{path}.{os.getpid()}"
        built = subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                                "-o", tmp, native_host._SRC], capture_output=True)
        if built.returncode == 0:
            os.replace(tmp, path)
        native_host._tried = False
        native_host._load()


_load_native_coder_once()


def _random_bytes(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


SMALL = {
    "empty": b"",
    "1byte": b"q",
    "1023": smoke_corpus(1023),
    "1025": smoke_corpus(1025),
    "random": _random_bytes(3000),
}
LARGE = {
    "random": _random_bytes(40000, seed=4),
    "smoke_corpus": smoke_corpus(192 << 10),
}


@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("model", MODELS)
def test_small_inputs_identical_to_pallas_turbo(model, name, block):
    data = SMALL[name]
    ours = turbo.turbo_compress(data, block_size=block, model=model, device=CPU)
    ref = ref_turbo.turbo_compress(data, block_size=block, model=model)
    assert ours == ref
    assert turbo.turbo_decompress(ref, device=CPU) == data
    assert ref_turbo.turbo_decompress(ours) == data


@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("name", sorted(LARGE))
@pytest.mark.parametrize("model", MODELS)
def test_large_inputs_identical_to_native(model, name, block):
    data = LARGE[name]
    ours = engine.compress_bytes(data, model_id=model, block_size=block, device=CPU)
    ref = native_compress(data, block_size=block, model=model)
    assert ours == ref
    assert engine.decompress_bytes(ref, device=CPU) == data
    assert native_decompress(ours) == data
    header, blocks = read_container(ours)
    if name == "random":  # incompressible: every full block is stored raw
        assert all(b.token_count == 0 for b in blocks)
    else:
        assert all(b.token_count == b.raw_len for b in blocks)


def test_empty_input_is_one_block_of_state_words():
    _, blocks = read_container(turbo.turbo_compress(b"", device=CPU))
    assert len(blocks) == 1
    assert (blocks[0].raw_len, blocks[0].token_count, blocks[0].payload) == (
        0, 0, b"\x00\x01\x00\x00")


@pytest.mark.parametrize("model", ["order0n", "order1n"])
def test_block_8192_raises_where_lac_tpu_falls_back_to_order0c(model):
    """Their codec gates refuse block 8192: the port records order0c there,
    as lac_tpu does, and raises nothing."""
    data = smoke_corpus(9000)
    ref = native_compress(data, block_size=8192, model=model)
    assert ref_read(ref)[0].model_id == "order0c"
    ours = turbo.turbo_compress(data, block_size=8192, model=model, device=CPU)
    assert read_container(ours)[0].model_id == "order0c"
    assert ours == ref
    assert turbo.turbo_decompress(ref, device=CPU) == data


def test_order2n_block_8192_identical_to_native():
    """The order2n gate admits block 8192, where order0n and order1n fall
    back to order0c: lac_tpu records order2n."""
    data = smoke_corpus(20000) + _random_bytes(9000, seed=5)
    ours = turbo.turbo_compress(data, block_size=8192, model="order2n", device=CPU)
    ref = native_compress(data, block_size=8192, model="order2n")
    assert ref_read(ref)[0].model_id == "order2n"
    assert ours == ref
    assert turbo.turbo_decompress(ref, device=CPU) == data
    assert native_decompress(ours) == data


def test_engine_clamps_block_size_like_lac_tpu():
    data = smoke_corpus(5000)
    ours = engine.compress_bytes(data, model_id="order0n", block_size=1 << 16, device=CPU)
    assert read_container(ours)[0].config == {"block_size": 4096, "rate": 4}
    assert ours == native_compress(data, block_size=4096)
    assert ref_engine.decompress_bytes(ours) == data


def test_decompress_blocks_random_access():
    data = smoke_corpus(5000) + _random_bytes(1100)
    c = engine.compress_bytes(data, model_id="order0n", block_size=1024, device=CPU)
    got = engine.decompress_blocks(c, [5, 0, 3], device=CPU)
    assert got == [data[5120:], data[:1024], data[3072:4096]]


def test_engine_decode_parses_the_container_once(monkeypatch):
    from lac_tpu_torch.runtime import engine as engine_mod
    from lac_tpu_torch.stream import container as container_mod

    data = smoke_corpus(5000)
    c = engine.compress_bytes(data, model_id="order0n", block_size=1024, device=CPU)
    calls = []

    def counting_scan(buf):
        calls.append(len(buf))
        return scan(buf)

    scan = container_mod.scan_container
    monkeypatch.setattr(container_mod, "scan_container", counting_scan)
    assert engine_mod.decompress_bytes(c, device=CPU) == data
    assert engine_mod.decompress_blocks(c, [2], device=CPU) == [data[2048:3072]]
    assert calls == [len(c), len(c)]


def test_unported_models_and_codecs_raise():
    """The scan model order0 and a block size off the 256 grid raise; order0c
    containers, and the order0c fallback of order0n and order1n, are
    byte-identical to lac_tpu's both ways."""
    data = smoke_corpus(3000)
    ours = turbo.turbo_compress(data, model="order0c", device=CPU)
    ref = native_compress(data, model="order0c")
    assert ours == ref
    assert engine.decompress_bytes(ref, device=CPU) == data
    assert native_decompress(ours) == data
    for model in ("order0n", "order1n"):  # their order0c fallback
        ours = turbo.turbo_compress(data, block_size=8192, model=model, device=CPU)
        ref = native_compress(data, block_size=8192, model=model)
        assert ours == ref
        assert engine.decompress_bytes(ref, device=CPU) == data
        assert native_decompress(ours) == data
    with pytest.raises(NotImplementedError):
        engine.compress_bytes(data, model_id="order0", device=CPU)
    with pytest.raises(ValueError):
        turbo.turbo_compress(data, block_size=1000, device=CPU)


@pytest.mark.parametrize("model", MODELS)
def test_lanes_split_over_several_launches(monkeypatch, model):
    """At most ``_LANES_PER_LAUNCH`` lanes go to one kernel launch: with 3,
    ten blocks (raw and coded, and a short last one) go in four groups each
    way, and the container and the decode stay those of one launch."""
    monkeypatch.setattr(turbo, "_LANES_PER_LAUNCH", 3)
    data = smoke_corpus(5000) + _random_bytes(2048, seed=6) + smoke_corpus(2900)
    ours = engine.compress_bytes(data, model_id=model, block_size=1024, device=CPU)
    assert len(read_container(ours)[1]) == 10
    assert ours == native_compress(data, block_size=1024, model=model)
    assert engine.decompress_bytes(ours, device=CPU) == data
    picks = [9, 0, 5, 6, 2, 7, 1]
    assert engine.decompress_blocks(ours, picks, device=CPU) == [
        data[i * 1024 : (i + 1) * 1024] for i in picks]


def test_default_device_is_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        turbo.turbo_compress(b"abc")

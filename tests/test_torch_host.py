"""The port's host layers against lac_tpu's, byte for byte: the oracle
arithmetic coder under every predictor and precision, its streaming form,
base-N conversion, rescale_cdf, bit framing, the metrics tools, the native
host coder (its source and its containers), smoke.GOLDEN_HOST, and the
CLI's bench."""

import fcntl
import io
import json
import os
import random
import subprocess
import zlib

import numpy as np
import pytest

import lac_tpu.coder as ref_coder
import lac_tpu.models as ref_models
from lac_tpu import metrics as ref_metrics
from lac_tpu.native import host as ref_native
from lac_tpu.ops.quantize import rescale_cdf as ref_rescale
from lac_tpu.utils import baseconv as ref_baseconv
from lac_tpu.utils import bits as ref_bits
from lac_tpu_torch import cli, metrics, smoke
from lac_tpu_torch import coder, models
from lac_tpu_torch.native import host as native
from lac_tpu_torch.ops.quantize import rescale_cdf
from lac_tpu_torch.utils import baseconv, bits


def _predictors(m):
    """tests/test_coder_reference.py's PREDICTORS over the classes of ``m``."""
    return {
        "uniform3": (lambda: m.Uniform(3), 3),
        "uniform10": (lambda: m.Uniform(10), 10),
        "static": (lambda: m.StaticCDF([5, 6, 30, 31]), 4),
        "order0": (lambda: m.AdaptiveOrder0(8), 8),
        "history": (lambda: m.HistoryRL(5, window=32), 5),
        "markov2": (lambda: m.MarkovMix(4, order=2), 4),
        "fsm": (lambda: m.FSMPredictor(2, [([9, 1], [0, 1]), ([1, 9], [0, 1])]), 2),
        "ppm": (lambda: m.PPM(6, order=2), 6),
    }


PREDICTORS = list(_predictors(models))


@pytest.mark.parametrize("precision", [16, 24, 48])
@pytest.mark.parametrize("name", PREDICTORS)
def test_oracle_coder_payloads_equal_lac_tpu(name, precision):
    """Every predictor and precision of lac_tpu's own coder test: the port's
    payload and exact bit count equal lac_tpu's, and decode back."""
    make, n = _predictors(models)[name]
    ref_make, _ = _predictors(ref_models)[name]
    rng = random.Random(f"{name}:{precision}")
    for length in (0, 1, 2, 3, 17, 100, 400):
        msg = [rng.randrange(n) for _ in range(length)]
        got = coder.ac_encode(msg, make(), precision)
        assert got == ref_coder.ac_encode(msg, ref_make(), precision), length
        assert coder.ac_decode(got[0], length, make(), precision, nbits=got[1]) == msg


def test_streaming_equals_lac_tpu():
    """Pushed a symbol at a time, the port's StreamingEncoder gives
    lac_tpu's bytes, push by push, and its StreamingDecoder the symbols,
    byte by byte, that lac_tpu's gives."""
    data = list(smoke.smoke_corpus(600))
    enc, ref = coder.StreamingEncoder(models.PPM(256, 2)), \
        ref_coder.StreamingEncoder(ref_models.PPM(256, 2))
    pushes = [enc.push(s) for s in data] + [enc.finish()]
    assert pushes == [ref.push(s) for s in data] + [ref.finish()]
    payload = b"".join(pushes)
    assert payload == coder.ac_encode(data, models.PPM(256, 2))[0]
    dec, rdec = coder.StreamingDecoder(models.PPM(256, 2)), \
        ref_coder.StreamingDecoder(ref_models.PPM(256, 2))
    got = [dec.push(payload[i:i + 1]) for i in range(len(payload))]
    assert got == [rdec.push(payload[i:i + 1]) for i in range(len(payload))]
    tail = dec.finish(len(data))
    assert tail == rdec.finish(len(data))
    assert [s for chunk in got for s in chunk] + tail == data


@pytest.mark.parametrize("base,precision", [(2, 16), (10, 48), (36, 24), (1000, 48)])
def test_baseconv_both_ways_equal_lac_tpu(base, precision):
    digits = np.random.default_rng(base).integers(0, base, 300).tolist()
    got = baseconv.digits_to_bytes(digits, base, precision)
    assert got == ref_baseconv.digits_to_bytes(digits, base, precision)
    back = baseconv.bytes_to_digits(got[0], len(digits), base, precision, nbits=got[1])
    assert back == ref_baseconv.bytes_to_digits(got[0], len(digits), base, precision,
                                                nbits=got[1]) == digits
    with pytest.raises(ValueError, match="base must be >= 2"):
        baseconv.digits_to_bytes([0], 1)
    with pytest.raises(ValueError, match="digit out of range"):
        baseconv.digits_to_bytes([base], base)


def test_rescale_cdf_equals_lac_tpu():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 256):
        for _ in range(20):
            cdf = np.cumsum(rng.integers(0, 1000, n)).tolist()
            cdf[-1] += 1
            for denom in (n, n + 1, 1 << 16, (1 << 48) - 12345, cdf[-1]):
                got = rescale_cdf(cdf, denom)
                assert got == ref_rescale(cdf, denom) and got[-1] == denom
    for fn in (rescale_cdf, ref_rescale):
        with pytest.raises(ValueError, match="denom 3 < alphabet size 4: not codable"):
            fn([1, 2, 3, 4], 3)


def test_bits_equal_lac_tpu():
    rng = np.random.default_rng(9)
    stream = rng.integers(0, 2, 1001).tolist()
    assert bits.pack_bits(stream) == ref_bits.pack_bits(stream)
    packed = bits.pack_bits(stream)
    assert list(bits.unpack_bits(packed, 1001)) == list(ref_bits.unpack_bits(packed, 1001)) \
        == stream
    w, rw = bits.BitWriter(), ref_bits.BitWriter()
    drained = []
    for i, v in enumerate(rng.integers(0, 1 << 12, 50).tolist()):
        w.write_int(v, 12)
        rw.write_int(v, 12)
        if i % 7 == 0:
            drained.append((w.drain(), rw.drain()))
    assert all(a == b for a, b in drained)
    assert (w.bits_written, w.flush_partial()) == (rw.bits_written, rw.flush_partial())
    r, rr = bits.BitReader(packed, nbits=1001, pad_bit=1), \
        ref_bits.BitReader(packed, nbits=1001, pad_bit=1)
    assert [r.read_int(13) for _ in range(80)] == [rr.read_int(13) for _ in range(80)]
    assert r.overrun == rr.overrun == 80 * 13 - 1001


def test_metrics_equal_lac_tpu():
    data = smoke.smoke_corpus(3000)
    for order in (1, 2, 3):
        assert metrics.ngram_stats(data, order) == ref_metrics.ngram_stats(data, order)
    log, ref_log = io.StringIO(), io.StringIO()
    payload, stats = metrics.measure_compress(data, models.AdaptiveOrder0(256),
                                              report_every=1000, out=log)
    ref_payload, ref_stats = ref_metrics.measure_compress(data, ref_models.AdaptiveOrder0(256),
                                                          report_every=1000, out=ref_log)
    assert payload == ref_payload and log.getvalue() == ref_log.getvalue()
    assert "3000 symbols ->" in log.getvalue()
    assert {k: v for k, v in stats.items() if "second" not in k and "_per_s" not in k} == \
        {k: v for k, v in ref_stats.items() if "second" not in k and "_per_s" not in k}
    rng = np.random.default_rng(2)
    freq = rng.integers(0, 1 << 16, (4, 50))
    lengths, sizes = np.array([50, 0, 17, 33]), np.array([40, 1, 9, 30])
    got, want = metrics.stream_stats(freq, lengths, sizes, 16), \
        ref_metrics.stream_stats(freq, lengths, sizes, 16)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_profile_trace_and_logger(tmp_path):
    """profile_trace writes a Chrome trace into its directory; JsonlLogger
    writes one sorted JSON object a line."""
    import torch

    with metrics.profile_trace(str(tmp_path / "prof")) as path:
        torch.ones(64).cumsum(0)
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    log = metrics.JsonlLogger(str(tmp_path / "log.jsonl"))
    log.log("step", b=2, a=1)
    rec = json.loads((tmp_path / "log.jsonl").read_text())
    assert (rec["event"], rec["a"], rec["b"]) == ("step", 1, 2)
    t = metrics.Throughput("x")
    t.add(nbytes=10, nsymbols=5)
    assert set(t.report()) == {"name", "seconds", "MB_per_s", "symbols_per_s"}


def _trace(path, launches, kernels):
    """A Chrome trace of a warm-up span, ``launches`` runtime launches and
    ``kernels`` device events (each a correlation id)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": metrics.WARM_UP, "ts": 0, "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "warm", "ts": 6, "dur": 1,
           "args": {"correlation": 1}}]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": name, "ts": 20 + i, "dur": 1,
            "args": {"correlation": c}} for i, (name, c) in enumerate(launches)]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 40 + i, "dur": 1,
            "args": {"correlation": c}} for i, c in enumerate(kernels)]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_profile_trace_refuses_a_blind_trace(tmp_path):
    """The check behind profile_trace on the card (ROADMAP C5): a trace whose
    kernel launches after the warm-up each have a device event passes; one
    that lacks any launch's kernel raises and is removed. The warm-up's own
    launch may lose its kernel, which is what it is for."""
    ok = tmp_path / "ok.json"
    _trace(ok, [("cudaLaunchKernel", 7), ("cudaLaunchKernelExC", 8), ("cudaMemcpyAsync", 9)],
           [7, 8])
    metrics._check_device_events(str(ok))
    assert ok.exists()
    warm_lost = tmp_path / "warm.json"
    _trace(warm_lost, [("cudaLaunchKernel", 7)], [7])
    ev = json.loads(warm_lost.read_text())
    ev["traceEvents"] = [e for e in ev["traceEvents"] if e["name"] != "warm"]
    warm_lost.write_text(json.dumps(ev))
    metrics._check_device_events(str(warm_lost))
    blind = tmp_path / "blind.json"
    _trace(blind, [("cudaLaunchKernel", 7), ("cudaLaunchKernel", 8)], [8])
    with pytest.raises(RuntimeError, match="1 of 2 kernel launches have no device event"):
        metrics._check_device_events(str(blind))
    assert not blind.exists()


def test_native_source_is_lac_tpu_s():
    with open(native._SRC, "rb") as f, open(ref_native._SRC, "rb") as g:
        assert f.read() == g.read()


def _load_ref_native():
    """lac_tpu's native coder, under the file lock that
    tests/test_torch_turbo.py builds it under (lac_tpu.native.host builds
    straight into one shared path, and a process whose first load fails
    keeps it off: ROADMAP C3)."""
    path = ref_native._so_path()
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if ref_native._load() is not None:
            return
        ref_native._tried = False
        if ref_native._load() is not None:
            return
        tmp = f"{path}.{os.getpid()}"
        built = subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                                "-o", tmp, ref_native._SRC], capture_output=True)
        if built.returncode == 0:
            os.replace(tmp, path)
        ref_native._tried = False
        ref_native._load()


@pytest.mark.parametrize("block", [1024, 4096, 8192])
@pytest.mark.parametrize("model", native.MODELS)
def test_native_containers_equal_lac_tpu_s(model, block):
    """The port's native_compress gives lac_tpu's containers (order0n and
    order1n at block 8192 record order0c, as the codec gate says) and
    decodes them; the empty input too."""
    _load_ref_native()
    data = smoke.smoke_corpus(300 << 10)
    c = native.native_compress(data, block_size=block, model=model)
    assert c == ref_native.native_compress(data, block_size=block, model=model)
    assert native.native_decompress(c) == data
    assert native.native_compress(b"", block_size=block, model=model) == \
        ref_native.native_compress(b"", block_size=block, model=model)


def test_native_build_is_locked_and_renamed(monkeypatch, tmp_path):
    """A build goes to a temporary name and is renamed into place, under a
    lock file beside the library; a build whose library is already there
    (another process built it) does nothing."""
    calls = []
    real_run = subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", run)
    path = native.so_path()
    assert os.path.dirname(path) == str(tmp_path)
    native._build(path)
    assert os.path.isfile(path) and os.path.isfile(path + ".lock")
    out = calls[0][calls[0].index("-o") + 1]
    assert out != path and not os.path.exists(out)
    native._build(path)
    assert len(calls) == 1
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(path),
                                                   os.path.basename(path) + ".lock"])


@pytest.mark.parametrize("name", list(smoke.GOLDEN_HOST))
def test_golden_host_recomputed_with_lac_tpu(name):
    """smoke.GOLDEN_HOST: lac_tpu's payload of the corpus's first 16 KiB."""
    payload, nbits = smoke.host_payloads(ref_models, ref_coder, names=[name])[name]
    assert (zlib.crc32(payload), len(payload), nbits) == smoke.GOLDEN_HOST[name]


def test_cli_bench(tmp_path, capsys):
    _load_ref_native()
    path = tmp_path / "data.bin"
    path.write_bytes(smoke.smoke_corpus(5000))
    assert cli.main(["bench", str(path), "--block-size", "1024", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep) == {"file", "model", "bytes", "compressed", "bits_per_byte", "encode_MBps",
                        "decode_MBps", "roundtrip_ok"}
    assert rep["roundtrip_ok"] is True and rep["model"] == "order0n" and rep["bytes"] == 5000
    assert rep["compressed"] == len(ref_native.native_compress(smoke.smoke_corpus(5000),
                                                               block_size=1024))

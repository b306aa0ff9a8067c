"""The port's LM coding path against lac_tpu's on the CPU: the batched
rANS-64/32 coder, the integer CDF, the cached decode step and the LM
container round trip (lac_tpu_torch.coder.vector, ops.quantize,
models.transformer, runtime.lm_engine and runtime.lm_api).

Tolerances:
- the coder: integer-exact. Words, word counts and decoded symbols equal
  lac_tpu.coder.vector's and the rans_encode_np spec's.
- the integer CDF: cdf_from_freq and gather_intervals equal lac_tpu's
  exactly; the integer stage, fed lac_tpu's own float stage (its jnp ops
  run one by one, as lac_tpu runs them outside jit), gives its frequencies
  exactly. The whole quantize_logits sums to 2^pb with every frequency
  >= 1 and differs from lac_tpu's by at most 1 count in at most 0.1 % of
  the entries other than a row's argmax, and at the argmax by at most the
  number of such entries in the row (it takes the residual): exp may
  differ by an ulp, which moves a floor by one.
- the decode step: logits within 2e-5 (f32) / 3e-2 (bf16) of max |logit|
  against lac_tpu.models.transformer.forward(prefill=False), step by step
  under the growing-cache schedule, and the cache at the end within the
  same tolerance of max |K| and |V|; the same tolerances against the port's
  own prefill logits. These are the prefill tests' tolerances
  (tests/test_torch_transformer.py).
- the slice: the port's containers round-trip bit-exactly; their headers
  equal lac_tpu's for the same call in every key but ``fingerprint``; the
  payload bits are within 0.5 % of lac_tpu's; each package refuses the
  other's container with the fingerprint error.

Parameters come from one JAX init carried across by
``convert.lm_params_from_jax``; inputs from numpy seeds. The slice tests
need a model that compresses (random weights store every block raw, which
would leave the payload comparison empty), so they train the tiny f32
config for 60 steps in the port (a few seconds) and carry it to lac_tpu
with ``convert.lm_params_to_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.coder import rans as jrans
from lac_tpu.coder import vector as jvec
from lac_tpu.models import transformer as JT
from lac_tpu.ops import quantize as JQ
from lac_tpu.runtime import lm_api as japi
from lac_tpu.runtime import lm_engine as jeng
from lac_tpu.stream.container import read_container as j_read_container
from lac_tpu_torch.coder import rans as trans
from lac_tpu_torch.coder import vector as tvec
from lac_tpu_torch.config import MeshConfig
from lac_tpu_torch.convert import lm_params_to_jax
from lac_tpu_torch.models import lm_registry as treg
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.ops import quantize as Q
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.runtime import lm_engine as E
from lac_tpu_torch.smoke import smoke_corpus
from lac_tpu_torch.stream.container import read_container
from lac_tpu_torch.train import train_byte_lm
from test_torch_transformer import _rel, carried, port_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny and their steps many small ops: one intra-op
    thread runs them fastest and keeps them off the other test workers'
    cores (under six workers, eight threads a process made this file ten
    times slower). The process's count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# The coder
# --------------------------------------------------------------------------


def _random_intervals(pb, b=7, t=48, v=256, seed=0):
    """Per-lane, per-position CDFs (every freq >= 1, sum 2^pb), coded
    symbols, ragged lengths with 0 and 1, and lane 6 whose every symbol has
    freq 1: the most words the spec can emit."""
    rng = np.random.default_rng(seed + pb)
    w = rng.gamma(0.3, size=(b, t, v))
    freq = np.floor(w / w.sum(-1, keepdims=True) * ((1 << pb) - v)).astype(np.int64) + 1
    freq[..., 0] += (1 << pb) - freq.sum(-1)
    freq[6, :, 1] = 1
    freq[6, :, 0] = (1 << pb) - freq[6, :, 1:].sum(-1)
    cdf = np.concatenate([np.zeros((b, t, 1), np.int64), np.cumsum(freq, -1)], -1)
    syms = rng.integers(0, v, (b, t))
    syms[6] = 1
    lengths = np.array([t, 0, 1, 17, t - 1, 29, t], np.int64)
    lo = np.take_along_axis(cdf, syms[..., None], -1)[..., 0]
    f = np.take_along_axis(cdf, syms[..., None] + 1, -1)[..., 0] - lo
    return cdf.astype(np.int32), syms, lengths, lo, f


@pytest.mark.parametrize("pb", [12, 16, 17])
def test_coder_matches_lac_tpu_and_the_spec(pb):
    cdf, syms, lengths, lo, f = _random_intervals(pb)
    words, nwords = tvec.rans_encode_batch(torch.from_numpy(lo), torch.from_numpy(f),
                                           torch.from_numpy(lengths), pb)
    jwords, jnwords = jvec.rans_encode_batch(lo, f, lengths.astype(np.int32), pb)
    assert words.dtype == torch.int64 and tuple(words.shape) == (7, 50)
    assert np.array_equal(nwords.numpy(), np.asarray(jnwords))
    assert np.array_equal(words.numpy(), np.asarray(jwords).astype(np.int64))
    for i, n in enumerate(lengths):
        spec = jrans.rans_encode_np(lo[i, :n], f[i, :n], pb)
        assert np.array_equal(trans.rans_encode_np(lo[i, :n], f[i, :n], pb), spec)
        assert np.array_equal(words.numpy()[i, : nwords[i]], spec.astype(np.int64))
    # lane 6 codes freq-1 symbols: it emits as often as the spec allows
    assert int(nwords[6]) - 2 >= 48 // 3
    out = tvec.rans_decode_scan(words, torch.from_numpy(cdf), torch.from_numpy(lengths), pb)
    jout = np.asarray(jvec.rans_decode_scan(np.asarray(jwords), cdf, lengths.astype(np.int32),
                                            pb))
    assert np.array_equal(out.numpy(), jout)
    live = np.arange(48)[None, :] < lengths[:, None]
    assert np.array_equal(np.where(live, syms, 0), out.numpy())
    # the port's spec decode of a lane
    got = trans.rans_decode_np(words.numpy()[0].astype(np.uint32), 48,
                               lambda t, _: cdf[0, t], pb)
    assert got == list(syms[0])


# --------------------------------------------------------------------------
# The integer CDF
# --------------------------------------------------------------------------


def _logits(v, scale, seed=3):
    return (np.random.default_rng(seed).standard_normal((64, v)) * scale).astype(np.float32)


def _jax_float_stage(logits, pb):
    """lac_tpu's float stage, lac_tpu/ops/quantize.py:153-160 (det=False)."""
    v = logits.shape[-1]
    x = jnp.asarray(logits).astype(jnp.float32)
    x = x - jnp.max(x, axis=-1, keepdims=True)
    p = jnp.exp(x)
    scale = jnp.float32((1 << pb) - v) / jnp.sum(p, axis=-1, keepdims=True)
    return np.array(jnp.floor(p * scale).astype(jnp.int32))


@pytest.mark.parametrize("v,pb,scale", [(256, 16, 3.0), (256, 12, 8.0), (1000, 17, 4.0)])
def test_quantize_matches_lac_tpu(v, pb, scale):
    logits = _logits(v, scale)
    jfreq = np.array(JQ.quantize_logits(jnp.asarray(logits), pb))
    # the integer stage on lac_tpu's own floors: exact
    assert np.array_equal(
        Q.freq_from_floor(torch.from_numpy(_jax_float_stage(logits, pb)), pb).numpy(), jfreq)
    # the whole function
    freq = Q.quantize_logits(torch.from_numpy(logits), pb)
    assert freq.dtype == torch.int32
    assert (freq.sum(-1) == (1 << pb)).all() and (freq >= 1).all()
    d = freq.numpy().astype(np.int64) - jfreq
    amax = np.zeros_like(d, bool)
    amax[np.arange(len(d)), jfreq.argmax(-1)] = True
    others = np.where(amax, 0, d)
    assert np.abs(others).max() <= 1 and (others != 0).mean() <= 1e-3
    assert (np.abs(d[amax]) <= (others != 0).sum(-1)).all()
    # the CDF and the intervals, on lac_tpu's frequencies: exact
    cdf = Q.cdf_from_freq(torch.from_numpy(jfreq))
    jcdf = np.asarray(JQ.cdf_from_freq(jnp.asarray(jfreq)))
    assert np.array_equal(cdf.numpy(), jcdf)
    syms = np.random.default_rng(5).integers(0, v, 64)
    lo, f = Q.gather_intervals(cdf, torch.from_numpy(syms))
    jlo, jf = JQ.gather_intervals(jnp.asarray(jcdf), jnp.asarray(syms))
    assert np.array_equal(lo.numpy(), np.asarray(jlo)) and np.array_equal(f.numpy(), np.asarray(jf))


def test_quantize_refuses_too_few_bits():
    with pytest.raises(ValueError, match="unusable"):
        Q.quantize_logits(torch.zeros(2, 300), 9)


# --------------------------------------------------------------------------
# The cached decode step
# --------------------------------------------------------------------------

_jforward = jax.jit(JT.forward, static_argnums=(0,))
STEPS, BUCKET = 32, 8


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["mha", "gqa", "gpt2"])
def test_decode_step_matches_lac_tpu(name, dtype):
    """32 single-token steps from BOS under the growing-cache schedule
    (bucket 8) in both stacks: each step's logits, and the cache at the
    end; then the steps against the port's own prefill."""
    jcfg, jparams, tcfg, model = carried(name, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tol = 2e-5 if dtype == "f32" else 3e-2
    toks = np.random.default_rng(7).integers(0, 256, (3, STEPS))
    inp = np.concatenate([np.full((3, 1), 256), toks[:, :-1]], axis=1)
    jcache = JT.init_cache(jcfg, 3, BUCKET)
    tcache = T.init_cache(tcfg, 3, BUCKET)
    steps = []
    with torch.no_grad():
        for i, n, w in E._grown_segments(STEPS, BUCKET):
            assert (i, n, w) in jeng._grown_segments(STEPS, BUCKET)
            if tcache["k"].shape[2] < w:
                tcache = E._grow_cache(tcfg, tcache, w)
                jcache = jeng._grow_cache(jcfg, jcache, w)
            for t in range(i, i + n):
                want, jcache = _jforward(jcfg, jparams, jnp.asarray(inp[:, t : t + 1], jnp.int32),
                                         jcache)
                got, tcache = T.forward(tcfg, model, torch.from_numpy(inp[:, t : t + 1]), tcache)
                assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1, 256)
                assert _rel(got.numpy(), want) <= tol, f"step {t}"
                steps.append(got[:, 0])
        pre = T.forward(tcfg, model, torch.from_numpy(inp), prefill=True)
    assert tcache["pos"] == int(jcache["pos"]) == STEPS
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape) == (2, 3, STEPS, jcfg.n_kv_heads,
                                                                   jcfg.head_dim)
    for key in ("k", "v"):
        assert tcache[key].dtype == tcfg.dtype
        assert _rel(tcache[key].float().numpy(), np.asarray(jcache[key].astype(jnp.float32))) <= tol
    assert _rel(torch.stack(steps, 1).numpy(), pre.numpy()) <= tol


def test_forward_step_needs_a_cache_and_refuses_an_overrun():
    cfg = T.tiny_config()
    model = T.init_params(cfg)
    with pytest.raises(ValueError, match="init_cache"):
        T.forward(cfg, model, torch.zeros(1, 1, dtype=torch.long))
    cache = T.init_cache(cfg, 1, 4)
    cache["pos"].fill_(4)  # the cursor is a device tensor, checked on the device
    with pytest.raises(RuntimeError, match="overrun"):
        T.forward(cfg, model, torch.zeros(1, 1, dtype=torch.long), cache)
    with pytest.raises(ValueError, match="overruns"):
        T.forward(cfg, model, torch.zeros(1, 5, dtype=torch.long), T.init_cache(cfg, 1, 4),
                  prefill=True)


# --------------------------------------------------------------------------
# The slice: lm_compress_bytes / lm_decompress_bytes
# --------------------------------------------------------------------------

SLICE = dict(block_tokens=64, lanes=4, cache_grow=16, window_mode="auto")
DATA = smoke_corpus(1 << 17)[-1000:]


@pytest.fixture(scope="module")
def trained():
    """(port cfg, port model, jax cfg, jax params): the tiny f32 config
    trained 60 steps in the port, carried to lac_tpu."""
    torch.manual_seed(0)
    cfg = T.tiny_config(max_seq=256)
    model, _ = train_byte_lm(cfg, smoke_corpus(1 << 16), steps=60, batch=8, seq=64, lr=3e-3,
                             seed=0, device="cpu")
    jcfg = JT.tiny_config(max_seq=256)
    assert port_config(jcfg) == cfg
    jparams = jax.tree.map(jnp.asarray, lm_params_to_jax(model))
    return cfg, model, jcfg, jparams


@pytest.fixture(scope="module")
def containers(trained):
    cfg, model, jcfg, jparams = trained
    port = lm_api.lm_compress_bytes(DATA, model=(cfg, model), device="cpu", **SLICE)
    ref = japi.lm_compress_bytes(DATA, model=(jcfg, jparams), **SLICE)
    return port, ref


def test_lm_container_round_trips(trained, containers):
    cfg, model, _, _ = trained
    port, _ = containers
    header, blocks = read_container(port)
    assert len(blocks) == 16 and all(b.token_count for b in blocks)  # every block coded
    assert lm_api.lm_decompress_bytes(port, model=(cfg, model), device="cpu") == DATA
    # encoding again gives the same container
    assert lm_api.lm_compress_bytes(DATA, model=(cfg, model), device="cpu", **SLICE) == port


def test_lm_header_and_payload_match_lac_tpu(containers):
    port, ref = containers
    (h, blocks), (jh, jblocks) = read_container(port), j_read_container(ref)
    drop = lambda c: {k: v for k, v in c.items() if k != "fingerprint"}  # noqa: E731
    assert drop(h.config) == drop(jh.config)
    assert h.config["fingerprint"] != jh.config["fingerprint"]
    assert (h.codec, h.prob_bits, h.model_id, h.original_len) == (
        jh.codec, jh.prob_bits, jh.model_id, jh.original_len)
    assert [(b.raw_len, b.token_count) for b in blocks] == [
        (b.raw_len, b.token_count) for b in jblocks]
    bits = 8 * sum(len(b.payload) for b in blocks)
    jbits = 8 * sum(len(b.payload) for b in jblocks)
    assert bits < 8 * len(DATA) and abs(bits / jbits - 1) <= 5e-3


def test_each_package_refuses_the_others_container(trained, containers):
    cfg, model, jcfg, jparams = trained
    port, ref = containers
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        lm_api.lm_decompress_bytes(ref, model=(cfg, model), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        japi.lm_decompress_bytes(port, model=(jcfg, jparams))


def test_fingerprint_folds_the_stack_tag(trained):
    cfg, model, _, _ = trained
    assert E.stack_tag(torch.device("cpu")) == "lac_tpu_torch:cpu"
    fp = E.lm_fingerprint(cfg, model, 16)
    assert fp == E.lm_fingerprint(cfg, model, 16)
    assert len({fp, E.lm_fingerprint(cfg, model, 16, cache_grow=16),
                E.lm_fingerprint(cfg, model, 16, slide_seg=512)}) == 3


def test_prng_ref_round_trips_and_fixed_width():
    """A prng: ref resolved again on decode (random weights: raw blocks),
    and the fixed-width schedule (cache_grow 0) on a trained-free model."""
    data = smoke_corpus(700)
    for grow in (16, 0):
        c = lm_api.lm_compress_bytes(data, model_ref="prng:tiny:0", device="cpu",
                                     block_tokens=64, lanes=4, cache_grow=grow)
        assert read_container(c)[0].config["cache_grow"] == grow
        assert lm_api.lm_decompress_bytes(c, device="cpu") == data


def test_engine_fixed_and_grown_schedules_round_trip(trained):
    cfg, model, _, _ = trained
    toks = np.frombuffer(DATA[:4 * 40], np.uint8).reshape(4, 40).astype(np.int64)
    lengths = np.array([40, 0, 1, 23])
    for grow in (0, 16):
        words, nwords = E.lm_encode(cfg, model, toks, lengths, 16, grow)
        out = E.lm_decode(cfg, model, words, lengths, 16, 40, grow)
        live = np.arange(40)[None, :] < lengths[:, None]
        assert np.array_equal(out.numpy(), np.where(live, toks, 0))
        assert int(nwords[1]) == 2 and int(nwords[0]) < 40


def test_unported_modes_and_refs_raise(trained):
    """An hf: ref to a checkpoint that is not there raises, naming it (the
    loader downloads nothing; tests/test_torch_hf.py loads real ones), and
    a mesh wider than the
    process group refuses, naming torchrun (tests/test_torch_dist.py and
    test_torch_mesh.py hold the meshes that run); kv8, w8 (A7,
    held to lac_tpu's in tests/test_torch_q8.py) and det8 (A8,
    tests/test_torch_det8.py) code and round-trip, det8 past the context in
    slide mode too."""
    cfg, model, _, _ = trained
    for flag in ("kv8", "w8", "det8"):
        c = lm_api.lm_compress_bytes(DATA[:200], model=(cfg, model), device="cpu",
                                     block_tokens=64, lanes=4, **{flag: True})
        assert read_container(c)[0].config[flag]
        assert lm_api.lm_decompress_bytes(c, model=(cfg, model), device="cpu") == DATA[:200]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        lm_api.lm_compress_bytes(DATA, model=(cfg, model), device="cpu",
                                 mesh=MeshConfig(data=2).make(device="cpu"))
    # a block past the context codes (tests/test_torch_window.py), det8's too
    det8 = dataclasses.replace(cfg, det8=True)
    toks = np.frombuffer(DATA[:300], dtype=np.uint8).astype(np.int64)[None]
    words, _ = E.lm_encode_windowed(det8, model, toks, np.full(1, 300), 16, mode="slide")
    out = E.lm_decode_windowed(det8, model, words, np.full(1, 300), 16, 300, mode="slide")
    assert np.array_equal(out.numpy(), toks)
    with pytest.raises(FileNotFoundError, match="some/model"):
        treg.resolve_lm("hf:some/model", device="cpu")
    with pytest.raises(ValueError, match="cache_grow"):
        E.lm_encode(cfg, model, np.zeros((1, 4), np.int64), np.ones(1), 16, -1)


def test_entry_points_default_to_the_card(trained):
    """device=None means cuda: without a card the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, model, _, _ = trained
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_api.lm_compress_bytes(DATA, model=(cfg, model))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.resolve_lm("prng:tiny:0")


def test_lm_decompress_prefix_recovers_intact_blocks(trained, containers):
    cfg, model, _, _ = trained
    port, _ = containers
    header, blocks = read_container(port)
    cut = port[: len(port) - sum(len(b.payload) for b in blocks[10:]) - 3]  # into block 9
    out, rep = lm_api.lm_decompress_prefix(cut, model=(cfg, model), device="cpu")
    assert rep["recovered_blocks"] == 9 and not rep["ok"] and rep["bad_blocks"][0] == 9
    assert out == DATA[: 9 * 64]
    out, rep = lm_api.lm_decompress_prefix(port, model=(cfg, model), device="cpu")
    assert rep["ok"] and out == DATA


def test_lm_coding_config_matches_lac_tpu():
    from lac_tpu.config import LMCodingConfig as JCfg

    from lac_tpu_torch.config import LMCodingConfig

    assert dataclasses.asdict(LMCodingConfig()) == dataclasses.asdict(JCfg())
    assert LMCodingConfig(window=300).engine_kwargs() == JCfg(window=300).engine_kwargs()

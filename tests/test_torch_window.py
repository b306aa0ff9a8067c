"""The port's windowed LM coding, blocks longer than the model context (the
slide and reprime schedules), against lac_tpu's on the CPU:
``window_schedule``, the slide forward (the ring cache, RoPE at global
positions, the ring-age mask), the prefill that fills a cache
(``_reprime_cdf``), engine round trips, the container against lac_tpu's,
and the held-out slice (the goldens: ``tests/test_torch_window_golden.py``).

Tolerances:
- ``window_schedule``: equal, errors included (integer geometry).
- the slide steps: logits within 2e-5 (f32) / 3e-2 (bf16) of max |logit|,
  step by step over 3 x max_seq + 5 positions, so the ring wraps twice,
  and the ring cache at the end within the same tolerances of max |K| and
  |V|. These are the prefill tests' tolerances
  (tests/test_torch_transformer.py): in f32 the two stacks compute the
  same function in another summation order; bf16 rounds at other places.
- RoPE at global positions 65,530-65,535: 1e-3 of max |x|. An f32 angle
  near 65,535 rad carries an ulp of 2^-8 rad, so a last-bit difference in
  a frequency (``exp``) or in the large-argument ``cos``/``sin`` moves the
  result by up to about 4e-3 of |x|; both stacks sit 6.4e-3 from the
  float64 rotation at head dim 64, and 9e-5 of max |x| from each other.
- the re-prime CDF: each frequency within 1 count of lac_tpu's (the
  logits agree to 2e-5, and a floor can move by one; ``tests/
  test_torch_lm.py``'s quantize test states the same bound).
- engine round trips: exact.
- the container: the payload bits within 0.5 % of lac_tpu's, as in
  ``tests/test_torch_lm.py``; the headers equal in every key but the
  fingerprint.

The tiny configs mirror ``tests/test_window.py``: ``max_seq`` 16, vocab 41.
Parameters come from one JAX init carried across by
``convert.lm_params_from_jax``; inputs from numpy seeds.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.models import transformer as JT
from lac_tpu.runtime import lm_api as japi
from lac_tpu.runtime import lm_engine as jeng
from lac_tpu.stream.container import read_container as j_read_container
from lac_tpu_torch import smoke
from lac_tpu_torch.convert import lm_params_from_jax, lm_params_to_jax
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.runtime import lm_engine as E
from lac_tpu_torch.stream.container import read_container
from lac_tpu_torch.train import train_byte_lm
from test_torch_transformer import _rel, port_config

MAX_SEQ, VOCAB = 16, 41
T_LEN = 3 * MAX_SEQ + 5  # the ring wraps twice
_jforward = jax.jit(JT.forward, static_argnums=(0,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as tests/test_torch_lm.py: tiny models, many
    small ops, and other test workers on the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(dtype=jnp.float32, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port model) of a tiny config from one
    JAX init, with random norms so that every parameter matters."""
    jcfg = JT.tiny_config(vocab=VOCAB, max_seq=MAX_SEQ, dtype=dtype, **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype) if x.ndim < 3 else x,
        jparams)
    tcfg = port_config(jcfg)
    return jcfg, jparams, tcfg, lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))


def _inputs(b, t_len, seed=7):
    """Tokens [b, t_len] and the step inputs: BOS, then the tokens."""
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, t_len))
    return toks, np.concatenate([np.full((b, 1), VOCAB), toks[:, :-1]], axis=1)


# --------------------------------------------------------------------------
# The schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window,overlap", [(16, 1), (16, 2), (16, 3), (16, 8), (16, 16),
                                            (16, 17), (17, 2), (768, 2), (1024, 8)])
def test_window_schedule_matches_lac_tpu(window, overlap):
    for t_len in (0, 1, window - 1, window, window + 1, 3 * window + 5, 65536):
        try:
            want = jeng.window_schedule(t_len, window, overlap)
        except ValueError as e:
            with pytest.raises(ValueError, match="bad window/overlap"):
                E.window_schedule(t_len, window, overlap)
            assert "bad window/overlap" in str(e)
            continue
        got = E.window_schedule(t_len, window, overlap)
        assert got == want
        assert sum(steps for _, steps, _ in got[0]) == t_len


# --------------------------------------------------------------------------
# The slide forward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_slide_steps_match_lac_tpu(layers, dtype):
    """T_LEN single-token steps on one max_seq ring in both stacks: each
    step's logits, the cursor, and the ring at the end."""
    jcfg, jparams, tcfg, model = _tiny(jnp.float32 if dtype == "f32" else jnp.bfloat16,
                                       n_layers=layers)
    tol = 2e-5 if dtype == "f32" else 3e-2
    jscfg, tscfg = jeng._slide_cfg(jcfg, T_LEN), E._slide_cfg(tcfg, T_LEN)
    assert tscfg.slide and port_config(jscfg) == tscfg
    _, inp = _inputs(3, T_LEN)
    jcache, tcache = JT.init_cache(jscfg, 3), T.init_cache(tscfg, 3)
    with torch.no_grad():
        for t in range(T_LEN):
            want, jcache = _jforward(jscfg, jparams, jnp.asarray(inp[:, t : t + 1], jnp.int32),
                                     jcache)
            got, tcache = T.forward(tscfg, model, torch.from_numpy(inp[:, t : t + 1]), tcache)
            assert _rel(got.numpy(), want) <= tol, f"step {t}"
    assert int(tcache["pos"]) == int(jcache["pos"]) == T_LEN
    assert tuple(tcache["k"].shape) == (layers, 3, MAX_SEQ, jcfg.n_kv_heads, jcfg.head_dim)
    for key in ("k", "v"):
        assert _rel(tcache[key].float().numpy(), np.asarray(jcache[key].astype(jnp.float32))) <= tol


@pytest.mark.parametrize("start", [MAX_SEQ + 4, 2 * MAX_SEQ])
def test_slide_chunk_matches_lac_tpu_and_serial_steps(start):
    """A chunk of 4 tokens past the first window, through the ring-age mask:
    its logits and the ring against lac_tpu's forward of the same chunk, and
    against 4 serial steps of the port (what the mask is for)."""
    jcfg, jparams, tcfg, model = _tiny()
    jscfg, tscfg = jeng._slide_cfg(jcfg), E._slide_cfg(tcfg)
    _, inp = _inputs(2, start + 4, seed=start)
    jcache, tcache = JT.init_cache(jscfg, 2), T.init_cache(tscfg, 2)
    with torch.no_grad():
        for t in range(start):
            _, jcache = _jforward(jscfg, jparams, jnp.asarray(inp[:, t : t + 1], jnp.int32),
                                  jcache)
            _, tcache = T.forward(tscfg, model, torch.from_numpy(inp[:, t : t + 1]), tcache)
        serial = {k: v.clone() for k, v in tcache.items()}
        chunk = inp[:, start:]
        want, jcache = _jforward(jscfg, jparams, jnp.asarray(chunk, jnp.int32), jcache)
        got, tcache = T.forward(tscfg, model, torch.from_numpy(chunk), tcache)
        steps = [T.forward(tscfg, model, torch.from_numpy(chunk[:, i : i + 1]), serial)[0]
                 for i in range(4)]
    assert _rel(got.numpy(), want) <= 2e-5
    assert _rel(got.numpy(), torch.cat(steps, 1).numpy()) <= 2e-5
    assert int(tcache["pos"]) == int(serial["pos"]) == start + 4
    for key in ("k", "v"):
        assert _rel(tcache[key].numpy(), np.asarray(jcache[key])) <= 2e-5
        assert _rel(tcache[key].numpy(), serial[key].numpy()) <= 2e-5


@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope_at_global_positions_matches_lac_tpu(head_dim):
    jcfg = JT.tiny_config(vocab=VOCAB, max_seq=MAX_SEQ, d_model=4 * head_dim)
    x = np.random.default_rng(head_dim).standard_normal((2, 6, 4, head_dim)).astype(np.float32)
    pos = np.arange(65530, 65536, dtype=np.int32)
    want = JT._rope(jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = T._rope(port_config(jcfg), torch.from_numpy(x), torch.from_numpy(pos))
    assert _rel(got.numpy(), want) <= 1e-3


def test_slide_write_may_not_wrap_partway():
    """A chunk whose write would cross the ring's end is refused."""
    _, _, tcfg, model = _tiny()
    scfg = E._slide_cfg(tcfg)
    cache = T.init_cache(scfg, 1)
    cache["pos"].fill_(MAX_SEQ + 14)  # slot 14: two tokens fit, three do not
    with torch.no_grad():
        T.forward(scfg, model, torch.zeros(1, 2, dtype=torch.long), cache)
        cache["pos"].fill_(MAX_SEQ + 14)
        with pytest.raises(RuntimeError, match="overrun"):
            T.forward(scfg, model, torch.zeros(1, 3, dtype=torch.long), cache)


# --------------------------------------------------------------------------
# The re-prime prefill
# --------------------------------------------------------------------------


def test_reprime_fills_the_cache_as_lac_tpu():
    """``_reprime_cdf``: the prefill of the kept tokens writes K/V at
    0..keep-1 and pos keep, as lac_tpu's; the next token's CDF agrees; and
    the steps after it agree with lac_tpu's on its fresh cache although the
    port's cache holds older K/V past keep (masked)."""
    jcfg, jparams, tcfg, model = _tiny()
    keep, pb = 8, 14
    toks, _ = _inputs(3, keep + 4, seed=11)
    jcdf, jcache = jeng._reprime_cdf(jcfg, jparams, jnp.asarray(toks[:, :keep], jnp.int32), pb)
    cache = T.init_cache(tcfg, 3)
    cache["k"].fill_(3.0)  # stale slots: masked, so they change nothing
    cache["v"].fill_(-5.0)
    cache["pos"].fill_(MAX_SEQ)
    with torch.no_grad():
        cdf, cache = E._reprime_cdf(tcfg, model, torch.from_numpy(toks[:, :keep]), pb, cache)
    assert int(cache["pos"]) == int(jcache["pos"]) == keep
    for key in ("k", "v"):
        assert _rel(cache[key][:, :, :keep].numpy(), np.asarray(jcache[key])[:, :, :keep]) <= 2e-5
    assert cdf.dtype == torch.int32 and tuple(cdf.shape) == (3, VOCAB + 1)
    assert np.abs(np.diff(cdf.numpy(), axis=-1) - np.diff(np.asarray(jcdf), axis=-1)).max() <= 1
    with torch.no_grad():
        for t in range(keep, keep + 4):
            want, jcache = _jforward(jcfg, jparams, jnp.asarray(toks[:, t : t + 1], jnp.int32),
                                     jcache)
            got, cache = T.forward(tcfg, model, torch.from_numpy(toks[:, t : t + 1]), cache)
            assert _rel(got.numpy(), want) <= 2e-5, f"step {t}"


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cache_grow", [0, 8])
@pytest.mark.parametrize("t_len", [MAX_SEQ + 1, T_LEN])
@pytest.mark.parametrize("mode", ["slide", "reprime"])
def test_windowed_round_trip(mode, t_len, cache_grow):
    """Ragged lanes (full, 0, 1, 5 short), the first window grown (reprime
    with cache_grow 8: max_seq % 8 == 0) or not; the words decode back."""
    _, _, tcfg, model = _tiny()
    toks, _ = _inputs(4, t_len, seed=t_len)
    lengths = np.array([t_len, 0, 1, t_len - 5])
    toks[np.arange(t_len)[None, :] >= lengths[:, None]] = 0
    kw = dict(overlap=2, cache_grow=cache_grow, mode=mode)
    words, nwords = E.lm_encode_windowed(tcfg, model, toks, lengths, 14, **kw)
    assert tuple(words.shape) == (4, t_len + 2) and int(nwords[1]) == 2
    out = E.lm_decode_windowed(tcfg, model, words, lengths, 14, t_len, **kw)
    assert np.array_equal(out.numpy(), toks)
    # the same call again gives the same words
    again, _ = E.lm_encode_windowed(tcfg, model, toks, lengths, 14, **kw)
    assert torch.equal(again, words)


def test_windowed_schedules_differ_and_det8_slide_raises():
    """Named for what it checked before det8 was ported. Past the context,
    reprime and slide are different schedules (their words differ); det8's
    slide paths (A8, tests/test_torch_det8.py) round-trip, its encode
    chunked at the ring's boundaries."""
    _, _, tcfg, model = _tiny()
    toks, _ = _inputs(2, T_LEN, seed=3)
    lengths = np.full(2, T_LEN)
    slide, _ = E.lm_encode_windowed(tcfg, model, toks, lengths, 14, mode="slide")
    reprime, _ = E.lm_encode_windowed(tcfg, model, toks, lengths, 14, mode="reprime")
    assert not torch.equal(slide, reprime)
    with pytest.raises(ValueError, match="window mode"):
        E.lm_encode_windowed(tcfg, model, toks, lengths, 14, mode="ring")
    det8 = dataclasses.replace(tcfg, det8=True)
    words, _ = E.lm_encode_windowed(det8, model, toks, lengths, 14, mode="slide")
    out = E.lm_decode_windowed(det8, model, words, lengths, 14, T_LEN, mode="slide")
    assert np.array_equal(out.numpy(), toks)


# --------------------------------------------------------------------------
# The container against lac_tpu's
# --------------------------------------------------------------------------

WINDOW_SLICE = dict(block_tokens=250, lanes=8, overlap=2, cache_grow=16)
DATA = smoke.smoke_corpus(1 << 17)[-2000:]


@pytest.fixture(scope="module")
def trained():
    """(port cfg, port model, jax cfg, jax params): the tiny f32 config with
    a 64-token context, trained 60 steps on 63-token windows in the port,
    carried to lac_tpu."""
    torch.manual_seed(0)
    cfg = T.tiny_config(max_seq=64)
    model, _ = train_byte_lm(cfg, smoke.smoke_corpus(1 << 16), steps=60, batch=8, seq=63,
                             lr=3e-3, seed=0, device="cpu")
    jcfg = JT.tiny_config(max_seq=64)
    assert port_config(jcfg) == cfg
    return cfg, model, jcfg, jax.tree.map(jnp.asarray, lm_params_to_jax(model))


@pytest.fixture(scope="module", params=["slide", "reprime"])
def containers(request, trained):
    """(mode, the port's container, lac_tpu's) of DATA: 8 blocks of 250
    tokens in one wave, past the 64-token context."""
    cfg, model, jcfg, jparams = trained
    kw = dict(WINDOW_SLICE, window_mode=request.param)
    return (request.param, lm_api.lm_compress_bytes(DATA, model=(cfg, model), device="cpu", **kw),
            japi.lm_compress_bytes(DATA, model=(jcfg, jparams), **kw))


def test_windowed_container_round_trips_and_matches_lac_tpu(trained, containers):
    cfg, model, _, _ = trained
    mode, port, ref = containers
    (h, blocks), (jh, jblocks) = read_container(port), j_read_container(ref)
    assert h.config["window_mode"] == mode
    assert h.config["slide_seg"] == (512 if mode == "slide" else 0)
    assert len(blocks) == 8 and all(b.token_count for b in blocks)  # every block coded
    assert lm_api.lm_decompress_bytes(port, model=(cfg, model), device="cpu") == DATA
    drop = lambda c: {k: v for k, v in c.items() if k != "fingerprint"}  # noqa: E731
    assert drop(h.config) == drop(jh.config)
    assert [(b.raw_len, b.token_count) for b in blocks] == [
        (b.raw_len, b.token_count) for b in jblocks]
    bits = 8 * sum(len(b.payload) for b in blocks)
    jbits = 8 * sum(len(b.payload) for b in jblocks)
    assert bits < 8 * len(DATA) and abs(bits / jbits - 1) <= 5e-3


@pytest.mark.parametrize("block", [65, 3 * 64 + 5])
@pytest.mark.parametrize("slide_seg", [0, 5, 16])
def test_slide_seg_is_recorded_and_round_trips(trained, slide_seg, block):
    """``slide_seg`` bounds lac_tpu's compiled scans; the port's ring steps
    are the same replays whatever its value, which the container records
    and the fingerprint folds: each round-trips, and no two values share a
    fingerprint."""
    cfg, model, _, _ = trained
    data = DATA[: 2 * block - 7]  # two ragged blocks in one wave
    fps = set()
    for seg in {0, slide_seg}:
        c = lm_api.lm_compress_bytes(data, model=(cfg, model), device="cpu", block_tokens=block,
                                     lanes=2, window_mode="slide", slide_seg=seg)
        h, blocks = read_container(c)
        assert h.config["slide_seg"] == seg and all(b.token_count for b in blocks)
        assert lm_api.lm_decompress_bytes(c, model=(cfg, model), device="cpu") == data
        fps.add(h.config["fingerprint"])
    assert len(fps) == len({0, slide_seg})


def test_each_package_refuses_the_others_windowed_container(trained, containers):
    cfg, model, jcfg, jparams = trained
    _, port, ref = containers
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        lm_api.lm_decompress_bytes(ref, model=(cfg, model), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        japi.lm_decompress_bytes(port, model=(jcfg, jparams))


# --------------------------------------------------------------------------
# The held-out slice and the goldens
# --------------------------------------------------------------------------


def test_heldout_slice_is_the_committed_bytes():
    data = smoke.heldout_slice()
    assert len(data) == smoke.HELDOUT_BYTES == 262144
    assert zlib.crc32(data) == smoke.HELDOUT_CRC == 0x65DB6543

"""The port's int8 LM modes (kv8: the int8 KV cache; w8: int8 weights)
against lac_tpu's on the CPU: the quantizer, the quantized weights, the
int8 products, the dequant chains, the cached steps and the prefill, the
growing cache, the engine's schedules, the containers and the staged init
(``models/transformer.py``, ``ops/int8.py``, ``convert.py``,
``runtime/lm_engine.py``, ``runtime/lm_api.py``). Modelled on
``tests/test_kv8.py`` and ``tests/test_w8.py``.

Tolerances:
- bit for bit, where the two stacks get the same inputs: ``_q8`` (codes
  and scales, all-zero rows and exact .5 ties included), ``ensure_w8``
  (every code and scale), ``_w8_dot`` (K up to 5632, where the int32 sum
  passes 2^24 and its cast to f32 rounds), the kv8 dequant chains on the
  same int8 inputs and scales, the w8 params tree through ``convert``,
  ``_grow_cache``, and ``init_params_w8`` against ``ensure_w8(init_params)``.
- the int8 helpers: equal to the int64 product, worst case (every value
  +-127) and W past 1040 included.
- a whole cached step or prefill, where float products come first: logits
  within 3e-2 (f32) / 8e-2 (bf16) of max |logit|, wider than the float
  path's 2e-5 / 3e-2 (``tests/test_torch_lm.py``) for this reason: each
  int8 code is the rounding of a value that the two stacks compute within
  their float tolerance, and a value near a .5 boundary rounds to
  neighbouring codes in the two stacks; one such code moves its product by
  one quantization step (1/127 of its row's max) and every later layer and
  step carries it. Over 4 seeds and 32 steps of the three configs the
  largest was 2.0e-2 (f32) and 6.4e-2 (bf16). Where no code can differ
  because the float path agrees to about 1e-7 (gpt2-style f32, no RoPE or
  GLU), the float bound 2e-5 holds. The kv8 cache at the end: with kv8
  alone in f32 each code within +-1 of lac_tpu's and each scale within
  1e-5 relative (the K/V rows agree to the float tolerance, so only a row
  at a rounding boundary moves one code); otherwise each dequantized row
  (code x scale / 127) within the logits' bound of max |K| (|V|) plus one
  code of its own row, since w8's codes move the K/V rows themselves.
- engine round trips: exact.
- containers: the port's round-trip; headers equal lac_tpu's in every key
  but the fingerprint; payloads within 0.5 % of lac_tpu's, as the float
  path's (``tests/test_torch_lm.py``).

Parameters come from one JAX init carried across by
``convert.lm_params_from_jax``; inputs from numpy seeds.
"""

import dataclasses
import os
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
from lac_tpu.train import load_checkpoint as j_load_checkpoint
from lac_tpu_torch import smoke
from lac_tpu_torch.convert import lm_params_from_jax, lm_params_to_jax
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.ops import int8 as I
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.runtime import lm_engine as E
from lac_tpu_torch.stream.container import read_container
from lac_tpu_torch.train import load_checkpoint, train_byte_lm
from test_torch_transformer import CONFIGS, _rel, carried, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"kv8": dict(kv8=True), "w8": dict(w8=True), "kv8w8": dict(kv8=True, w8=True)}
TOL = {"f32": 3e-2, "bf16": 8e-2}  # module docstring
_jforward = jax.jit(JT.forward, static_argnums=(0,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as tests/test_torch_lm.py: tiny models, many
    small ops, and other test workers on the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    """An array's bits: bf16 (ml_dtypes or the port's uint16) as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _trees_equal(got, want) -> None:
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert np.array_equal(g, w), jax.tree_util.keystr(path)


def _modes(jcfg, tcfg, mode):
    return (dataclasses.replace(jcfg, **MODES[mode]), dataclasses.replace(tcfg, **MODES[mode]))


# --------------------------------------------------------------------------
# The quantizer and the quantized weights: bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, -1])
def test_q8_matches_lac_tpu(axis):
    x = np.random.default_rng(3).standard_normal((37, 53)).astype(np.float32)
    x *= np.exp(np.random.default_rng(4).uniform(-8, 8, (37, 1))).astype(np.float32)
    x[5] = 0.0  # an all-zero row (and column 5's max then comes from the rest)
    x[:, 7] = 0.0
    q, s = T._q8(torch.from_numpy(x), axis)
    jq, js = JT._q8(jnp.asarray(x), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))


def test_q8_ties_round_half_to_even_and_zero_rows():
    """Rows whose max is 127, so x / s * 127 lands on exact .5 values for
    many x = j + 0.5: both stacks round those half to even; an all-zero row
    has scale 1e-30 (as f32) and codes 0."""
    half = np.arange(127, dtype=np.float32) + np.float32(0.5)
    x = np.stack([np.concatenate([[127.0], half]).astype(np.float32),
                  np.concatenate([[-127.0], -half]).astype(np.float32),
                  np.zeros(128, np.float32)])
    scaled = (x[:2] / np.float32(127.0)).astype(np.float32) * np.float32(127.0)
    ties = (scaled - np.floor(scaled)) == 0.5
    assert ties.sum() >= 20  # many exact ties, with even and odd floors
    q, s = T._q8(torch.from_numpy(x), -1)
    jq, js = JT._q8(jnp.asarray(x), -1)
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(q.numpy()[:2][ties], np.round(scaled[ties]).astype(np.int8))
    assert (q.numpy()[2] == 0).all() and s.numpy()[2, 0] == np.float32(1e-30)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ensure_w8_matches_lac_tpu(name, dtype):
    """Every code and scale of the quantized projections and head (the
    gpt2 config's head is tied to the embedding; it has biases), and the
    float leaves passed through."""
    jcfg, jparams, tcfg, model = carried(name, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    jcfg, tcfg = _modes(jcfg, tcfg, "w8")
    want = jax.tree.map(np.asarray, JT.ensure_w8(jcfg, jparams))
    q = T.ensure_w8(tcfg, model)
    _trees_equal(lm_params_to_jax(q), want)
    assert isinstance(q.head, T.W8) and tuple(q.head.q.shape) == (tcfg.d_model, tcfg.vocab)


def test_ensure_w8_of_the_byte6l_checkpoint_matches_lac_tpu():
    path = os.path.join(REPO, smoke.LM_CHECKPOINT)
    jcfg, jparams = j_load_checkpoint(path)
    tcfg, model = load_checkpoint(path, device="cpu")
    want = jax.tree.map(np.asarray, JT.ensure_w8(dataclasses.replace(jcfg, w8=True), jparams))
    _trees_equal(lm_params_to_jax(T.ensure_w8(dataclasses.replace(tcfg, w8=True), model)), want)


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(64, 61), (2048, 256), (5632, 40)])
def test_w8_dot_matches_lac_tpu(k, n, xdtype):
    """x [5, 3, K] against an int8 weight the reference quantized: the f32
    result equal bit for bit. At K 5632 the int32 sums pass 2^24."""
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = (rng.standard_normal((5, 3, k)) * 3).astype(np.float32)
    if k == 5632:  # large codes of one sign: sums past 2^24
        w, x = rng.uniform(0.9, 1.0, w.shape).astype(np.float32), x * 0 + np.float32(3)
    jq, js = JT._q8(jnp.asarray(w), 0)
    js = js * jnp.float32(1.0 / (127.0 * 127.0))
    jdt, tdt = (jnp.float32, torch.float32) if xdtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    want = np.asarray(JT._w8_dot(jnp.asarray(x).astype(jdt), jq, js))
    got = T._w8_dot(torch.from_numpy(x).to(tdt),
                    T.W8(torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    if k == 5632:
        xq, _ = JT._q8(jnp.asarray(x).astype(jdt).astype(jnp.float32), -1)
        acc = np.asarray(xq).astype(np.int64) @ np.asarray(jq).astype(np.int64)
        assert acc.max() > 2**24


# --------------------------------------------------------------------------
# The int8 products: the int64 product, exactly
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
def test_int8_mm_equals_the_int64_product(m):
    """Through its padding: M 1-64, N 61 and 256, K 64 and 5632, b row- and
    column-major, seeded values and the worst case (every value +-127)."""
    rng = np.random.default_rng(m)
    for n in (61, 256):
        for k in (64, 5632):
            for worst in (False, True):
                a = (np.full((m, k), 127) if worst else rng.integers(-127, 128, (m, k)))
                b = (np.full((k, n), -127) if worst else rng.integers(-127, 128, (k, n)))
                want = a.astype(np.int64) @ b.astype(np.int64)
                ta = torch.from_numpy(a.astype(np.int8))
                tb = torch.from_numpy(b.astype(np.int8))
                for bt in (tb, tb.t().contiguous().t()):
                    got = I.int8_mm(ta, bt)
                    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
                    assert np.array_equal(got.numpy().astype(np.int64), want), (n, k, worst)


@pytest.mark.parametrize("w", [1024, 1040, 2048])
def test_int8_bmm_equals_the_int64_product(w):
    """The chunked product over a contraction of W terms, batched over
    (lanes, heads), at and past the f32 limit of 1040 terms, seeded and
    worst case."""
    rng = np.random.default_rng(w)
    for worst in (False, True):
        a = np.full((2, 3, 5, w), 127) if worst else rng.integers(-127, 128, (2, 3, 5, w))
        b = np.full((2, 3, w, 16), 127) if worst else rng.integers(-127, 128, (2, 3, w, 16))
        want = np.einsum("...mk,...kn->...mn", a.astype(np.int64), b.astype(np.int64))
        got = I.int8_bmm(torch.from_numpy(a.astype(np.int8)),
                         torch.from_numpy(b.astype(np.int8)).transpose(-1, -2).contiguous()
                         .transpose(-1, -2))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if worst:
        assert int(got.max()) == w * 127 * 127


def test_int8_helpers_refuse_other_types_and_reduced_precision(monkeypatch):
    i8 = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        I.int8_mm(i8.float(), i8.t())
    with pytest.raises(ValueError, match="inner sizes"):
        I.int8_mm(i8, i8)
    with pytest.raises(ValueError, match="int8"):
        I.int8_bmm(i8, i8.t().float())
    monkeypatch.setattr(torch.backends.mkldnn.matmul, "fp32_precision", "bf16")
    with pytest.raises(RuntimeError, match="TF32"):
        I.int8_bmm(i8, i8.t())


def _kv8_inputs(seed=0, b=2, s=3, kvh=2, r=2, d=16, w=40):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((b, s, kvh, r, d)).astype(np.float32)
    c8 = {key: rng.integers(-127, 128, (b, w, kvh, d)).astype(np.int8) for key in ("k", "v")}
    for key in ("ks", "vs"):
        c8[key] = rng.uniform(0.05, 3.0, (b, w, kvh, 1)).astype(np.float32)
    probs = rng.dirichlet(np.ones(w), (b, kvh, r, s)).astype(np.float32)
    return qg, c8, probs


def test_kv8_dequant_chains_match_lac_tpu():
    """The kv8 cache route's scores and PV product on the same int8 cache,
    scales, queries and probabilities: bit for bit against the reference's
    expressions (lac_tpu/models/transformer.py:884-899, :924-936, with their
    barriers), in its [b, s, k, r, d] layout."""
    qg, c8, probs = _kv8_inputs()
    b, s, kvh, r, d = qg.shape
    scale = jnp.float32(1.0) / jnp.sqrt(jnp.float32(d))
    barrier = jax.lax.optimization_barrier
    # :884-899
    q8, sq = JT._q8(jnp.asarray(qg), -1)
    sci = jnp.einsum("bskrd,bwkd->bkrsw", q8, c8["k"], preferred_element_type=jnp.int32)
    sq_t = jnp.transpose(sq, (0, 2, 3, 1, 4))
    sk_t = jnp.transpose(c8["ks"][..., 0], (0, 2, 1))[:, :, None, None, :]
    skc = barrier(sk_t * (scale / jnp.float32(127.0 * 127.0)))
    want_sc = np.asarray(barrier(sci.astype(jnp.float32) * sq_t) * skc)
    # :924-936
    sv_t = jnp.transpose(c8["vs"][..., 0], (0, 2, 1))[:, :, None, None, :]
    p8, sp = JT._q8(jnp.asarray(probs) * sv_t, -1)
    oci = jnp.einsum("bkrsw,bwkd->bskrd", p8, c8["v"], preferred_element_type=jnp.int32)
    spc = barrier(jnp.transpose(sp, (0, 3, 1, 2, 4)) * jnp.float32(1.0 / (127.0 * 127.0)))
    want_pv = np.asarray(oci.astype(jnp.float32) * spc)

    tc8 = {key: torch.from_numpy(a) for key, a in c8.items()}
    qf = torch.from_numpy(qg).permute(0, 2, 3, 1, 4).reshape(b, kvh, r * s, d)
    got_sc = T._kv8_scores(qf, tc8, T._scale_f32(d)).reshape(b, kvh, r, s, -1)
    assert np.array_equal(got_sc.numpy(), want_sc)
    tp = torch.from_numpy(probs).reshape(b, kvh, r * s, -1)
    got_pv = T._kv8_pv(tp, tc8).reshape(b, kvh, r, s, d).permute(0, 3, 1, 2, 4)
    assert np.array_equal(got_pv.numpy(), want_pv)


def test_w8_params_tree_round_trips_through_convert():
    """lac_tpu's w8 tree into a quantized port model and back, equal; the
    tree and the config must agree on w8."""
    jcfg, jparams, tcfg, _ = carried("gpt2", jnp.bfloat16)
    jcfg, tcfg = _modes(jcfg, tcfg, "w8")
    tree = jax.tree.map(np.asarray, JT.ensure_w8(jcfg, jparams))
    model = lm_params_from_jax(tcfg, tree)
    assert T.is_w8(model) and model.layers[0].wq.q.stride() == (1, tcfg.d_model)
    _trees_equal(lm_params_to_jax(model), tree)
    with pytest.raises(ValueError, match="w8"):
        lm_params_from_jax(dataclasses.replace(tcfg, w8=False), tree)


# --------------------------------------------------------------------------
# The cached step and the prefill, within tolerance
# --------------------------------------------------------------------------

STEPS, BUCKET = 16, 8


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_steps_match_lac_tpu(name, mode, dtype):
    """16 single-token steps from BOS under the growing-cache schedule
    (bucket 8, so ``_grow_cache`` runs once) in both stacks: each
    step's logits, then the cache at the end (module docstring)."""
    jcfg, jparams, tcfg, model = carried(name, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    jcfg, tcfg = _modes(jcfg, tcfg, mode)
    jparams, model = JT.ensure_w8(jcfg, jparams), T.ensure_w8(tcfg, model)
    tight = name == "gpt2" and dtype == "f32" and tcfg.w8
    tol = 2e-5 if tight else TOL[dtype]
    toks = np.random.default_rng(7).integers(0, 256, (3, STEPS))
    inp = np.concatenate([np.full((3, 1), 256), toks[:, :-1]], axis=1)
    jcache = JT.init_cache(jcfg, 3, BUCKET)
    tcache = T.init_cache(tcfg, 3, BUCKET)
    with torch.no_grad():
        for i, n, w in E._grown_segments(STEPS, BUCKET):
            if tcache["k"].shape[2] < w:
                tcache = E._grow_cache(tcfg, tcache, w)
                jcache = jeng._grow_cache(jcfg, jcache, w)
            for t in range(i, i + n):
                want, jcache = _jforward(jcfg, jparams, jnp.asarray(inp[:, t : t + 1], jnp.int32),
                                         jcache)
                got, tcache = T.forward(tcfg, model, torch.from_numpy(inp[:, t : t + 1]), tcache)
                assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1, 256)
                assert _rel(got.numpy(), want) <= tol, f"step {t}"
    assert sorted(tcache) == sorted(jcache) and int(tcache["pos"]) == STEPS
    if tcfg.kv8:
        _check_kv8_cache(tcache, jcache, tcfg, dtype)


def _check_kv8_cache(tcache, jcache, tcfg, dtype) -> None:
    for key, sk in (("k", "ks"), ("v", "vs")):
        q, s = tcache[key].numpy(), tcache[sk].numpy()
        jq, js = np.asarray(jcache[key]), np.asarray(jcache[sk])
        assert q.dtype == np.int8 and s.dtype == np.float32 and q.shape == jq.shape
        if dtype == "f32" and not tcfg.w8:
            assert np.abs(q.astype(int) - jq).max() <= 1
            assert np.abs(s - js).max() <= 1e-5 * np.abs(js).max()
        else:
            deq, jdeq = q * s / 127.0, jq * js / 127.0
            bound = TOL[dtype] * np.abs(jdeq).max() + s / 127.0
            assert (np.abs(deq - jdeq) <= bound).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_prefill_fills_the_cache_as_lac_tpu(mode, dtype):
    """The prefill that fills a cache (the re-prime's): its logits, and
    under kv8 the quantized rows at 0..S-1 and the cursor, against lac_tpu's
    prefill into a fresh cache; the port's cache holds stale rows past S,
    which the steps mask."""
    jcfg, jparams, tcfg, model = carried("gqa", jnp.float32 if dtype == "f32" else jnp.bfloat16)
    jcfg, tcfg = _modes(jcfg, tcfg, mode)
    jparams, model = JT.ensure_w8(jcfg, jparams), T.ensure_w8(tcfg, model)
    toks = np.random.default_rng(2).integers(0, 257, (2, 24))
    want, jcache = JT.forward(jcfg, jparams, jnp.asarray(toks, jnp.int32),
                              JT.init_cache(jcfg, 2, 40), prefill=True)
    cache = T.init_cache(tcfg, 2, 40)
    cache["k"].fill_(3)
    with torch.no_grad():
        got, cache = T.forward(tcfg, model, torch.from_numpy(toks), cache, prefill=True)
    assert _rel(got.numpy(), want) <= TOL[dtype] and int(cache["pos"]) == 24
    if tcfg.kv8:
        _check_kv8_cache({k: v[:, :, :24] for k, v in cache.items() if k != "pos"},
                         {k: v[:, :, :24] for k, v in jcache.items() if k != "pos"}, tcfg, dtype)


def test_grow_cache_under_kv8_matches_lac_tpu():
    """Every buffer, the int8 rows and their scales, copied to the front of
    the wider cache, the rest zeros, and the cursor kept: equal."""
    jcfg, _, tcfg, _ = carried("gqa", jnp.float32)
    jcfg, tcfg = _modes(jcfg, tcfg, "kv8")
    rng = np.random.default_rng(5)
    jcache = JT.init_cache(jcfg, 3, 8)
    jcache = {k: (v if k == "pos" else jnp.asarray(
        rng.integers(-127, 128, v.shape) if v.dtype == jnp.int8 else rng.uniform(0, 2, v.shape),
        v.dtype)) for k, v in jcache.items()}
    jcache["pos"] = jnp.int32(8)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    tcache["pos"] = torch.tensor(8)
    got = E._grow_cache(tcfg, tcache, 24)
    want = jeng._grow_cache(jcfg, jcache, 24)
    assert sorted(got) == sorted(want) == ["k", "ks", "pos", "v", "vs"]
    assert int(got["pos"]) == int(want["pos"]) == 8
    for key in ("k", "ks", "v", "vs"):
        assert got[key].shape[2] == 24 and np.array_equal(got[key].numpy(), np.asarray(want[key]))


# --------------------------------------------------------------------------
# The engine: every mode under every schedule
# --------------------------------------------------------------------------

MAX_SEQ, VOCAB = 16, 41


def _tiny_model(mode):
    jcfg = JT.tiny_config(vocab=VOCAB, max_seq=MAX_SEQ)
    cfg = dataclasses.replace(port_config(jcfg), **MODES[mode])
    return cfg, lm_params_from_jax(port_config(jcfg), jax.tree.map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(2))))


@pytest.mark.parametrize("schedule", ["fixed", "grown", "reprime", "slide"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_round_trips(mode, schedule):
    """Ragged lanes (full, 0, 1, short) within the context at a fixed and a
    grown width, and past it in both windowed modes (the ring wraps twice;
    reprime prefills with growth in the first window): the words decode
    back, and a second encode gives the same words. The float model is
    quantized on entry."""
    cfg, model = _tiny_model(mode)
    t_len = MAX_SEQ - 3 if schedule in ("fixed", "grown") else 3 * MAX_SEQ + 5
    toks = np.random.default_rng(t_len).integers(0, VOCAB, (4, t_len))
    lengths = np.array([t_len, 0, 1, t_len - 5])
    toks[np.arange(t_len)[None, :] >= lengths[:, None]] = 0
    kw = dict(overlap=2, cache_grow=0 if schedule == "fixed" else 8,
              mode="slide" if schedule == "slide" else "reprime")
    words, nwords = E.lm_encode_windowed(cfg, model, toks, lengths, 14, **kw)
    assert int(nwords[1]) == 2
    out = E.lm_decode_windowed(cfg, model, words, lengths, 14, t_len, **kw)
    assert np.array_equal(out.numpy(), toks)
    again, _ = E.lm_encode_windowed(cfg, model, toks, lengths, 14, **kw)
    assert torch.equal(again, words)


# --------------------------------------------------------------------------
# Containers
# --------------------------------------------------------------------------

SLICE = dict(block_tokens=64, lanes=4, cache_grow=16, window_mode="auto")
DATA = smoke.smoke_corpus(1 << 17)[-1000:]


@pytest.fixture(scope="module")
def trained():
    """(port cfg, port model, jax cfg, jax params): the tiny f32 config
    trained 60 steps in the port (tests/test_torch_lm.py's), carried to
    lac_tpu; float, as a checkpoint is."""
    torch.manual_seed(0)
    cfg = T.tiny_config(max_seq=256)
    model, _ = train_byte_lm(cfg, smoke.smoke_corpus(1 << 16), steps=60, batch=8, seq=64,
                             lr=3e-3, seed=0, device="cpu")
    jcfg = JT.tiny_config(max_seq=256)
    return cfg, model, jcfg, jax.tree.map(jnp.asarray, lm_params_to_jax(model))


@pytest.fixture(scope="module", params=sorted(MODES))
def containers(request, trained):
    """(mode, the port's container, lac_tpu's) of DATA under the mode."""
    cfg, model, jcfg, jparams = trained
    kw = dict(SLICE, **MODES[request.param])
    return (request.param, lm_api.lm_compress_bytes(DATA, model=(cfg, model), device="cpu", **kw),
            japi.lm_compress_bytes(DATA, model=(jcfg, jparams), **kw))


def test_int8_container_round_trips_and_matches_lac_tpu(trained, containers):
    cfg, model, _, _ = trained
    mode, port, ref = containers
    (h, blocks), (jh, jblocks) = read_container(port), j_read_container(ref)
    assert (h.config["kv8"], h.config["w8"]) == ("kv8" in mode, "w8" in mode)
    assert len(blocks) == 16 and all(b.token_count for b in blocks)  # every block coded
    assert lm_api.lm_decompress_bytes(port, model=(cfg, model), device="cpu") == DATA
    drop = lambda c: {k: v for k, v in c.items() if k != "fingerprint"}  # noqa: E731
    assert drop(h.config) == drop(jh.config)
    assert [(b.raw_len, b.token_count) for b in blocks] == [
        (b.raw_len, b.token_count) for b in jblocks]
    bits = 8 * sum(len(b.payload) for b in blocks)
    jbits = 8 * sum(len(b.payload) for b in jblocks)
    assert bits < 8 * len(DATA) and abs(bits / jbits - 1) <= 5e-3
    # the int8 container is refused by the float decode of the same model
    float_fp = E.lm_fingerprint(cfg, model, 16, SLICE["cache_grow"])
    assert float_fp != h.config["fingerprint"]


def test_each_package_refuses_the_others_int8_container(trained, containers):
    cfg, model, jcfg, jparams = trained
    _, port, ref = containers
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        lm_api.lm_decompress_bytes(ref, model=(cfg, model), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        japi.lm_decompress_bytes(port, model=(jcfg, jparams))


def test_decode_handshake_refuses_mismatched_modes(trained, containers):
    """A model resolved with a mode the container lacks is refused, naming
    the mode; det8 with kv8 or w8 is a ValueError; det8 alone codes
    (tests/test_torch_det8.py) and its container is refused by this
    model's int8 modes."""
    cfg, model, _, _ = trained
    mode, port, _ = containers
    for other in ("kv8", "w8"):
        if other not in MODES[mode]:
            with pytest.raises(ValueError, match=f"WITHOUT {other}"):
                lm_api.lm_decompress_bytes(
                    port, model=(dataclasses.replace(cfg, **{other: True}), model), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm_api.lm_compress_bytes(DATA, model=(cfg, model), device="cpu", det8=True,
                                 **MODES[mode])
    det8 = lm_api.lm_compress_bytes(DATA[:200], model=(cfg, model), device="cpu", det8=True,
                                    block_tokens=64, lanes=4)
    assert read_container(det8)[0].config["det8"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm_api.lm_decompress_bytes(
            det8, model=(dataclasses.replace(cfg, **MODES[mode]), model), device="cpu")


def test_fingerprint_folds_the_mode_tags_in_lac_tpus_order(trained):
    """The probe's crc, then cache_grow, slide_seg, w8v2, kv8v2 and the
    stack tag, in that order; the probe runs on the quantized model."""
    cfg, model, _, _ = trained
    qcfg = dataclasses.replace(cfg, kv8=True, w8=True)
    cache = T.init_cache(qcfg, 1)
    with torch.no_grad():
        cdf, _ = E._step_cdf(qcfg, T.ensure_w8(qcfg, model), cache,
                             torch.full((1,), qcfg.bos_id), 16)
    crc = zlib.crc32(cdf.numpy().astype("<i4").tobytes())
    for part in (b"cache_grow=16", b"slide_seg=512", b"w8v2", b"kv8v2", b"lac_tpu_torch:cpu"):
        crc = zlib.crc32(part, crc)
    assert E.lm_fingerprint(qcfg, model, 16, cache_grow=16, slide_seg=512) == crc
    fps = {E.lm_fingerprint(dataclasses.replace(cfg, **kw), model, 16)
           for kw in ({}, *MODES.values())}
    assert len(fps) == 4


# --------------------------------------------------------------------------
# The staged init, ensure_w8's contract
# --------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "tiny-gpt2"])
def test_init_params_w8_equals_ensure_w8_of_init_params(preset):
    """The same structure, shapes, types and bits (the gpt2-style preset:
    tied head, biases, learned positions)."""
    from lac_tpu_torch.models.lm_registry import PRESETS

    cfg = dataclasses.replace(PRESETS[preset](), w8=True, dtype=torch.bfloat16)
    staged = T.init_params_w8(cfg, seed=3)
    unstaged = T.ensure_w8(cfg, T.init_params(cfg, seed=3))
    _trees_equal(lm_params_to_jax(staged), lm_params_to_jax(unstaged))
    names = [n for n, _ in staged.named_buffers()]
    assert names == [n for n, _ in unstaged.named_buffers()]
    assert all(b.dtype in (torch.int8, torch.float32) for b in staged.buffers())
    with pytest.raises(ValueError, match="requires cfg.w8"):
        T.init_params_w8(dataclasses.replace(cfg, w8=False))


def test_ensure_w8_is_idempotent_and_leaves_the_float_model():
    """A quantized model comes back as it is; a float cfg passes the float
    model through; the caller's float model is unchanged and still runs the
    float forward; the tied head is the quantized embed[:vocab].T; a mode
    and a model that disagree are refused."""
    jcfg, _, tcfg, model = carried("gpt2", jnp.bfloat16)
    before = {n: p.clone() for n, p in model.named_parameters()}
    cfg = dataclasses.replace(tcfg, w8=True)
    q = T.ensure_w8(cfg, model)
    assert T.ensure_w8(cfg, q) is q and T.ensure_w8(tcfg, model) is model
    assert all(torch.equal(before[n], p) for n, p in model.named_parameters())
    assert q.embed is model.embed and model.head is None
    want = T.W8.quantize(model.embed[: cfg.vocab].T)
    assert torch.equal(q.head.q, want.q) and torch.equal(q.head.s, want.s)
    toks = torch.zeros(1, 3, dtype=torch.long)
    with torch.no_grad():
        T.forward(tcfg, model, toks, prefill=True)
        T.forward(cfg, q, toks, prefill=True)
        with pytest.raises(ValueError, match="ensure_w8"):
            T.forward(cfg, model, toks, prefill=True)
        with pytest.raises(ValueError, match="ensure_w8"):
            T.forward(tcfg, q, toks, prefill=True)

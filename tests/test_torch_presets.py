"""The presets of lac_tpu/models/lm_registry.py in the port, and the two the
port had not run before, on narrow stand-ins against lac_tpu on the CPU:

- llama2-7b: Llama-style, MHA (n_kv_heads == n_heads) at head dim 128,
  d_ff 11008. Stand-in: 2 heads of 128 (d 256), 2 layers, vocab 32000,
  d_ff 1792, which, like 11008, passes one 1,024-term chunk and is not a
  multiple of it.
- byte-12l-mqa: one KV head for six query heads (the GQA broadcast at its
  extreme). Stand-in: its full width (d 384, 6 heads of 64, d_ff 1536), 2
  of its 12 layers.

Tolerances, those of tests/test_torch_lm.py and tests/test_torch_q8.py:
- every preset's LMConfig equals lac_tpu's field for field;
- cached-step logits within 2e-5 (f32) / 3e-2 (bf16) of max |logit|
  against lac_tpu's forward(prefill=False), 16 steps under the growing
  cache (bucket 8), parameters carried from one JAX init;
- the w8 products exact: every W8 projection's int32 product equals the
  int64 product of its int8 operands, and int8_bmm at the stand-in's d_ff;
- det8: the container is the same bytes in two runs and decodes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.models import lm_registry as jreg
from lac_tpu.models import transformer as JT
from lac_tpu.runtime import lm_engine as jeng
from lac_tpu_torch.convert import lm_params_from_jax
from lac_tpu_torch.models import lm_registry as treg
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.ops import int8 as I
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.runtime import lm_engine as E
from lac_tpu_torch.stream.container import read_container

STAND_INS = {
    "llama2-7b": dict(d_model=256, n_heads=2, n_kv_heads=2, n_layers=2, d_ff=1792,
                      max_seq=256),
    "byte-12l-mqa": dict(n_layers=2, max_seq=256),
}
STEPS, BUCKET = 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small steps, and the other workers' cores left
    alone (tests/test_torch_lm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg, dtype=None) -> T.LMConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    if dtype is None:
        dtype = torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32
    return T.LMConfig(dtype=dtype, **kw)


def _stand_in(name, jdtype=jnp.float32, seed=0):
    """(jax cfg, jax params, port cfg, port model): the preset at the
    stand-in's widths and depth, from one JAX init with random norms."""
    jcfg = dataclasses.replace(jreg.PRESETS[name](), dtype=jdtype, **STAND_INS[name])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype) if x.ndim < 3 else x,
        jparams)
    tcfg = _port_cfg(jcfg)
    return jcfg, jparams, tcfg, lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("name", sorted(jreg.PRESETS))
def test_preset_equals_lac_tpu(name):
    want, got = jreg.PRESETS[name](), treg.PRESETS[name]()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert str(g).removeprefix("torch.") == jnp.dtype(w).name, name
        else:
            assert g == w, (name, f.name)


def test_stand_ins_keep_the_head_structure():
    for name in STAND_INS:
        full, small = treg.PRESETS[name](), _stand_in(name)[2]
        assert small.d_model // small.n_heads == full.d_model // full.n_heads, name
        assert (small.n_kv_heads == small.n_heads) == (full.n_kv_heads == full.n_heads), name
        assert (small.n_kv_heads == 1) == (full.n_kv_heads == 1), name
        assert (small.vocab, small.norm, small.act, small.pos_embedding) == \
            (full.vocab, full.norm, full.act, full.pos_embedding), name
    d_ff = STAND_INS["llama2-7b"]["d_ff"]
    assert d_ff > I.CHUNK and d_ff % I.CHUNK and treg.PRESETS["llama2-7b"]().d_ff % I.CHUNK


_jforward = jax.jit(JT.forward, static_argnums=(0,))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_cached_steps_match_lac_tpu(name, dtype):
    jcfg, jparams, tcfg, model = _stand_in(name, jnp.float32 if dtype == "f32" else
                                           jnp.bfloat16)
    tol = 2e-5 if dtype == "f32" else 3e-2
    rng = np.random.default_rng(7)
    inp = rng.integers(0, tcfg.vocab, (3, STEPS))
    jcache, tcache = JT.init_cache(jcfg, 3, BUCKET), T.init_cache(tcfg, 3, BUCKET)
    with torch.no_grad():
        for i, n, w in E._grown_segments(STEPS, BUCKET):
            if tcache["k"].shape[2] < w:
                tcache = E._grow_cache(tcfg, tcache, w)
                jcache = jeng._grow_cache(jcfg, jcache, w)
            for t in range(i, i + n):
                want, jcache = _jforward(jcfg, jparams,
                                         jnp.asarray(inp[:, t : t + 1], jnp.int32), jcache)
                got, tcache = T.forward(tcfg, model, torch.from_numpy(inp[:, t : t + 1]), tcache)
                assert tuple(got.shape) == (3, 1, tcfg.vocab)
                assert _rel(got.numpy(), want) <= tol, f"{name} step {t}"
    # the KV heads of the cache are the preset's structure
    assert tcache["k"].shape[3] == tcfg.n_kv_heads
    assert _rel(tcache["k"].float().numpy(), np.asarray(jcache["k"], np.float32)) <= tol


@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_w8_products_are_exact(name):
    """Every W8 projection of the stand-in and its head: int8_mm of seeded
    int8 activations against the weight's codes equals their int64
    product; int8_bmm over the stand-in's d_ff (past one chunk) too."""
    _, _, tcfg, model = _stand_in(name)
    qcfg = dataclasses.replace(tcfg, w8=True)
    qmodel = T.ensure_w8(qcfg, model)
    rng = np.random.default_rng(1)
    weights = [m for m in qmodel.modules() if isinstance(m, T.W8)]
    assert len(weights) == 7 * tcfg.n_layers + 1  # wq wk wv wo w_up w_gate w_down, the head
    for w in weights:
        k = w.q.shape[0]
        x = rng.integers(-127, 128, (5, k)).astype(np.int8)
        want = x.astype(np.int64) @ w.q.numpy().astype(np.int64)
        got = I.int8_mm(torch.from_numpy(x), w.q)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy().astype(np.int64), want)
    k = tcfg.d_ff
    a = np.full((2, 1, 3, k), 127, np.int8)
    b = rng.integers(-127, 128, (2, 1, k, 8)).astype(np.int8)
    want = np.einsum("...mk,...kn->...mn", a.astype(np.int64), b.astype(np.int64))
    with E._coding(torch.device("cpu")):
        got = I.int8_bmm(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_det8_container_is_stable_and_decodes(name):
    _, _, tcfg, model = _stand_in(name)
    kw = dict(block_tokens=24, lanes=2, det8=True, device="cpu", model=(tcfg, model))
    if tcfg.vocab == 256:
        data = bytes(np.random.default_rng(2).integers(0, 256, 40, dtype=np.uint8))
        first = lm_api.lm_compress_bytes(data, f"prng:{name}:0", **kw)
        assert lm_api.lm_compress_bytes(data, f"prng:{name}:0", **kw) == first
        assert lm_api.lm_decompress_bytes(first, model=(tcfg, model), device="cpu") == data
    else:
        ids = np.random.default_rng(2).integers(0, tcfg.vocab, 40).astype(np.int32)
        first = lm_api.lm_compress_tokens(ids, f"prng:{name}:0", **kw)
        assert lm_api.lm_compress_tokens(ids, f"prng:{name}:0", **kw) == first
        back = lm_api.lm_decompress_tokens(first, model=(tcfg, model), device="cpu")
        assert np.array_equal(back, ids)
    header, blocks = read_container(first)
    assert header.config["det8"] is True and len(blocks) == 2

"""The port's token alphabet (lac_tpu_torch.runtime.lm_api: lm_compress_tokens,
lm_decompress_tokens and the text front-end) on the CPU, and against lac_tpu's.

Ports tests/test_lm_api.py:72-150 (wide-vocab round trips with raw blocks,
the cross-API and id-range refusals, the text front-end and its
losslessness guard) and holds the port to lac_tpu:
- float token containers: headers equal in every key but the fingerprint,
  payload bytes within 0.5 % of lac_tpu's (float logits differ across
  stacks), each package refusing the other's container;
- det8 token containers: every block equal to lac_tpu's with its det_rsqrt
  patched to the documented 1 / sqrt (ROADMAP C4), as in
  tests/test_torch_det8.py;
- at vocab 256, a token container's blocks equal the byte container's of
  the same bytes, float and det8.
Weights come from one JAX init carried across by convert.lm_params_from_jax,
or from a tiny model trained in the port; ids from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.models import transformer as JT
from lac_tpu.runtime import lm_api as japi
from lac_tpu.stream.container import read_container as j_read_container
from lac_tpu_torch import cli, smoke
from lac_tpu_torch.convert import lm_params_from_jax
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.stream.container import read_container
from lac_tpu_torch.train import train_byte_lm
from test_torch_transformer import port_config

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models, many small ops: one intra-op thread runs them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(vocab: int, n_layers: int = 2, seed: int = 1):
    cfg = T.tiny_config(vocab=vocab, max_seq=64, n_layers=n_layers)
    return cfg, T.init_params(cfg, seed)


def _ids(vocab: int, n: int, seed: int = 2) -> np.ndarray:
    """Skewed ids with a uniform tail, vocab - 1 among them."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, 7, n - n // 5), rng.integers(0, vocab, n // 5)])
    ids[3] = vocab - 1
    return ids.astype(np.int32)


@pytest.mark.parametrize("vocab,n,block,raw,pb", [(300, 482, 80, ">u2", 16),
                                                   (65600, 130, 64, ">u4", 18)])
def test_tokens_round_trip_wide_vocab_with_raw_blocks(vocab, n, block, raw, pb):
    """Above 256 ids the raw fallback packs big-endian >u2, above 65,536
    >u4, where prob_bits rises to 18; the short last block is stored raw."""
    model = _model(vocab)
    ids = _ids(vocab, n)
    c = lm_api.lm_compress_tokens(ids, "prng:x:0", block_tokens=block, lanes=4, model=model,
                                  device=CPU)
    back = lm_api.lm_decompress_tokens(c, model=model, device=CPU)
    assert back.dtype == np.int32 and np.array_equal(back, ids)
    header, blocks = read_container(c)
    assert header.config["alphabet"] == "tokens" and header.config["vocab"] == vocab
    assert header.original_len == n and header.prob_bits == pb
    last = blocks[-1]
    assert last.token_count == 0 and last.raw_len == n % block
    assert last.payload == ids[-(n % block):].astype(raw).tobytes()
    assert all(b.token_count == b.raw_len for b in blocks[:-1])  # the rest coded


def test_alphabet_cross_api_refusal_and_id_range():
    model = _model(300)
    ids = np.arange(50, dtype=np.int32) % 7
    c = lm_api.lm_compress_tokens(ids, "prng:x:0", block_tokens=64, lanes=2, model=model,
                                  device=CPU)
    with pytest.raises(ValueError, match="token-alphabet stream; use lm_decompress_tokens"):
        lm_api.lm_decompress_bytes(c, model=model, device=CPU)
    with pytest.raises(ValueError, match="token-alphabet stream; use lm_decompress_tokens"):
        lm_api.lm_decompress_prefix(c, model=model, device=CPU)
    byte_model = _model(256)
    cb = lm_api.lm_compress_bytes(b"abc" * 30, "prng:tiny:0", block_tokens=64, lanes=2,
                                  model=byte_model, device=CPU)
    with pytest.raises(ValueError, match="byte-alphabet stream; use lm_decompress_bytes"):
        lm_api.lm_decompress_tokens(cb, model=byte_model, device=CPU)
    with pytest.raises(ValueError, match="token ids"):
        lm_api.lm_compress_tokens(np.array([0, 300], np.int32), "prng:x:0", model=model,
                                  device=CPU)
    with pytest.raises(ValueError, match="token ids"):
        lm_api.lm_compress_tokens(np.array([-1, 3], np.int32), "prng:x:0", model=model,
                                  device=CPU)
    with pytest.raises(ValueError, match="1-D"):
        lm_api.lm_compress_tokens(np.zeros((2, 3), np.int32), "prng:x:0", model=model,
                                  device=CPU)
    with pytest.raises(ValueError, match="model vocab 256 != container vocab 300"):
        lm_api.lm_decompress_tokens(c, model=byte_model, device=CPU)


class _CharTok:
    def __init__(self, alphabet):
        self.alphabet = list(alphabet)
        self.index = {ch: i for i, ch in enumerate(self.alphabet)}

    def encode(self, s):
        return [self.index[ch] for ch in s]

    def decode(self, ids):
        return "".join(self.alphabet[i] for i in ids)


class _LossyTok(_CharTok):
    def decode(self, ids):  # a normalising tokenizer: drops case
        return super().decode(ids).lower()


def test_text_frontend_and_losslessness_guard():
    alpha = "abcdefgh XYZ"
    tok = _CharTok(alpha)
    model = _model(len(alpha))
    text = "".join(ch for ch in "abc abca Xbg haZ " * 30 if ch in tok.index)
    c = lm_api.lm_compress_text(text, tok, model_ref="prng:x:0", block_tokens=64, lanes=4,
                                model=model, device=CPU)
    assert lm_api.lm_decompress_text(c, tok, model=model, device=CPU) == text
    with pytest.raises(ValueError, match="not lossless"):
        lm_api.lm_compress_text("XYZ", _LossyTok(alpha), model_ref="prng:x:0", model=model,
                                device=CPU)


# --------------------------------------------------------------------------
# Against lac_tpu: float and det8 token containers
# --------------------------------------------------------------------------

VOCAB = 300
KW = dict(block_tokens=80, lanes=4, cache_grow=16)


def _two_op_rsqrt(x):
    return jnp.float32(1.0) / jax.lax.optimization_barrier(jnp.sqrt(x.astype(jnp.float32)))


@pytest.fixture(scope="module")
def carried():
    """(port cfg, port model, jax cfg, jax params): one layer at vocab 300
    (one layer halves lac_tpu's compile), from one JAX init."""
    jcfg = JT.tiny_config(vocab=VOCAB, max_seq=64, n_layers=1)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(3))
    cfg = port_config(jcfg)
    return cfg, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams)), jcfg, jparams


@pytest.fixture(scope="module")
def containers(carried):
    """{mode: (the port's container, lac_tpu's)} of 330 ids (the last block
    of 10 coded), float and det8 (lac_tpu's det_rsqrt patched)."""
    cfg, model, jcfg, jparams = carried
    ids = _ids(VOCAB, 330, seed=4)
    out = {"float": (lm_api.lm_compress_tokens(ids, "prng:x:0", model=(cfg, model), device=CPU,
                                               **KW),
                     japi.lm_compress_tokens(ids, "prng:x:0", model=(jcfg, jparams), **KW))}
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "det_rsqrt", _two_op_rsqrt)
        dcfg, djcfg = (dataclasses.replace(c, det8=True) for c in (cfg, jcfg))
        out["det8"] = (lm_api.lm_compress_tokens(ids, "prng:x:0", model=(dcfg, model),
                                                 device=CPU, **KW),
                       japi.lm_compress_tokens(ids, "prng:x:0", model=(djcfg, jparams), **KW))
    jax.clear_caches()
    return ids, out


def _drop_fp(c: dict) -> dict:
    return {k: v for k, v in c.items() if k != "fingerprint"}


def test_float_token_container_within_half_a_percent_of_lac_tpus(carried, containers):
    cfg, model, jcfg, jparams = carried
    ids, out = containers
    port, ref = out["float"]
    (h, blocks), (jh, jblocks) = read_container(port), j_read_container(ref)
    assert _drop_fp(h.config) == _drop_fp(jh.config) and h.prob_bits == jh.prob_bits
    assert [(b.raw_len, b.token_count) for b in blocks] == [
        (b.raw_len, b.token_count) for b in jblocks]
    ours, theirs = (sum(len(b.payload) for b in x) for x in (blocks, jblocks))
    assert abs(ours - theirs) <= 0.005 * theirs, (ours, theirs)
    assert np.array_equal(lm_api.lm_decompress_tokens(port, model=(cfg, model), device=CPU),
                          ids)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        lm_api.lm_decompress_tokens(ref, model=(cfg, model), device=CPU)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        japi.lm_decompress_tokens(port, model=(jcfg, jparams))


def test_det8_token_payloads_equal_patched_lac_tpus(carried, containers):
    cfg, model, _, _ = carried
    ids, out = containers
    port, ref = out["det8"]
    (h, blocks), (jh, jblocks) = read_container(port), j_read_container(ref)
    assert h.config["det8"] is True and _drop_fp(h.config) == _drop_fp(jh.config)
    assert all(b.token_count for b in blocks)
    assert [(b.raw_len, b.token_count, b.payload) for b in blocks] == [
        (b.raw_len, b.token_count, b.payload) for b in jblocks]
    dcfg = dataclasses.replace(cfg, det8=True)
    assert np.array_equal(lm_api.lm_decompress_tokens(port, model=(dcfg, model), device=CPU),
                          ids)


@pytest.fixture(scope="module")
def trained():
    """The tiny byte config, one layer, trained 60 steps in the port."""
    torch.manual_seed(0)
    cfg = T.tiny_config(max_seq=64, n_layers=1)
    model, _ = train_byte_lm(cfg, smoke.smoke_corpus(1 << 16), steps=60, batch=8, seq=63,
                             lr=3e-3, seed=0, device=CPU)
    return cfg, model


@pytest.mark.parametrize("det8", [False, True])
def test_token_blocks_equal_byte_blocks_at_vocab_256(trained, det8):
    """The bytes as ids (vocab 256, raw >u1): every block of the token
    container equals the byte container's; only the header differs."""
    data = smoke.smoke_corpus(1 << 17)[-1000:]
    kw = dict(block_tokens=150, lanes=4, cache_grow=16, det8=det8, model=trained, device=CPU)
    tc = lm_api.lm_compress_tokens(np.frombuffer(data, np.uint8), "prng:x:0", **kw)
    bc = lm_api.lm_compress_bytes(data, "prng:x:0", **kw)
    (th, tblocks), (bh, bblocks) = read_container(tc), read_container(bc)
    assert sum(b.token_count > 0 for b in bblocks) >= len(bblocks) - 1  # the model codes
    assert [(b.raw_len, b.token_count, b.payload) for b in tblocks] == [
        (b.raw_len, b.token_count, b.payload) for b in bblocks]
    assert th.config == {**bh.config, "alphabet": "tokens", "vocab": 256}
    back = lm_api.lm_decompress_tokens(tc, model=trained, device=CPU)
    assert back.tobytes() == np.frombuffer(data, np.uint8).astype(np.int32).tobytes()


def test_cli_recover_refuses_a_token_container_as_lac_tpu_does(tmp_path):
    model = _model(300)
    c = lm_api.lm_compress_tokens(_ids(300, 100), "prng:tiny:0", block_tokens=64, lanes=2,
                                  model=model, device=CPU)
    path = tmp_path / "tokens.lac"
    path.write_bytes(c[:-5])
    with pytest.raises(ValueError) as ours:
        cli.main(["recover", str(path), "--device", "cpu"])
    jcfg = JT.tiny_config(vocab=300, max_seq=64)
    with pytest.raises(ValueError) as theirs:
        japi.lm_decompress_prefix(c[:-5], model=(jcfg, None))
    assert str(ours.value) == str(theirs.value) == (
        "container holds a token-alphabet stream; use lm_decompress_tokens")

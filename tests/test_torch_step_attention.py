"""The cached step's attention wrapper (``ops/step_attention.py``) on the
CPU: its plain version against the model's float route at S = 1
(``_attend_float`` as ``_attention_cached`` calls it) bit for bit, its
argument checks, and the fingerprint's tag. The kernel itself runs in
``tests/test_torch_gpu.py``."""

import dataclasses
import zlib

import pytest
import torch

from lac_tpu_torch import metrics
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.models.lm_registry import resolve_lm
from lac_tpu_torch.ops import step_attention as SA
from lac_tpu_torch.runtime import lm_engine as E
from lac_tpu_torch.runtime.step_graph import _step_cdf

W = 24


def _inputs(b, h, kvh, hd, dtype, seed=0, roped=True):
    """q, k, v [B, 1, H|KVH, Dh] (under ``roped`` views of one tensor, as
    the RoPE step hands them over) and a cache slice [B, W, KVH, Dh]."""
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return (torch.randn(*shape, generator=g) * 2.0).to(dtype)

    if roped:
        q, k = draw(b, 1, h + kvh, hd).split([h, kvh], dim=2)
    else:
        q, k = draw(b, 1, h, hd), draw(b, 1, kvh, hd)
    return q, k, draw(b, 1, kvh, hd), draw(b, W, kvh, hd), draw(b, W, kvh, hd)


def _route(q, k, v, ck, cv, pos, scale):
    """The model's float route at S = 1, as ``_attention_cached`` runs it."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    cfg = T.tiny_config(dtype=q.dtype)
    qf = T._heads_f32(q.reshape(b, s, kvh, rep, hd)).transpose(2, 3)
    qf = qf.reshape(b, kvh, rep * s, hd)
    drop = ~(torch.arange(ck.shape[1]) < pos)
    out = T._attend_float(cfg, qf, T._heads_f32(k), T._heads_f32(v), ck, cv, drop, None, scale)
    return out.reshape(b, kvh, rep, s, hd).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


# (H, KVH, Dh): MHA, tiny_config's GQA, TinyLlama's 32/4 at a small head,
# byte-12l-mqa's 6/1
HEADS = [(8, 8, 16), (4, 2, 16), (32, 4, 8), (6, 1, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 1, W // 2, W - 1, W, W + 5])
@pytest.mark.parametrize("h,kvh,hd", HEADS)
def test_plain_version_equals_the_float_route(h, kvh, hd, pos, dtype):
    """pos 0 (only the fresh row), 1, mid, W - 1, W, and past W as a slide
    ring has it (every slot live): the same bits, and the inputs pass the
    wrapper's checks."""
    q, k, v, ck, cv = _inputs(3, h, kvh, hd, dtype, seed=h + pos, roped=pos % 2 == 0)
    p = torch.tensor(pos)
    scale = T._scale_f32(hd)
    got = SA.step_attention_plain(q, k, v, ck, cv, p, scale)
    assert got.dtype == dtype and got.shape == (3, 1, h, hd)
    assert torch.equal(got, _route(q, k, v, ck, cv, p, scale))
    assert SA._check(q, k, v, ck, cv, p)[0] == (3, kvh, h // kvh, W, hd)


def _bad(case):
    """Inputs that break one rule of the wrapper, and the error it raises."""
    q, k, v, ck, cv = _inputs(2, 4, 2, 16, torch.bfloat16)
    pos = torch.tensor(3)
    if case == "half":
        q, k, v, ck, cv = (t.half() for t in (q, k, v, ck, cv))
        return (q, k, v, ck, cv, pos), TypeError, "share one of"
    if case == "mixed":
        return (q.float(), k, v, ck, cv, pos), TypeError, "share one of"
    if case == "pos_dtype":
        return (q, k, v, ck, cv, pos.int()), TypeError, "0-d int64"
    if case == "cache_layout":
        return (q, k, v, ck.transpose(1, 2).contiguous().transpose(1, 2), cv, pos), ValueError, \
            "contiguous"
    if case == "row_stride":
        qt = torch.zeros(2, 1, 16, 4, dtype=torch.bfloat16).transpose(2, 3)
        return (qt, k, v, ck, cv, pos), ValueError, "contiguous rows"
    if case == "head_dim":
        return (q[..., :8], k, v, ck, cv, pos), ValueError, "q must be"
    if case == "heads":
        q, k, v, ck, cv = _inputs(2, 5, 2, 16, torch.bfloat16)
        return (q, k, v, ck, cv, pos), ValueError, "q must be"
    if case == "lanes":
        return (q, k[:1], v, ck, cv, pos), ValueError, "k, v must hold"
    if case == "cpu":
        return (q, k, v, ck, cv, pos), ValueError, "CUDA tensors"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["half", "mixed", "pos_dtype", "cache_layout", "row_stride",
                                  "head_dim", "heads", "lanes", "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, err, match = _bad(case)
    with pytest.raises(err, match=match):
        SA.step_attention(*args, 0.25)


@pytest.mark.parametrize("r,w,hd,dtype,offset", [
    (1, 1024, 64, torch.bfloat16, 0),  # byte-16l's fingerprint probe
    (8, 2048, 64, torch.bfloat16, 0),  # TinyLlama-1.1B
    (6, 1024, 64, torch.bfloat16, 0),  # byte-12l-mqa
    (4, 8192, 128, torch.bfloat16, 0),  # Llama-3-8B
    (2, 256, 16, torch.float32, 0),  # tiny
    (4, 131072, 128, torch.bfloat16, 0),  # a 128k context's probe: scores in global memory
    (1, 2048, 100, torch.bfloat16, 0),  # a head dim of 100 (OpenLLaMA-3B): rows unaligned
    (16, 1024, 64, torch.bfloat16, 0),  # 16 query heads a KV head: two groups a block
    (2, 64, 16, torch.bfloat16, 1),  # q off its 16-byte alignment
])
def test_wrapper_checks_pass_the_shapes_the_kernel_takes(r, w, hd, dtype, offset):
    """The shapes the kernel takes pass every check the wrapper makes
    before it asks the card: here only the device refuses them."""
    kvh = 2
    flat = torch.zeros(offset + r * kvh * hd, dtype=dtype)
    q = flat[offset:].view(1, 1, r * kvh, hd)
    kv = torch.zeros(1, 1, kvh, hd, dtype=dtype)
    c = torch.empty(1, w, kvh, hd, dtype=dtype)  # never read: no page touched
    assert SA._check(q, kv, kv, c, c, torch.tensor(0))[0] == (1, kvh, r, w, hd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SA.step_attention(q, kv, kv, c, c, torch.tensor(0), 0.25)


@pytest.mark.parametrize("device,det8,kv8,w8,takes", [
    ("cuda", False, False, False, True),
    ("cuda", False, False, True, True),  # w8 keeps a float cache
    ("cuda", False, True, False, False),
    ("cuda", True, False, False, False),
    ("cpu", False, False, False, False),
])
def test_takes_step_routes_the_card_float_cache(device, det8, kv8, w8, takes):
    """The one rule the model's route and the fingerprint's tag share."""
    cfg = T.tiny_config(det8=det8, kv8=kv8, w8=w8)
    assert SA.takes_step(cfg, torch.device(device)) is takes


@pytest.mark.parametrize("ref", ["prng:tiny:0", "det8"])
def test_cpu_fingerprint_is_unchanged(ref):
    """The CPU's fingerprints (float and det8) are the earlier formula's:
    the probe's CDF, cache_grow, the stack tag, and no step-attention tag,
    which only the card's float step folds."""
    cfg, params = resolve_lm("prng:tiny:0", device="cpu")
    if ref == "det8":
        cfg = dataclasses.replace(cfg, det8=True)
    fp = E.lm_fingerprint(cfg, params, 16, cache_grow=16)
    probe = T.ensure_quantized(cfg, params)
    with E._coding(torch.device("cpu")):
        cdf, _ = _step_cdf(cfg, probe, T.init_cache(cfg, 1), torch.tensor([cfg.bos_id]), 16)
    crc = zlib.crc32(b"cache_grow=16", zlib.crc32(cdf.numpy().astype("<i4").tobytes()))
    tag = b"lac_tpu_torch:det8" if cfg.det8 else b"lac_tpu_torch:cpu"
    assert fp == zlib.crc32(tag, crc)


def test_cpu_steps_never_take_the_kernel_route():
    """A CPU coding call runs today's route: no ``attn.step_kernel``."""
    cfg, params = resolve_lm("prng:tiny:0", device="cpu")
    toks = torch.randint(0, 256, (2, 20), generator=torch.Generator().manual_seed(0))
    with metrics.tracing() as tracer:
        E.lm_encode(cfg, params, toks, torch.tensor([20, 13]), 16, 16)
    assert "attn.step_kernel" not in tracer.totals and tracer.totals["step.eager"] > 0

"""lac_tpu_torch.models.transformer against lac_tpu.models.transformer on the
CPU: the prefill logits, and lm_loss with its gradients through each fused
attention impl, from the same parameters (JAX's init carried across by
``convert.lm_params_from_jax``) and the same tokens.

Tolerances:
- f32 logits: 2e-5 of max |logit| (floored at 1). The two stacks compute
  the same f32 function; only summation order differs.
- bf16 logits: 3e-2 of max |logit|. bf16 rounds at 2^-8 relative, and XLA
  on the CPU keeps some fused bf16 intermediates in f32 where torch
  rounds each op, so the two stacks round at different places; through
  two layers that came to 0.7-0.9 % on these inputs.
- the fused paths' loss: 1e-5 relative, and their gradients 2e-4 of each
  leaf's max |grad|, against the reference's exact branch in f32: flash
  and splash differ from it only in summation order; bf16s at f32 differs
  by its normalisation after the PV product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.models import lm_registry as jreg
from lac_tpu.models import transformer as JT
from lac_tpu.train import lm_loss as jax_lm_loss
from lac_tpu_torch.convert import lm_params_from_jax, lm_params_to_jax
from lac_tpu_torch.models import lm_registry as treg
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.train import lm_loss

CONFIGS = {
    "mha": lambda: JT.tiny_config(n_kv_heads=4),
    "gqa": jreg.PRESETS["tiny"],
    "gpt2": jreg.PRESETS["tiny-gpt2"],
}


def port_config(jcfg, dtype=None) -> T.LMConfig:
    """The port's LMConfig with the same fields as a lac_tpu one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    if dtype is None:
        dtype = torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32
    return T.LMConfig(dtype=dtype, **kw)


def carried(name, dtype, seed=0):
    """(jax cfg, jax params, port cfg, port model) from one JAX init."""
    jcfg = dataclasses.replace(CONFIGS[name](), dtype=dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    # random norms and biases, so every parameter matters to the check
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype) if x.ndim < 3 else x,
        jparams)
    tcfg = port_config(jcfg)
    return jcfg, jparams, tcfg, lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))


def tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 257, (b, s)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_logits_match_lac_tpu(name, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jcfg, jparams, tcfg, model = carried(name, jdt)
    toks = tokens(2, 40)
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), JT.init_cache(jcfg, 2, 40),
                         prefill=True)
    with torch.no_grad():
        got = T.forward(tcfg, model, torch.from_numpy(toks), prefill=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, 256)
    assert _rel(got.numpy(), want) <= (2e-5 if dtype == "f32" else 3e-2)


def _grads(model) -> dict:
    """The gradients of ``model`` in lac_tpu's params layout."""
    g = T.Transformer(model.cfg, dtype=torch.float32, device="meta")
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(g.get_submodule(owner), leaf, torch.nn.Parameter(p.grad.clone()))
    return lm_params_to_jax(g)


@pytest.mark.parametrize("impl", ["flash", "splash", "bf16s"])
def test_fused_lm_loss_and_grads_match_exact_lac_tpu(impl, monkeypatch):
    """lm_loss(fused=True) for each impl against lac_tpu's exact branch, and
    a spy on the fused branch shows it ran (an MHA config: the fused gate
    needs n_heads == n_kv_heads)."""
    jcfg, jparams, tcfg, model = carried("mha", jnp.float32)
    toks = tokens(2, 33, seed=4)
    want, jgrads = jax.value_and_grad(lambda p: jax_lm_loss(jcfg, p, jnp.asarray(toks)))(jparams)

    calls = []
    target = "_bf16s_prefill" if impl == "bf16s" else "causal_attention"
    real = getattr(T, target)
    monkeypatch.setattr(T, target, lambda *a: calls.append(1) or real(*a))
    monkeypatch.setitem(T._FUSED, "impl", impl)
    loss = lm_loss(tcfg, model, torch.from_numpy(toks), fused=True)
    loss.backward()
    assert len(calls) == 2 * tcfg.n_layers  # forward, and again under remat
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    got = _grads(model)
    flat_want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat_want:
        g = got
        for key in path:
            g = g[key.key]
        assert _rel(g, w) <= 2e-4, jax.tree_util.keystr(path)


def test_gqa_takes_the_exact_branch(monkeypatch):
    """As in lac_tpu, the fused gate needs h == kvh; a GQA model with
    fused=True runs the exact branch and gives its loss."""
    _, _, tcfg, model = carried("gqa", jnp.float32)
    monkeypatch.setitem(T._FUSED, "impl", "flash")
    monkeypatch.setattr(T, "causal_attention", lambda *a: pytest.fail("fused branch ran"))
    toks = torch.from_numpy(tokens(2, 17))
    with torch.no_grad():
        assert torch.equal(lm_loss(tcfg, model, toks, fused=True), lm_loss(tcfg, model, toks))


def test_unported_modes_raise():
    """The det8 forward raises, naming ROADMAP A8, for the prefill, for the
    cached decode step (which A5 ported: tests/test_torch_lm.py) and for
    its cache. The w8 and kv8 forwards (A7, held to lac_tpu's in
    tests/test_torch_q8.py) run both, w8 on the model ensure_w8 gives. The
    slide forward (A6, held to lac_tpu's in tests/test_torch_window.py)
    runs both."""
    cfg = T.tiny_config()
    model = T.init_params(cfg)
    toks = torch.zeros(1, 4, dtype=torch.long)
    cache = T.init_cache(cfg, 1, 8)
    det8 = dataclasses.replace(cfg, det8=True)
    with pytest.raises(NotImplementedError, match="A8"):
        T.forward(det8, model, toks, prefill=True)
    with pytest.raises(NotImplementedError, match="A8"):
        T.forward(det8, model, toks, cache)
    with pytest.raises(NotImplementedError, match="A8"):
        T.init_cache(det8, 1, 8)
    for flag in ("w8", "kv8"):
        mode = dataclasses.replace(cfg, **{flag: True})
        params = T.ensure_w8(mode, model)
        with torch.no_grad():
            assert tuple(T.forward(mode, params, toks, prefill=True).shape) == (1, 4, cfg.vocab)
            logits, step = T.forward(mode, params, toks, T.init_cache(mode, 1, 8))
        assert tuple(logits.shape) == (1, 4, cfg.vocab) and int(step["pos"]) == 4
        assert step["k"].dtype == (torch.int8 if flag == "kv8" else cfg.dtype)
    slide = dataclasses.replace(cfg, slide=True)
    with torch.no_grad():
        assert tuple(T.forward(slide, model, toks, prefill=True).shape) == (1, 4, cfg.vocab)
        logits, cache = T.forward(slide, model, toks, T.init_cache(slide, 1, 8))
    assert tuple(logits.shape) == (1, 4, cfg.vocab) and int(cache["pos"]) == 4


def test_presets_and_init_match_lac_tpu():
    """The presets carry the same fields; init_params draws the reference's
    shapes, types and scales (its bits are torch's own)."""
    assert sorted(treg.PRESETS) == sorted(jreg.PRESETS)
    for name in jreg.PRESETS:
        assert port_config(jreg.PRESETS[name]()) == treg.PRESETS[name](), name
    for name in ("gqa", "gpt2"):
        jcfg = CONFIGS[name]()
        want = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
        got = lm_params_to_jax(T.init_params(port_config(jcfg), seed=0))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert abs(float(g.std()) - float(w.std())) <= 0.2 * float(w.std()) + 1e-6

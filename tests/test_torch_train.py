"""lac_tpu_torch.train against lac_tpu.train on the CPU: the schedule, three
training steps from one carried init, the checkpoint format in both
directions, the golden loss of the shipped byte-6l checkpoint, and the
CLI's ``train``.

Tolerances:
- the schedule: 1e-7 relative; optax evaluates it in f32, the port in
  Python floats.
- training, f32: losses 1e-5 relative; final parameters 2e-6 absolute.
  Two updates at lr at most 3e-4 move a parameter by about lr each (Adam
  normalises the step), and the stacks' gradients differ in summation
  order only, so the parameters agree to a few f32 ulps of their size.
- checkpoints: bit for bit.
- GOLDEN_LM: lac_tpu recomputes it to 1e-6 relative (its own f32 sum on
  this CPU); the port's exact branch on the CPU lies within 2e-3 nats of
  it (the two stacks round bf16 at different places).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lac_tpu import train as jtrain
from lac_tpu.models import transformer as JT
from lac_tpu_torch import smoke
from lac_tpu_torch import train as ttrain
from lac_tpu_torch.convert import lm_params_from_jax, lm_params_to_jax
from lac_tpu_torch.models import transformer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(jcfg) -> T.LMConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return T.LMConfig(dtype=torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32, **kw)


def as_jax(tree):
    """The port's arrays on the JAX side: uint16 leaves are bf16 bits."""
    return jax.tree.map(lambda a: a.view(jnp.bfloat16) if a.dtype == np.uint16 else a, tree)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("lr,warmup,steps", [(3e-4, 1, 3), (1e-3, 10, 100), (3e-4, 100, 2000)])
def test_schedule_matches_optax(lr, warmup, steps):
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.1)
    got = ttrain._schedule(lr, warmup, steps)
    assert got(0) == 0.0
    for c in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps, steps + 5}):
        assert abs(got(c) - float(want(c))) <= 1e-7 * lr, c


def test_first_update_leaves_params_as_they_are():
    """The schedule is 0 at update count 0, and AdamW's step at lr 0 (its
    decay scaled by lr too) leaves every parameter bit-equal."""
    cfg = T.tiny_config()
    master = ttrain._cast(cfg, T.init_params(cfg, seed=3), torch.float32)
    before = [p.detach().clone() for p in master.parameters()]
    opt = torch.optim.AdamW(master.parameters(), lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.01)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))
    ttrain._step(cfg, master, opt, toks, ttrain._schedule(3e-4, 1, 3)(0), False)
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in master.parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, master.parameters()))


STEPS = dict(steps=3, batch=4, seq=32, lr=3e-4, seed=2, log_every=1)


@pytest.fixture(scope="module")
def jax_three_steps():
    """lac_tpu's train_byte_lm for 3 steps in f32 (exact attention): its
    config, init, final parameters and losses."""
    jcfg = JT.tiny_config(n_kv_heads=4, max_seq=64)
    jinit = JT.init_params(jcfg, jax.random.PRNGKey(5))
    jparams, jlosses = jtrain.train_byte_lm(jcfg, smoke.smoke_corpus(1 << 14), init=jinit,
                                            **STEPS)
    return jcfg, jinit, jparams, jlosses


@pytest.mark.parametrize("impl", [None, "flash"])
def test_three_steps_match_lac_tpu(jax_three_steps, impl, monkeypatch):
    """train_byte_lm for 3 steps in f32 from one carried init: the same
    batches, losses and final parameters, with the exact attention and with
    the fused one (flash's plain versions here: the same function summed
    in another order)."""
    jcfg, jinit, jparams, jlosses = jax_three_steps
    corpus = smoke.smoke_corpus(1 << 14)
    kw = STEPS
    if impl:
        monkeypatch.setitem(T._FUSED, "impl", impl)
    tcfg = port_config(jcfg)
    init = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jinit))
    params, losses = ttrain.train_byte_lm(tcfg, corpus, init=init, device="cpu",
                                          fused_attn=bool(impl), **kw)
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = lm_params_to_jax(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    # step 1 ran on the init's parameters: the first update had lr 0
    rng = np.random.default_rng(kw["seed"])
    arr = np.frombuffer(corpus, np.uint8)
    rng.integers(0, len(arr) - 33, size=4)
    starts = rng.integers(0, len(arr) - 33, size=4)
    toks = torch.from_numpy(np.stack([arr[s : s + 33] for s in starts]).astype(np.int32))
    with torch.no_grad():
        assert ttrain.lm_loss(tcfg, init, toks, fused=bool(impl)).item() == losses[1]


def test_eval_and_save_best(tmp_path):
    """Eval windows and save-best: the saved file holds the last eval's
    parameters (the only eval here) with max_seq capped at seq."""
    cfg = T.tiny_config(n_kv_heads=4, max_seq=64, dtype=torch.bfloat16)
    corpus = smoke.smoke_corpus(1 << 14)
    path = str(tmp_path / "best.npz")
    params, losses = ttrain.train_byte_lm(
        cfg, corpus[: 1 << 13], steps=2, batch=2, seq=16, eval_corpus=corpus[1 << 13:],
        eval_every=2, eval_batches=2, save_best_path=path, device="cpu")
    assert losses == []  # log_every 0: nothing logged
    lcfg, loaded = ttrain.load_checkpoint(path, device="cpu")
    assert lcfg == dataclasses.replace(cfg, max_seq=16)
    for a, b in zip(loaded.parameters(), params.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_checkpoints_cross_both_ways(tmp_path):
    """A port save loads in lac_tpu, and a lac_tpu save in the port, with the
    same config and bits; bf16 and a GPT-2-style tree included."""
    for jcfg in (JT.tiny_config(dtype=jnp.bfloat16),
                 JT.tiny_config(n_kv_heads=4, pos_embedding="learned", norm="layernorm",
                                act="gelu", use_bias=True, tie_embeddings=True)):
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(1))
        tcfg = port_config(jcfg)
        model = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
        p1 = str(tmp_path / "port.npz")
        ttrain.save_checkpoint(p1, tcfg, model)
        c1, j1 = jtrain.load_checkpoint(p1)
        assert c1 == jcfg
        assert jax.tree.structure(j1) == jax.tree.structure(jparams)
        assert all(same_bits(a, b) for a, b in zip(jax.tree.leaves(j1), jax.tree.leaves(jparams)))
        p2 = str(tmp_path / "jax.npz")
        jtrain.save_checkpoint(p2, jcfg, jparams)
        c2, m2 = ttrain.load_checkpoint(p2, device="cpu")
        assert c2 == tcfg
        back = as_jax(lm_params_to_jax(m2))
        assert all(same_bits(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)))


def test_shipped_prescan_checkpoint_loads_equal():
    """checkpoints/byte6l-pysrc.npz (pre-scan layers/<i>/<name>) loads with
    the same config and bits in both packages."""
    path = os.path.join(REPO, smoke.LM_CHECKPOINT)
    jcfg, jparams = jtrain.load_checkpoint(path)
    tcfg, model = ttrain.load_checkpoint(path, device="cpu")
    assert tcfg == port_config(jcfg)
    got = as_jax(lm_params_to_jax(model))
    assert jax.tree.structure(got) == jax.tree.structure(jparams)
    assert all(same_bits(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)))


def test_golden_lm_is_lac_tpus_and_the_port_is_near_it():
    path = os.path.join(REPO, smoke.LM_CHECKPOINT)
    windows = smoke.lm_windows()
    assert windows.shape == (smoke.LM_WINDOWS, smoke.LM_WINDOW)
    jcfg, jparams = jtrain.load_checkpoint(path)
    want = smoke.GOLDEN_LM["byte6l-pysrc"]
    assert abs(float(jtrain.lm_loss(jcfg, jparams, jnp.asarray(windows))) - want) <= 1e-6 * want
    tcfg, model = ttrain.load_checkpoint(path, device="cpu")
    with torch.no_grad():
        got = ttrain.lm_loss(tcfg, model, torch.from_numpy(windows)).item()
    assert abs(got - want) <= 2e-3


def test_cli_train_writes_a_checkpoint_that_loads(tmp_path):
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(smoke.smoke_corpus(1 << 14))
    out = tmp_path / "lm.npz"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "lac_tpu_torch", "train", str(corpus), "-o", str(out),
         "--preset", "tiny", "--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "saved" in proc.stdout
    cfg, model = ttrain.load_checkpoint(str(out), device="cpu")
    assert cfg.max_seq == 32 and cfg.n_layers == 2
    jcfg, _ = jtrain.load_checkpoint(str(out))
    assert port_config(jcfg) == cfg


def test_entry_points_default_to_cuda():
    """Without a card, an entry point that is not asked for the CPU raises
    rather than running there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.load_checkpoint(os.path.join(REPO, smoke.LM_CHECKPOINT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_byte_lm(T.tiny_config(), b"x" * 4096, steps=2, batch=1, seq=8)

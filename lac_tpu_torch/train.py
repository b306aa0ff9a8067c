"""Byte-LM training: the predictor for the LM coding path, trained in the port.

Ports ``lac_tpu/train.py``: ``lm_loss`` (:33-50), ``train_byte_lm``
(:53-186) and the checkpoint format, ``save_checkpoint`` and
``load_checkpoint`` (:196-269). ``lm_loss``'s ``unroll`` is JAX-only (the
unroll of the reference's ``lax.scan`` over layers; ``models/transformer.py``).

What is the reference's and must stay so:

- an f32 master copy of the parameters, a ``cfg.dtype`` forward from it,
  and gradients with respect to the master;
- ``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps,
  lr / 10), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)`` with no mask:
  every parameter decays, norms and embeddings too, and the decay is
  scaled by the schedule. The schedule is read at the update count, which
  starts at 0, so the first update has lr 0 and leaves the parameters as
  they are (``_schedule``; ``warmup = min(warmup, max(1, steps // 10))``);
- the batches: ``np.random.default_rng(seed).integers(0, len - seq - 1,
  size=batch)`` each step, so both packages see the same windows;
- the loss list holds only the logged steps; eval windows, save-best and
  its ``max_seq`` cap as the reference has them;
- with a ``mesh`` (:100-130), data parallelism: every rank of the mesh
  holds the whole f32 master copy, draws the same batch and trains on its
  ``data`` share of the rows (eval windows too); the gradients are
  all-reduced to their mean over ``data`` before AdamW, so the replicas
  stay equal, and the logged and eval losses are the ``data`` ranks'
  mean. Rank 0 writes the save-best checkpoint. At one ``data`` rank no
  collective runs and every step is the meshless one bit for bit.

Checkpoints are one ``.npz``: the params pytree flattened to
``a/b/c`` keys, bf16 stored as uint16 bit patterns listed in the
``__meta__`` JSON with the config. ``save_checkpoint`` writes the stacked
``layers/<name>`` layout; ``load_checkpoint`` reads that and the pre-scan
``layers/<i>/<name>`` layout (``checkpoints/byte6l-pysrc.npz`` is one).
A checkpoint of either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

import torch.distributed as dist

from .convert import lm_params_from_jax, lm_params_to_jax
from .models.transformer import LMConfig, Transformer, forward, init_params
from .utils.device import resolve_device

__all__ = ["train_byte_lm", "save_checkpoint", "load_checkpoint", "lm_loss"]

f32 = torch.float32


def lm_loss(cfg: LMConfig, params: Transformer, tokens: torch.Tensor, fused: bool = False,
            remat: bool = True) -> torch.Tensor:
    """Mean causal cross-entropy in nats. tokens [B, S+1]: positions 0..S-1
    predict 1..S. ``fused=True`` routes the attention through
    ``transformer._FUSED["impl"]`` (training-only numerics)."""
    tokens = tokens.long()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits = forward(cfg, params, inp, prefill=True, remat=remat, fused=fused)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return nll.mean()


def _schedule(lr: float, warmup: int, steps: int):
    """``optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.1)``
    as a function of the update count (0 for the first update)."""
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs steps > warmup, got {steps=} {warmup=}")
    alpha = 0.0 if lr == 0.0 else (lr * 0.1) / lr

    def sched(count: int) -> float:
        if count < warmup:
            frac = 1 - min(max(count, 0), warmup) / warmup
            return (0.0 - lr) * frac + lr
        c = min(count - warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return lr * ((1 - alpha) * cosine + alpha)

    return sched


def _cast(cfg: LMConfig, model: Transformer, dtype: torch.dtype) -> Transformer:
    """A copy of ``model`` with every parameter in ``dtype``."""
    out = Transformer(cfg, dtype=dtype, device="meta")
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(owner), leaf,
                torch.nn.Parameter(p.detach().to(dtype, copy=True)))
    return out


class _DataParallel:
    """A mesh's ``data`` dim for training: this rank's rows of a batch and
    the mean over the ranks."""

    def __init__(self, mesh):
        from .parallel.mesh import mesh_geometry

        self.size = mesh_geometry(mesh)["data"]
        self.rank = mesh.get_local_rank("data")
        self.group = mesh.get_group("data")

    def rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's share of a batch's rows (axis 0)."""
        if len(a) % self.size:
            raise ValueError(f"batch {len(a)} must divide by mesh data axis ({self.size})")
        per = len(a) // self.size
        return a[self.rank * per : (self.rank + 1) * per]

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced, in place, by its mean over the ranks."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
            t.div_(self.size)
        return t


def _step(cfg, master, opt, toks, lr_now: float, fused: bool, dp=None) -> torch.Tensor:
    """One update of ``master`` at learning rate ``lr_now``; the batch's loss
    (with ``dp``, this rank's rows; the gradients averaged over the ranks
    before the update)."""
    for group in opt.param_groups:
        group["lr"] = lr_now
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(cfg, master, toks, fused=fused)
    loss.backward()
    if dp is not None:
        for p in master.parameters():
            dp.mean_(p.grad)
    opt.step()
    return loss.detach()


def train_byte_lm(
    cfg: LMConfig,
    corpus: bytes,
    steps: int = 2000,
    batch: int = 32,
    seq: int = 256,
    lr: float = 3e-4,
    seed: int = 0,
    warmup: int = 100,
    log_every: int = 0,
    mesh=None,
    eval_corpus: bytes | None = None,
    eval_every: int = 0,
    eval_batches: int = 8,
    save_best_path: str | None = None,
    save_max_seq: int | None = None,
    init: Transformer | None = None,
    fused_attn: bool = False,
    device=None,
):
    """Train from scratch on ``corpus``; returns (params, losses), params a
    ``Transformer`` in ``cfg.dtype`` on ``device`` (cuda unless the caller
    passes ``"cpu"``).

    ``init``: warm-start params (e.g. from ``load_checkpoint``) instead of a
    fresh ``init_params(cfg, seed=seed)``; shapes must match ``cfg``. The
    optimizer state starts fresh (the schedule re-warms over this run).

    With ``eval_corpus``/``eval_every`` set, the mean causal loss on
    deterministic held-out windows is computed every ``eval_every`` steps
    and at the last, and (with ``save_best_path``) the best-so-far params
    are saved there, their config's ``max_seq`` capped at ``save_max_seq``
    (default: the training sequence length): RoPE positions past the
    training length degrade (``lac_tpu/train.py:80-91``).

    ``mesh``: a (data, model) mesh (``parallel.make_mesh``) to train
    data-parallel over its ``data`` dim (module docstring); ``batch``
    must divide by it."""
    dev = resolve_device(device)
    dp = None if mesh is None else _DataParallel(mesh)
    lead = dp is None or dist.get_rank() == 0  # the rank that prints and saves
    if cfg.vocab < 256:
        raise ValueError("byte LM needs vocab >= 256")
    if seq + 1 > cfg.max_seq:
        raise ValueError("seq+1 exceeds model context")
    params = init if init is not None else init_params(cfg, seed=seed)
    warmup = min(warmup, max(1, steps // 10))
    sched = _schedule(lr, warmup, steps)
    # f32 master copy for stable accumulation; the forward casts to cfg.dtype
    master = _cast(cfg, params, f32).to(dev)
    opt = torch.optim.AdamW(master.parameters(), lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.01)

    eval_windows = None
    if eval_corpus is not None and eval_every:
        earr = np.frombuffer(eval_corpus, dtype=np.uint8)
        if len(earr) < seq + 1:
            raise ValueError(
                f"eval_corpus too small: {len(earr)} bytes < seq+1 = {seq + 1}"
            )
        # deterministic evenly-spaced windows over the held-out bytes
        n_win = eval_batches * batch
        stride = max(1, (len(earr) - seq - 1) // n_win)
        starts = (np.arange(n_win) * stride) % max(1, len(earr) - seq - 1)
        eval_windows = np.stack(
            [earr[s : s + seq + 1] for s in starts]
        ).astype(np.int32).reshape(eval_batches, batch, seq + 1)

    def run_eval():
        tot = 0.0
        with torch.no_grad():
            for eb in eval_windows:
                toks = torch.from_numpy(eb if dp is None else dp.rows(eb)).to(dev)
                loss = lm_loss(cfg, master, toks, fused=fused_attn)
                tot += float(loss if dp is None else dp.mean_(loss))
        return tot / len(eval_windows)

    arr = np.frombuffer(corpus, dtype=np.uint8)
    if len(arr) < (seq + 1) * 2:
        raise ValueError("corpus too small")
    rng = np.random.default_rng(seed)
    losses = []
    best_eval = float("inf")
    for i in range(steps):
        starts = rng.integers(0, len(arr) - seq - 1, size=batch)
        toks = np.stack([arr[s : s + seq + 1] for s in starts]).astype(np.int32)
        if dp is not None:
            toks = dp.rows(toks)
        loss = _step(cfg, master, opt, torch.from_numpy(toks).to(dev), sched(i), fused_attn, dp)
        if log_every and (i % log_every == 0 or i == steps - 1):
            l = float(loss if dp is None else dp.mean_(loss))
            losses.append(l)
            if lead:
                print(f"step {i:6d}  loss {l:.4f}  ({l / np.log(2):.3f} bits/byte)",
                      flush=True)
        if eval_windows is not None and ((i + 1) % eval_every == 0 or i == steps - 1):
            ev = run_eval()
            marker = ""
            if ev < best_eval:
                best_eval = ev
                if save_best_path and lead:
                    cap = save_max_seq or min(cfg.max_seq, seq)
                    save_checkpoint(
                        save_best_path,
                        dataclasses.replace(cfg, max_seq=min(cfg.max_seq, cap)),
                        _cast(cfg, master, cfg.dtype),
                    )
                    marker = f" -> saved {save_best_path}"
            if lead:
                print(f"step {i:6d}  EVAL {ev:.4f}  ({ev / np.log(2):.3f} bits/byte)"
                      f"{marker}", flush=True)
    return _cast(cfg, master, cfg.dtype), losses


# --------------------------------------------------------------------------
# Checkpoint format: single .npz with flattened params + json'd config, the
# same file lac_tpu writes and reads.
# --------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_checkpoint(path: str, cfg: LMConfig, params: Transformer) -> None:
    """Write ``params`` (stacked layers) and ``cfg`` to ``path`` in
    ``lac_tpu``'s ``.npz`` format."""
    flat = _flatten(lm_params_to_jax(params))
    # bf16 comes out of lm_params_to_jax as uint16 bit patterns, the file's
    # own encoding; the meta lists those keys
    bf16_keys = [k for k, v in flat.items() if v.dtype == np.uint16]
    meta = dict(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, pos_embedding=cfg.pos_embedding, norm=cfg.norm,
        act=cfg.act, use_bias=cfg.use_bias, tie_embeddings=cfg.tie_embeddings,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        dtype="bfloat16" if cfg.dtype == torch.bfloat16 else "float32",
        bf16_keys=bf16_keys,
    )
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_checkpoint(path: str, device=None):
    """Returns (LMConfig, Transformer) with the file's bits, on ``device``
    (cuda unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    bf16 = set(meta.pop("bf16_keys"))
    dtype = torch.bfloat16 if meta.pop("dtype") == "bfloat16" else torch.float32
    cfg = LMConfig(dtype=dtype, **meta)

    tree: dict = {}
    for k in z.files:
        if k == "__meta__":
            continue
        v = z[k]
        if v.dtype == np.uint16 and k not in bf16:
            raise ValueError(f"{path}: {k} is uint16 but not listed as bf16")
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    layers = tree["layers"]
    if layers and all(x.isdigit() for x in layers):
        # pre-scan format (per-layer "layers/<i>/..." entries): stack them
        per = [layers[str(i)] for i in range(len(layers))]

        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            return np.stack(nodes)

        tree["layers"] = stack(per)
    return cfg, lm_params_from_jax(cfg, tree, device=dev)

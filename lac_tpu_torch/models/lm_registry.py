"""LM model registry: a container's ``model_ref`` -> (LMConfig, params).

Ports ``lac_tpu/models/lm_registry.py``: ``PRESETS`` (:28-60), the
architectures the CLI's ``train --preset`` and the coding path name, and
``resolve_lm`` (:63-89). A container must be decodable from its own
metadata, so every LM predictor is named by a reference string:

- ``prng:<preset>:<seed>``: a random-init model from the port's own
  ``transformer.init_params(cfg, seed)``. Its bits are torch's, not
  ``jax.random``'s, so a ``prng:`` container names weights that only the
  port rebuilds; ``lac_tpu`` reads the same string as other weights. The
  fingerprint's stack tag (``runtime.lm_engine.lm_fingerprint``) makes
  every such cross-stack decode fail loudly.
- ``file:<path>``: a ``.npz`` checkpoint through the port's
  ``train.load_checkpoint``; the same file holds the same weights in both
  packages.
- ``hf:<path-or-id>``: a local HuggingFace checkpoint (a directory or a
  model id in the hub cache) through ``models/hf_loader.py``, which reads
  the files without ``transformers``; nothing is downloaded.
"""

from __future__ import annotations

import dataclasses

import torch

from . import transformer as tfm
from .transformer import LMConfig, init_params

__all__ = ["PRESETS", "resolve_lm"]

PRESETS = {
    "tiny": lambda: tfm.tiny_config(vocab=256, max_seq=256),
    "tiny-gpt2": lambda: tfm.tiny_config(
        vocab=256, max_seq=256, pos_embedding="learned", norm="layernorm",
        act="gelu", use_bias=True, tie_embeddings=True, n_kv_heads=4,
    ),
    "byte-12l": lambda: LMConfig(          # ~28M-param byte LM
        vocab=256, d_model=384, n_layers=12, n_heads=6, n_kv_heads=6,
        d_ff=1536, max_seq=1024, dtype=torch.bfloat16,
    ),
    "byte-12l-mqa": lambda: LMConfig(      # byte-12l with one KV head
        vocab=256, d_model=384, n_layers=12, n_heads=6, n_kv_heads=1,
        d_ff=1536, max_seq=1024, dtype=torch.bfloat16,
    ),
    "byte-16l": lambda: LMConfig(          # ~67M-param byte LM
        vocab=256, d_model=512, n_layers=16, n_heads=8, n_kv_heads=8,
        d_ff=2048, max_seq=1024, dtype=torch.bfloat16,
    ),
    "byte-6l": lambda: LMConfig(           # ~6M-param byte LM
        vocab=256, d_model=256, n_layers=6, n_heads=4, n_kv_heads=4,
        d_ff=1024, max_seq=1024, dtype=torch.bfloat16,
    ),
    "gpt2": lambda: tfm.GPT2_SMALL,
    "tinyllama": lambda: tfm.TINYLLAMA_1B,
    "llama2-7b": lambda: tfm.LLAMA2_7B,
    "llama3-8b": lambda: tfm.LLAMA3_8B,
}


def resolve_lm(model_ref: str, max_seq: int | None = None, device=None):
    """model_ref -> (LMConfig, Transformer) on ``device`` (cuda unless the
    caller passes ``"cpu"``). ``max_seq`` overrides the context."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    kind, _, rest = model_ref.partition(":")
    if kind == "prng":
        preset, _, seed = rest.partition(":")
        if preset not in PRESETS:
            raise KeyError(f"unknown preset '{preset}'; known: {sorted(PRESETS)}")
        cfg = PRESETS[preset]()
        if max_seq is not None:
            cfg = dataclasses.replace(cfg, max_seq=max_seq)
        return cfg, init_params(cfg, int(seed or 0), device=dev)
    if kind == "hf":
        from .hf_loader import load_hf_model

        cfg, params = load_hf_model(rest, device=dev)
        if max_seq is not None:
            cfg = dataclasses.replace(cfg, max_seq=max_seq)
        return cfg, params
    if kind == "file":
        from ..train import load_checkpoint

        cfg, params = load_checkpoint(rest, device=dev)
        if max_seq is not None:
            cfg = dataclasses.replace(cfg, max_seq=max_seq)
        return cfg, params
    raise KeyError(f"unknown model_ref kind '{kind}' (want prng:, hf: or file:)")

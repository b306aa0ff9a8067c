"""LM presets: name -> LMConfig.

Ports ``PRESETS`` of ``lac_tpu/models/lm_registry.py:28-60``, the
architectures the CLI's ``train --preset`` and the coding path name.
``resolve_lm``'s ``prng:<preset>:<seed>`` references need ``jax.random``'s
bits to rebuild a container's model, and come with the LM coding slice
(ROADMAP A5).
"""

from __future__ import annotations

import torch

from . import transformer as tfm
from .transformer import LMConfig

__all__ = ["PRESETS"]

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

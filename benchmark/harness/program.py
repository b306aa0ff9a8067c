"""The program under test, as the benchmark drives it: the port's file API
(``lac_tpu_torch.runtime.lm_api``) with a model the benchmark built, and
what the harness observes of it. Nothing here computes a result of its
own.
"""

from __future__ import annotations


import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODEL_KEYS = ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq",
              "pos_embedding", "norm", "act", "use_bias", "tie_embeddings", "rope_theta",
              "norm_eps")


def build(model: dict, weights: dict, device):
    """(LMConfig, Transformer) of the port holding copies of ``weights``
    (the benchmark's flat dict, named as the port's parameters)."""
    from lac_tpu_torch.models.transformer import LMConfig, Transformer

    cfg = LMConfig(dtype=DTYPES[model["dtype"]], **{k: model[k] for k in MODEL_KEYS})
    params = Transformer(cfg, device=device)
    named = dict(params.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"the port's parameters {sorted(set(named) ^ set(weights))} differ "
                         "from the benchmark's weights")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
    return cfg, params


def api(alphabet: str):
    """(compress, decompress) of the file API for ``bytes`` or ``tokens``."""
    from lac_tpu_torch.runtime import lm_api

    if alphabet == "bytes":
        return lm_api.lm_compress_bytes, lm_api.lm_decompress_bytes
    if alphabet == "tokens":
        return lm_api.lm_compress_tokens, lm_api.lm_decompress_tokens
    raise ValueError(f"unknown alphabet {alphabet!r}")


class IntervalTap:
    """Keeps, for each encode call, the intervals each of its waves handed
    the rANS coder (``lm_engine._encode_scan``'s ``cdf_lo``, ``freq`` [lanes,
    T] and ``lengths`` [lanes], as the timed path produced them), by
    wrapping the name where ``lm_engine`` looks it up. ``start()`` opens a
    call's record, ``stop()`` closes it."""

    TARGET = "lac_tpu_torch.runtime.lm_engine:_encode_scan"

    def __init__(self, spans):
        self.calls: list[list] = []  # per call, its waves' (cdf_lo, freq, lengths)
        self._current: list | None = None
        spans.wrap_target(self.TARGET, self._observe)

    def _observe(self, args, kwargs):
        if self._current is not None:
            cdf_lo, freq, lengths = args[:3]
            self._current.append((cdf_lo, freq, lengths))

    def start(self) -> None:
        self._current = []
        self.calls.append(self._current)

    def stop(self) -> None:
        """Close the call's record, its intervals copied to the host (the
        call has returned, so they are final; the device keeps nothing)."""
        if self._current is not None:
            self._current[:] = [tuple(t.to("cpu") for t in w) for w in self._current]
        self._current = None

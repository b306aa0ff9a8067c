"""Model registry: a container's ``model_id`` -> its byte model.

Ports ``lac_tpu/models/registry.py:1-49``: the decoder rebuilds the model
from the header's ``model_id``, ``prob_bits`` and config, and the encoder
records the config that ``model_config`` gives.
"""

from __future__ import annotations

from .functional import (
    MarkovCDF,
    MarkovDecay,
    MarkovScan,
    Order0CDF,
    Order0Decay,
    Order0NibCDF,
    Order0Scan,
    Order1NibCDF,
    Order2NibCDF,
    ScanModel,
)

__all__ = ["get_scan_model", "model_config", "register_scan_model"]

_SCAN_MODELS = {
    "order0": Order0Scan,
    "markov1": MarkovScan,
    "order0d": Order0Decay,
    "markov1d": MarkovDecay,
    "order0c": Order0CDF,
    "markov1c": MarkovCDF,
    "order0n": Order0NibCDF,
    "order1n": Order1NibCDF,
    "order2n": Order2NibCDF,
}


def get_scan_model(model_id: str, prob_bits: int, vocab: int = 256, **kw) -> ScanModel:
    if model_id not in _SCAN_MODELS:
        raise KeyError(f"unknown model '{model_id}'; known: {sorted(_SCAN_MODELS)}")
    return _SCAN_MODELS[model_id](vocab=vocab, prob_bits=prob_bits, **kw)


def model_config(model_id: str, **kw) -> dict:
    """The config dict the container stores for this model: its keywords."""
    return dict(kw)


def register_scan_model(model_id: str, cls) -> None:
    _SCAN_MODELS[model_id] = cls

"""The port's models: the host predictors of the oracle coder (``lac_tpu``'s
exports of ``lac_tpu/models/__init__.py``), and beside them the byte
models (``functional``, ``registry``) and the transformer LM
(``transformer``, ``lm_registry``, ``hf_loader``), imported by name."""

from .base import CDFBackedPredictor, Predictor, StaticCDF, Uniform  # noqa: F401
from .classical import (  # noqa: F401
    AdaptiveOrder0,
    CountsPredictor,
    FSMPredictor,
    HistoryRL,
    MarkovMix,
)
from .ppm import PPM  # noqa: F401

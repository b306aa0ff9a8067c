"""The port's coders: the oracle arithmetic coder and its streaming form
(``lac_tpu``'s exports of ``lac_tpu/coder/__init__.py``), and beside them
the rANS specs (``rans``) and the LM path's batched coder (``vector``),
imported by name."""

from .reference import ArithmeticDecoder, ArithmeticEncoder, ac_decode, ac_encode  # noqa: F401
from .streaming import StreamingDecoder, StreamingEncoder  # noqa: F401

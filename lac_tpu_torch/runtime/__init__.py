"""The port's runtime: the byte codecs' file API (``lac_tpu``'s export of
``lac_tpu/runtime/__init__.py``), and beside it the turbo path, the LM
engine and API, the step graphs and the multi-process drivers, imported
by name."""

from .engine import compress_bytes, decompress_bytes  # noqa: F401

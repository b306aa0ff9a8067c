"""The native host coder: ``lac_native.cpp`` through ctypes (``host.py``)."""

from .host import (  # noqa: F401
    native_available,
    native_compress,
    native_decompress,
)

"""The port's utilities: bit framing and base-N conversion (``lac_tpu``'s
exports of ``lac_tpu/utils/__init__.py``), and beside them the device
choice (``device``) and the scan loop (``scan``), imported by name.

``lac_tpu/utils/jaxutil.py`` has no counterpart, being JAX-only:
``force_cpu`` pins JAX's platform (here an entry point's ``device="cpu"``
does that), and ``x64`` scopes JAX's 64-bit mode (torch has int64
throughout, so nothing needs enabling)."""

from .baseconv import bytes_to_digits, digits_to_bytes  # noqa: F401
from .bits import BitReader, BitWriter, pack_bits, unpack_bits  # noqa: F401

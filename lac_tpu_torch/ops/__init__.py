"""The port's ops: the host spec holders of the CDF quantizer
(``lac_tpu``'s exports of ``lac_tpu/ops/__init__.py``), and beside them the
CUDA kernels' wrappers (``rans_kernels``, ``attention``,
``step_attention``), their build
(``_build``), the det8 math and the int8 products, imported by name.
Importing builds nothing: a kernel is built at its first launch."""

from .quantize import (  # noqa: F401
    cdf_from_freq_np,
    quantize_logits_np,
    rescale_cdf,
)

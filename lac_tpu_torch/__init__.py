"""lac_tpu_torch: the lacuna byte compressor ported to PyTorch and CUDA.

A second package beside ``lac_tpu`` (JAX and Pallas, the reference, which
stays as it is). It imports ``torch`` and NumPy, never JAX and nothing of
``lac_tpu``. Its layout follows ``lac_tpu``'s subpackages:

- ``stream``  - the .lac container (an independent copy of the format);
- ``coder``   - the rANS-32/16 NumPy spec;
- ``models``  - the turbo byte models as torch functions over lanes, and
                the transformer LM's float prefill forward with its presets;
- ``ops``     - the CUDA kernels (``csrc/``), their build and their wrappers,
                each beside its plain PyTorch version;
- ``runtime`` - the turbo byte path and the file-level API;
- ``train``   - byte-LM training and the ``.npz`` checkpoint format;
- ``cli``     - ``python -m lac_tpu_torch compress|decompress|info|verify|train``.

Entry points run on the card unless the caller passes ``device="cpu"``.
The turbo byte path is ported for all four of its codecs: order0n (the
default), order1n, order2n and order0c, and training with its fused
causal attention; see ROADMAP.md for the rest.
"""

__version__ = "0.1.0"

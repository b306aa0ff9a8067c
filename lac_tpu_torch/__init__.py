"""lac_tpu_torch: the lacuna byte compressor ported to PyTorch and CUDA.

A second package beside ``lac_tpu`` (JAX and Pallas, the reference, which
stays as it is). It imports ``torch`` and NumPy, never JAX and nothing of
``lac_tpu``. Its layout follows ``lac_tpu``'s subpackages:

- ``stream``  - the .lac container (an independent copy of the format);
- ``coder``   - the rANS-32/16 and rANS-64/32 NumPy specs, and the batched
                rANS-64/32 coder of the LM path;
- ``models``  - the byte models (turbo and scan) as torch functions over
                lanes with their registry, and
                the transformer LM's float and int8 (kv8, w8) forwards
                (prefill and cached decode step, the slide ring) with its
                presets and model refs;
- ``ops``     - the CUDA kernels (``csrc/``), their build and their wrappers,
                each beside its plain PyTorch version; the exact int8
                products of the int8 LM modes (``int8.py``);
- ``runtime`` - the turbo byte path, the scan engine, the LM coding engine
                (its step as a CUDA graph) and the file-level APIs;
- ``train``   - byte-LM training and the ``.npz`` checkpoint format;
- ``cli``     - ``python -m lac_tpu_torch compress|decompress|info|verify|recover|train``.

Entry points run on the card unless the caller passes ``device="cpu"``.
The turbo byte path is ported for all four of its codecs: order0n (the
default), order1n, order2n and order0c; the scan codecs (order0, the API's
default, markov1, order0d, markov1d and markov1c); training with its fused
causal attention; and LM coding (``--model lm``) of bytes or token ids
with the float forward, the int8 modes (``--kv8``, ``--w8``) and det8, for
blocks within the model context and past it (the slide and reprime
schedules), its step replayed as a CUDA graph on the card; see ROADMAP.md
for the rest.

Importing the package sets ``CUBLAS_WORKSPACE_CONFIG`` (unless the caller
has): cuBLAS reads it when its first call of the process sets up, and the
LM coding calls run with deterministic algorithms, which require it
(``runtime/lm_engine.py``, ``_coding``).
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__version__ = "0.1.0"

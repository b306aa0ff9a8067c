"""Device choice for the port's entry points.

The JAX package has no counterpart: there the backend is JAX's default
device. Here every public entry point takes ``device=None``, which means
``"cuda"``; the CPU runs only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda. Raises when a CUDA device is asked for and there is
    none, rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Carry model state between ``lac_tpu`` and the port.

The JAX package has no counterpart. The order0n codec has no weights: what
the two packages share is the model state and the codec config. The state
of ``lac_tpu.models.functional.Order0NibCDF`` is ``(sh [B, 17],
sl [B, 16, 17], cnt [B, 16], step)``; the port's ``Order0NibCDF`` keeps the
same layout as int32 tensors, with the step as a Python int. Both
functions take and give NumPy arrays on the JAX side, so this module
imports nothing of JAX. The checkpoint loader comes with the LM slice.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_jax", "state_to_jax"]


def state_from_jax(sh, sl, cnt, step=0, device="cpu"):
    """NumPy arrays of ``lac_tpu``'s Order0NibCDF state -> the port's state
    tuple ``(sh, sl, cnt, step)`` on ``device``."""
    sh, sl, cnt = (np.asarray(a) for a in (sh, sl, cnt))
    b = sh.shape[0]
    if sh.shape != (b, 17) or sl.shape != (b, 16, 17) or cnt.shape != (b, 16):
        raise ValueError(
            f"expected [B,17], [B,16,17], [B,16]; got {sh.shape}, {sl.shape}, {cnt.shape}"
        )
    to = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    return (to(sh), to(sl), to(cnt), int(step))


def state_to_jax(state):
    """The port's state tuple -> NumPy arrays ``(sh, sl, cnt, step)`` in
    ``lac_tpu``'s layout and dtypes (int32)."""
    sh, sl, cnt, step = state
    return (
        sh.cpu().numpy().astype(np.int32),
        sl.cpu().numpy().astype(np.int32),
        cnt.cpu().numpy().astype(np.int32),
        np.int32(step),
    )

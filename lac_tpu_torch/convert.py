"""Carry model state between ``lac_tpu`` and the port.

The JAX package has no counterpart. The nibble codecs have no weights: what
the two packages share is the model state and the codec config. The port's
models keep the reference's state layouts as int32 tensors
(``models/functional.py``):

- ``Order0NibCDF``: ``(sh [B, 17], sl [B, 16, 17], cnt [B, 16], step)``,
  the step a Python int here and an int32 scalar there;
- ``Order1NibCDF`` / ``Order2NibCDF``: ``(sh [B, 16, 17],
  sl [B, 16|64, 17], cnth [B, 16], cntl [B, 16|64], prev_h [B])``.

Both functions take and give NumPy arrays on the JAX side, so this module
imports nothing of JAX. The checkpoint loader comes with the LM slice.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_jax", "state_to_jax"]


def _shapes_ok(arrays) -> bool:
    sh = arrays[0]
    b = sh.shape[0]
    if len(arrays) == 3:  # order0n
        sl, cnt = arrays[1], arrays[2]
        return sh.shape == (b, 17) and sl.shape == (b, 16, 17) and cnt.shape == (b, 16)
    sl, cnth, cntl, prev_h = arrays[1:]
    nl = sl.shape[1] if sl.ndim == 3 else -1
    return (sh.shape == (b, 16, 17) and nl in (16, 64) and sl.shape == (b, nl, 17)
            and cnth.shape == (b, 16) and cntl.shape == (b, nl) and prev_h.shape == (b,))


def state_from_jax(*state, device="cpu"):
    """NumPy arrays of a ``lac_tpu`` nibble-model state -> the port's state
    tuple on ``device``: ``(sh, sl, cnt[, step])`` for order0n (step 0 when
    left out), ``(sh, sl, cnth, cntl, prev_h)`` for order1n and order2n."""
    if len(state) == 3:
        state = (*state, 0)
    if len(state) not in (4, 5):
        raise ValueError(f"expected a state of 4 or 5 parts, got {len(state)}")
    order0n = len(state) == 4
    arrays = [np.asarray(a) for a in (state[:3] if order0n else state)]
    if not _shapes_ok(arrays):
        raise ValueError(f"not a nibble-model state: shapes {[a.shape for a in arrays]}")
    out = tuple(torch.from_numpy(np.array(a, dtype=np.int32)).to(device) for a in arrays)
    return (*out, int(state[3])) if order0n else out


def state_to_jax(state):
    """The port's state tuple -> NumPy int32 arrays in ``lac_tpu``'s layout:
    ``(sh, sl, cnt, step)`` or ``(sh, sl, cnth, cntl, prev_h)``."""
    if len(state) == 4:
        *tensors, step = state
        return (*(t.cpu().numpy().astype(np.int32) for t in tensors), np.int32(step))
    return tuple(t.cpu().numpy().astype(np.int32) for t in state)

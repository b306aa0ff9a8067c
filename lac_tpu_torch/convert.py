"""Carry model state between ``lac_tpu`` and the port.

The JAX package has no counterpart. The nibble codecs have no weights: what
the two packages share is the model state and the codec config. The port's
models keep the reference's state layouts as int32 tensors
(``models/functional.py``):

- ``Order0CDF``: ``(cdf [B, 257], step)``, the step a Python int here and
  an int32 scalar there;
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


def _stepped(first) -> bool:
    """Whether the state whose first array is ``first`` ends with a step:
    order0c's cdf [B, 257] and order0n's sh [B, 17] are 2-D, the context
    models' sh [B, 16, 17] 3-D."""
    return first.ndim == 2


def _shapes_ok(arrays) -> bool:
    """The arrays of a state, its step left out, keyed on the first's shape."""
    first = arrays[0]
    if first.ndim not in (2, 3):
        return False
    b = first.shape[0]
    if first.shape == (b, 257):  # order0c: (cdf,)
        return len(arrays) == 1
    if first.shape == (b, 17):  # order0n: (sh, sl, cnt)
        return (len(arrays) == 3 and arrays[1].shape == (b, 16, 17)
                and arrays[2].shape == (b, 16))
    if first.shape != (b, 16, 17) or len(arrays) != 5:  # order1n, order2n
        return False
    sl, cnth, cntl, prev_h = arrays[1:]
    nl = sl.shape[1] if sl.ndim == 3 else -1
    return (nl in (16, 64) and sl.shape == (b, nl, 17) and cnth.shape == (b, 16)
            and cntl.shape == (b, nl) and prev_h.shape == (b,))


def state_from_jax(*state, device="cpu"):
    """NumPy arrays of a ``lac_tpu`` turbo-model state -> the port's state
    tuple on ``device``: ``(cdf, step)`` for order0c, ``(sh, sl, cnt[, step])``
    for order0n (step 0 when left out), ``(sh, sl, cnth, cntl, prev_h)`` for
    order1n and order2n."""
    if not state:
        raise ValueError("expected a turbo-model state, got nothing")
    stepped = _stepped(np.asarray(state[0]))
    if stepped and len(state) == 3:  # order0n without its step
        state = (*state, 0)
    arrays = [np.asarray(a) for a in (state[:-1] if stepped else state)]
    if not arrays or not _shapes_ok(arrays):
        raise ValueError(f"not a turbo-model state: shapes {[np.shape(a) for a in state]}")
    out = tuple(torch.from_numpy(np.array(a, dtype=np.int32)).to(device) for a in arrays)
    return (*out, int(state[-1])) if stepped else out


def state_to_jax(state):
    """The port's state tuple -> NumPy int32 arrays in ``lac_tpu``'s layout:
    ``(cdf, step)``, ``(sh, sl, cnt, step)`` or
    ``(sh, sl, cnth, cntl, prev_h)``."""
    if _stepped(state[0]):
        *tensors, step = state
        return (*(t.cpu().numpy().astype(np.int32) for t in tensors), np.int32(step))
    return tuple(t.cpu().numpy().astype(np.int32) for t in state)

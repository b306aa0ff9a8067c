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
imports nothing of JAX.

LM parameters: ``lm_params_from_jax`` and ``lm_params_to_jax`` carry the
params pytree of ``lac_tpu.models.transformer`` (``init_params``'
stacked layout: ``layers/<name>`` with a leading ``[n_layers]`` axis) to
and from the port's ``Transformer`` module, with no arithmetic: arrays
are copied bit for bit, and bf16 travels as uint16 bit patterns, since
NumPy has no bf16 of its own. A w8 tree (``lac_tpu``'s ``ensure_w8``:
each ``W8_KEYS`` leaf and ``head`` a ``(int8 q, f32 scale)`` tuple) goes
to and from a quantized model, its tuples the ``W8`` modules' ``q`` and
``s``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_jax", "state_to_jax", "lm_params_from_jax", "lm_params_to_jax"]


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


# --------------------------------------------------------------------------
# LM parameters
# --------------------------------------------------------------------------


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype == np.uint16 or a.dtype.name == "bfloat16"


def _tensor(a, device) -> torch.Tensor:
    """A NumPy leaf -> a tensor with the same bits: uint16 (or an ml_dtypes
    bfloat16 array) becomes bf16, anything else keeps its type."""
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _set(module: torch.nn.Module, name: str, value) -> None:
    """A float leaf as a parameter; a w8 ``(q, scale)`` tuple as a ``W8``."""
    from .models.transformer import W8

    if isinstance(value, tuple):
        q, s = value
        setattr(module, name, W8(q.t().contiguous().t(), s))
    else:
        setattr(module, name, torch.nn.Parameter(value, requires_grad=True))


def _leaf(arr, device, i=None):
    """A tree leaf (or layer ``i`` of a stacked one) as a tensor, or a w8
    tuple as a tuple of tensors."""
    if isinstance(arr, tuple):
        return tuple(_leaf(a, device, i) for a in arr)
    return _tensor(np.asarray(arr) if i is None else np.asarray(arr)[i], device)


def lm_params_from_jax(cfg, tree: dict, device="cpu"):
    """``lac_tpu``'s LM params pytree, its leaves NumPy arrays (bf16 leaves
    as ml_dtypes bfloat16 or as uint16 bit patterns), stacked layers ->
    a ``models.transformer.Transformer`` on ``device`` holding the same
    bits. Each tensor keeps its array's shape. A w8 tree needs ``cfg.w8``
    and gives a quantized model."""
    from .models.transformer import Transformer

    w8 = isinstance(tree.get("head"), tuple)
    if w8 != cfg.w8:
        raise ValueError(f"a {'w8' if w8 else 'float'} params tree under cfg.w8={cfg.w8}")
    model = Transformer(cfg, device="meta", w8=w8)
    _set(model, "embed", _tensor(tree["embed"], device))
    for name in ("pos_embed", "head"):
        if name in tree:
            _set(model, name, _leaf(tree[name], device))
        elif getattr(model, name) is not None:
            raise ValueError(f"the params lack {name!r}, which the config needs")
    for name, arr in tree["final_norm"].items():
        _set(model.final_norm, name, _tensor(arr, device))
    layers = tree["layers"]
    for i, block in enumerate(model.layers):
        for name, arr in layers.items():
            if isinstance(arr, dict):  # ln1 / ln2
                for sub, a in arr.items():
                    _set(getattr(block, name), sub, _leaf(a, device, i))
            else:
                _set(block, name, _leaf(arr, device, i))
    left = [n for n, p in (*model.named_parameters(), *model.named_buffers())
            if p.device.type == "meta"]
    if left:
        raise ValueError(f"the params lack {left}")
    return model


def lm_params_to_jax(model) -> dict:
    """The port's ``Transformer`` -> ``lac_tpu``'s params pytree of NumPy
    arrays, layers stacked on a leading axis; bf16 tensors come out as
    uint16 bit patterns (``a.view(jnp.bfloat16)`` on the JAX side). The
    layer keys are sorted, as ``jax.tree.map`` leaves them. A quantized
    model gives a w8 tree: each ``W8`` a ``(q, s)`` tuple."""
    from .models.transformer import W8

    tree = {"embed": _array(model.embed),
            "final_norm": {n: _array(p) for n, p in model.final_norm.named_parameters()}}
    per_layer: dict = {}
    for block in model.layers:
        for name, p in block.named_parameters():
            per_layer.setdefault(name, []).append(_array(p))
        for name, m in block.named_children():
            if isinstance(m, W8):
                per_layer.setdefault(name, []).append((_array(m.q), _array(m.s)))
    layers: dict = {}
    for name in sorted(per_layer):
        head, _, sub = name.partition(".")
        leaves = per_layer[name]
        stacked = (tuple(np.stack(x) for x in zip(*leaves)) if isinstance(leaves[0], tuple)
                   else np.stack(leaves))
        if sub:
            layers.setdefault(head, {})[sub] = stacked
        else:
            layers[name] = stacked
    tree["layers"] = {k: (dict(sorted(v.items())) if isinstance(v, dict) else v)
                      for k, v in sorted(layers.items())}
    if model.pos_embed is not None:
        tree["pos_embed"] = _array(model.pos_embed)
    if isinstance(model.head, W8):
        tree["head"] = (_array(model.head.q), _array(model.head.s))
    elif model.head is not None:
        tree["head"] = _array(model.head)
    return tree

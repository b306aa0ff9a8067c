"""A configuration's weights, made or loaded once on the device in the
type they are served in, as one flat dict ``name -> tensor`` that both
sides read: the program (``program.build``) and the plain reference.

Kinds (the configuration file's ``weights.kind``):

- ``npz``: a checkpoint file of the repo, pinned by sha256; bf16 leaves
  stored as uint16 bit patterns, ``layers/<i>/<name>`` per layer or
  ``layers/<name>`` stacked over the layers. Its ``__meta__`` has to
  state the configuration's sizes.
- ``random``: every stored weight of the family's shapes drawn from one
  ``torch.Generator`` on the device seeded with ``--seed``, in one call:
  matrices and biases N(0, ``std``), the family's residual outputs
  N(0, ``std / sqrt(2 * n_layers)``), norm scales 1, norm biases 0; a
  weight named in ``fill`` holds that value instead.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from .manifest import pinned

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _npz(cell, device) -> dict:
    spec = cell.config["weights"]
    z = np.load(pinned(cell.root, spec["path"], spec["sha256"]), allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    for key, want in cell.model.items():
        if key in meta and meta[key] != want:
            raise ValueError(f"{spec['path']}: {key} {meta[key]!r}, the configuration "
                             f"states {want!r}")
    dtype = DTYPES[cell.model["dtype"]]
    out = {}
    for key in z.files:
        if key == "__meta__":
            continue
        arr = z[key]
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if arr.dtype == np.uint16 else torch.from_numpy(arr))
        t = t.to(device=device, dtype=dtype)
        parts = key.split("/")
        if parts[0] == "layers" and not parts[1].isdigit():  # stacked over the layers
            for i in range(t.shape[0]):
                out[".".join(["layers", str(i)] + parts[1:])] = t[i]
        else:
            out[".".join(parts)] = t
    return out


def _random(cell, family, seed: int, device) -> dict:
    spec = cell.config["weights"]
    m = cell.model
    shapes = family.param_shapes(m)
    dtype = DTYPES[m["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=g, dtype=dtype, device=device)
    std, out_std = spec["std"], spec["std"] / math.sqrt(2 * m["n_layers"])
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            n = math.prod(shape)
            t = flat[at : at + n].view(shape)
            at += n
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":  # a norm's
                t.fill_(1)
            elif leaf == "bias":
                t.zero_()
            else:
                t.mul_(out_std if leaf in family.RESIDUAL_OUT else std)
            if name in spec.get("fill", {}):
                t.fill_(spec["fill"][name])
            out[name] = t
    return out


def make(cell, family, seed: int, device) -> dict:
    kind = cell.config["weights"]["kind"]
    if kind == "npz":
        weights = _npz(cell, device)
    elif kind == "random":
        weights = _random(cell, family, seed, device)
    else:
        raise ValueError(f"unknown weights kind {kind!r}")
    shapes = family.param_shapes(cell.model)
    if set(weights) != set(shapes):
        raise ValueError(f"weights {sorted(set(weights) ^ set(shapes))} differ from the "
                         f"{cell.config['family']} family's")
    for name, shape in shapes.items():
        if tuple(weights[name].shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(weights[name].shape)}, want {shape}")
    return weights

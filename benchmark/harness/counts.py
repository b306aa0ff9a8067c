"""The work one coding step needs, from the configuration's shapes, and the
card's published peaks. A step codes one position of every lane; only the
lanes that hold a block at that position do useful work, and only they are
counted.

- FLOPs: 2 x the matmul parameters a token passes (every projection and
  the head), plus 4 x d_model x the context it attends to (QK^T and PV
  over ``t`` cached positions and its own), a layer; times the live lanes.
- Bytes: every weight the step reads, once, in its stored type (under w8
  the int8 projections and head and their f32 column scales; the float
  embedding and norms as stored), the embedding rows the lanes look up,
  and the ``t`` cached K/V rows of each live lane, once, in the cache's
  type (under kv8 int8 with an f32 scale a row). What a step needs, not
  what the program reads: a cache wider than ``t`` is not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _proj_shapes(m: dict) -> list:
    """(K, N) of one layer's projections."""
    d, h, kvh, ff = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    hd = d // h
    shapes = [(d, h * hd), (d, kvh * hd), (d, kvh * hd), (h * hd, d), (d, ff), (ff, d)]
    if m["act"] == "silu_glu":
        shapes.append((d, ff))
    return shapes


def matmul_params(m: dict) -> int:
    """Weights a token multiplies: the layers' projections and the head."""
    layer = sum(k * n for k, n in _proj_shapes(m))
    return m["n_layers"] * layer + m["d_model"] * m["vocab"]


def step_flops(m: dict, t: int, live: int) -> float:
    """FLOPs of the step at position ``t`` (``t`` positions cached) for
    ``live`` lanes."""
    attn = 4 * m["d_model"] * (t + 1) * m["n_layers"]
    return float(live) * (2 * matmul_params(m) + attn)


def weight_bytes(m: dict, coding: dict) -> int:
    """Bytes of the weights one step reads once."""
    el = DTYPE_BYTES[m["dtype"]]
    d, n_norms = m["d_model"], 2 * m["n_layers"] + 1
    norm = n_norms * d * el * (2 if m["norm"] == "layernorm" else 1)
    mats = _proj_shapes(m) * m["n_layers"] + [(d, m["vocab"])]
    if coding.get("w8"):
        proj = sum(k * n + 4 * n for k, n in mats)
    else:
        proj = sum(k * n for k, n in mats) * el
    bias = 0
    if m["use_bias"]:
        bias = m["n_layers"] * sum(n for _, n in _proj_shapes(m)) * el
    return norm + proj + bias


def kv_row_bytes(m: dict, coding: dict) -> int:
    """Bytes of one cached position of one lane, K and V, every layer."""
    kvh, hd = m["n_kv_heads"], m["d_model"] // m["n_heads"]
    if coding.get("kv8"):
        per_layer = 2 * (kvh * hd + 4 * kvh)
    else:
        per_layer = 2 * kvh * hd * DTYPE_BYTES[m["dtype"]]
    return m["n_layers"] * per_layer


def step_bytes(m: dict, coding: dict, t: int, live: int) -> float:
    """Bytes the step at position ``t`` needs to move for ``live`` lanes."""
    el = DTYPE_BYTES[m["dtype"]]
    rows = live * m["d_model"] * el * (2 if m["pos_embedding"] == "learned" else 1)
    return float(weight_bytes(m, coding) + rows + live * t * kv_row_bytes(m, coding))


def step_bound_s(m: dict, coding: dict, t: int, live: int) -> float:
    """The least time the card could take for the step: the larger of its
    bytes over the HBM rate and its FLOPs over the bf16 rate."""
    return max(step_bytes(m, coding, t, live) / PEAK_HBM_BYTES,
               step_flops(m, t, live) / PEAK_BF16_FLOPS)


def live_lanes(lengths: list, t: int) -> int:
    return sum(1 for n in lengths if n > t)

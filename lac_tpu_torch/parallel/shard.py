"""Sharding rules: Megatron tensor parallelism of the transformer over the
mesh's ``model`` dim, and the coding lanes over ``data``.

Ports ``lac_tpu/parallel/shard.py`` (:26-91). There GSPMD partitions one
jitted program from the placements; here each rank holds its own slice of
the weights and the forward (``models/transformer.py``) calls the
``model`` group's collectives where a product's contraction is split:

- column-parallel (the output dim cut into ``model`` equal parts): ``wq``,
  ``wk``, ``wv``, ``w_up``, ``w_gate`` and the biases ``bq``, ``bk``,
  ``bv``, ``b_up``. The heads of a rank are contiguous, so the query heads
  of a GQA group stay with their K/V head;
- row-parallel (the input dim cut): ``wo`` and ``w_down``, each followed by
  one all-reduce of its partial product; ``bo`` and ``b_down`` are added
  after it;
- replicated: the embeddings, the norms and the head;
- the KV cache holds the rank's KV heads (kv8's scales too), and its lanes
  are the rank's ``data`` share (``lane_share``).

A w8 or det8 weight is quantized over its input dim (one scale a column)
before it is cut (``ensure_quantized``), as the reference quantizes the
whole weight under GSPMD: a column-parallel weight takes its columns'
scales; a row-parallel one keeps every scale whole, since its scale's
input dim has size 1 (the rule of :33-40).

The reductions each mode splits, and how (``transformer._row_parallel``):

- float: the partial products of ``wo`` and ``w_down`` are f32 products of
  ``cfg.dtype`` operands, summed over the ranks in f32, then rounded once
  to ``cfg.dtype``. The all-reduce's order of adds is not the unsharded
  product's, so float CDFs depend on the mesh, as in the reference: the
  container records the geometry and the decoder must replay it.
- w8 (``_w8_dot``) and det8 (``_det_dot8_parts`` via ``_dual16``): two
  reductions a row-parallel product. (1) The activation row's quantization
  scale is the maximum of ``|x|`` over the whole row: each rank's row
  maximum, all-reduced with MAX (exact in any order). (2) The int8 product
  is summed in int32: each rank's partial int32 accumulator, all-reduced
  with SUM before any rounding (exact in any order; int32 holds K * 127 *
  128). The dequant that follows runs on the full sums. Nothing else of
  either forward reduces over a split dim: the attention, its integer
  softmax (``_attend_det8``: the scores, ``int_sum_pow2``, the PV product)
  and the kv8 cache routes reduce within a KV head, which one rank holds
  whole; the norms, RoPE, the residuals and the head run on replicated
  rows. So det8 (and w8) give the same bits at every geometry, no mesh
  included.

On the card the all-reduces go over NCCL and are captured in the coding
step's CUDA graph (``runtime/step_graph.py``); on the CPU they go over gloo,
eagerly. At ``model`` 1 nothing is cut and no collective runs.

JAX-only, with no counterpart: the reference's GSPMD placements
``param_pspecs``, ``param_shardings``, ``cache_pspecs`` and ``lane_pspec``
(``PartitionSpec`` trees and ``NamedSharding``s that XLA partitions one
program from). Here a rank holds its slice itself (``shard_params``) and
its lanes (``lane_share``), so there is no placement to describe.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.transformer import (LMConfig, Transformer, _Int8Weight, ensure_quantized,
                                  is_det8, is_w8)
from .mesh import mesh_geometry

__all__ = ["TP", "Lanes", "shard_params", "lane_share"]

COLUMN = ("wq", "wk", "wv", "w_up", "w_gate", "bq", "bk", "bv", "b_up")
ROW = ("wo", "w_down")


class TP:
    """The ``model`` group of a sharded model: its size and the two
    all-reduces the row-parallel products call (in place)."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t


@dataclass(frozen=True)
class Lanes:
    """A rank's share of a wave: lanes [lo, lo + n) of each wave, and the
    ``data`` group that the coded blocks are gathered over (None when the
    mesh has one data rank)."""

    lo: int
    n: int
    group: object | None


def lane_share(mesh: DeviceMesh, lanes: int) -> Lanes:
    """This rank's ``Lanes`` of a wave of ``lanes`` (the reference's
    ``P("data")`` placement of the lanes)."""
    d = mesh_geometry(mesh)["data"]
    if lanes % d:
        raise ValueError(f"lanes ({lanes}) must divide by mesh data axis ({d})")
    n = lanes // d
    return Lanes(mesh.get_local_rank("data") * n, n, mesh.get_group("data") if d > 1 else None)


def _cut(t: torch.Tensor, dim: int, rank: int, m: int) -> torch.Tensor:
    n = t.shape[dim] // m
    return t.narrow(dim, rank * n, n)


def _shard(w, dim: int, rank: int, m: int):
    """``w`` cut along ``dim`` (0 row-parallel, 1 column-parallel; a bias
    along its one dim)."""
    if isinstance(w, _Int8Weight):
        q = _cut(w.q, dim, rank, m).t().contiguous().t()  # column-major, as stored
        s = _cut(w.s, 1, rank, m).contiguous() if dim == 1 else w.s
        return type(w)(q, s)
    part = _cut(w.detach(), min(dim, w.dim() - 1), rank, m).contiguous()
    return nn.Parameter(part, requires_grad=w.requires_grad)


def shard_params(mesh: DeviceMesh, params: Transformer,
                 cfg: LMConfig | None = None) -> Transformer:
    """This rank's slice of ``params`` under ``cfg``'s forward (default
    ``params.cfg``; quantized first for w8 and det8: module docstring), its
    layers carrying the ``model`` group (``Block.tp``). At ``model`` 1,
    ``params`` as ``ensure_quantized`` gives it."""
    cfg = params.cfg if cfg is None else cfg
    params = ensure_quantized(cfg, params)
    m = mesh_geometry(mesh)["model"]
    if m == 1:
        return params
    for name in ("n_heads", "n_kv_heads", "d_ff"):
        if getattr(cfg, name) % m:
            raise ValueError(f"{name} ({getattr(cfg, name)}) must divide by mesh model "
                             f"axis ({m})")
    rank = mesh.get_local_rank("model")
    tp = TP(mesh.get_group("model"), m)
    with torch.no_grad():
        out = Transformer(cfg, device="meta", w8=is_w8(params) or is_det8(params))
        out.embed, out.pos_embed = params.embed, params.pos_embed
        out.final_norm, out.head = params.final_norm, params.head
        for lyr, src in zip(out.layers, params.layers):
            for name, child in src.named_children():
                if name in COLUMN or name in ROW:
                    child = _shard(child, 0 if name in ROW else 1, rank, m)
                setattr(lyr, name, child)
            for name, p in src.named_parameters(recurse=False):
                setattr(lyr, name, _shard(p, 0 if name in ROW else 1, rank, m)
                        if name in COLUMN or name in ROW else p)
            lyr.tp = tp
    return out

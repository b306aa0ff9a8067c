"""Multi-process coding: shard blocks across ranks, gather bitstreams in
original order.

Ports ``lac_tpu/parallel/distributed.py`` (:24-75) to ``torch.distributed``.
The reference is one controller per host over its local devices; the port
is SPMD, one rank per device, launched by ``torchrun`` (or any spawner
that calls ``distributed_init``). Every rank codes a contiguous span of
blocks (``my_block_span``, the reference's formula) and the per-block
payloads are exchanged in two fixed-shape rounds, as the reference's
``process_allgather``: the lengths first, then the bytes padded to the
longest and trimmed by length (``allgather_blocks``). The rounds are
``dist.all_gather`` of CPU ``int64`` / ``uint8`` tensors; no pickle
crosses the wire.

One process group serves both kinds of traffic: its backend is
``"cpu:gloo,cuda:nccl"`` on the card (``backend_for``), so the gathers'
CPU tensors go over gloo and the tensor-parallel all-reduces of CUDA
tensors (``parallel/shard.py``) over NCCL; on the CPU it is gloo alone.
NCCL refuses two ranks on one card, so on a machine with one card NCCL
runs at world size 1 only; two ranks may still share the card for the
block-span path, whose collectives are all gloo's.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "backend_for",
    "distributed_init",
    "rank_and_size",
    "my_block_span",
    "allgather_lists",
    "allgather_blocks",
    "pack_block",
    "unpack_block",
]


def backend_for(device: torch.device) -> str:
    """The process group's backend for ranks on ``device``: on the card gloo
    for CPU tensors and NCCL for CUDA tensors, on the CPU gloo."""
    return "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout: float | None = None) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (no-op at one process), the reference's arguments:
    ``coordinator`` is the rendezvous, ``host:port`` (as ``tcp://host:port``)
    or a URL torch takes (``tcp://``, ``file://``, ``env://``). Unset
    arguments come from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``env://``). On the card each rank takes card ``LOCAL_RANK``
    modulo the cards it sees. ``timeout``: seconds a collective may wait
    (torch's default when None)."""
    world_size = num_processes
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    init_method = coordinator or "env://"
    if "://" not in init_method:
        init_method = "tcp://" + init_method
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def rank_and_size(group=None) -> tuple[int, int]:
    """(rank, size) in ``group`` (the world when None); (0, 1) without a
    process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def my_block_span(n_blocks: int, process_id: int | None = None,
                  n_processes: int | None = None) -> tuple[int, int]:
    """Contiguous block span [start, end) owned by rank ``process_id`` of
    ``n_processes`` (this rank of the world when None)."""
    r, n = rank_and_size()
    r = r if process_id is None else process_id
    n = n if n_processes is None else n_processes
    per = -(-n_blocks // n)
    start = min(r * per, n_blocks)
    return start, min(start + per, n_blocks)


def allgather_lists(items: list[bytes], per: int, group=None) -> list[list[bytes]]:
    """Every rank's ``items`` (at most ``per``), gathered over ``group`` (the
    world when None) in its rank order, each rank's list padded with empty
    items to ``per``: one all_gather of the lengths [per] int64, one of the
    bytes [per, longest] uint8, trimmed by length."""
    if len(items) > per:
        raise ValueError(f"{len(items)} items > per {per}")
    _, n = rank_and_size(group)
    if n == 1:
        return [list(items) + [b""] * (per - len(items))]
    lens = torch.zeros(per, dtype=torch.int64)
    lens[: len(items)] = torch.tensor([len(p) for p in items], dtype=torch.int64)
    all_lens = [torch.empty_like(lens) for _ in range(n)]
    dist.all_gather(all_lens, lens, group=group)
    width = max(1, int(torch.stack(all_lens).max()))
    buf = np.zeros((per, width), dtype=np.uint8)
    for i, p in enumerate(items):
        buf[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    local = torch.from_numpy(buf)
    all_buf = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(all_buf, local, group=group)
    out = []
    for b, ln in zip(all_buf, all_lens):
        rows = b.numpy()
        out.append([rows[i, :k].tobytes() for i, k in enumerate(ln.tolist())])
    return out


def pack_block(raw_len: int, token_count: int, payload: bytes) -> bytes:
    """A container block's (raw_len, token_count, payload) as one item for
    the gathers: two little-endian u32, then the payload."""
    return raw_len.to_bytes(4, "little") + token_count.to_bytes(4, "little") + payload


def unpack_block(item: bytes) -> tuple[int, int, bytes]:
    return int.from_bytes(item[:4], "little"), int.from_bytes(item[4:8], "little"), item[8:]


def allgather_blocks(payloads: list[bytes], n_blocks: int, group=None) -> list[bytes]:
    """Gather per-block payloads from every rank, ordered by block index.
    Each rank passes its ``my_block_span`` payloads in block order; every
    rank gets the full list."""
    _, n = rank_and_size(group)
    if n == 1:
        if len(payloads) != n_blocks:
            raise ValueError(f"{len(payloads)} payloads for {n_blocks} blocks")
        return payloads
    per = -(-n_blocks // n)
    lists = allgather_lists(payloads, per, group)
    return [lists[b // per][b % per] for b in range(n_blocks)]

"""``lax.scan`` over the lanes' positions, a chunk of steps a CUDA graph.

Stands for the ``lax.scan`` loops of ``lac_tpu``'s scan engine
(``lac_tpu/runtime/engine.py:53-86``: the model's intervals and the
lock-step decode) and of its batched rANS encoder
(``lac_tpu/coder/vector.py:42-96``). There XLA compiles the whole loop
into one program; here a step is a handful of small torch ops over
``[B, ...]`` lane tensors, so an eager loop is held by its launches.

``scan`` runs ``step(carry, x) -> (carry, y)`` over the leading axis of
``xs``, forward or in reverse, and returns the last carry and the stacked
``ys``, as ``lax.scan`` does. When every carry leaf is a tensor and the
scan is longer than two chunks, it runs in chunks of ``CHUNK`` steps on
static buffers: the first chunk steps eagerly (the warm-up), then one
chunk of steps is recorded, reading its ``x`` from a static ``[CHUNK,
...]`` input and writing its ``y`` into a static output, and its last
carry copied back into the static carry; each later whole chunk copies its
inputs in, runs the recording and copies its outputs out; the last
partial chunk steps eagerly. On CUDA the recording is a CUDA graph,
captured once (a capture runs nothing) and replayed a chunk; on the CPU it
is the same function run eagerly, so the CPU tests run the bookkeeping
that the card replays. Every step is the same ops on the same values
either way: integer steps give the same bits eagerly and replayed.

A step may write a carry leaf in place (a model's tables) and return it,
or return a new tensor, which is copied into the leaf's static buffer at
the end of a chunk. A new leaf must not be a view of another carry leaf.
A carry with a Python number among its leaves (a step count) steps
eagerly throughout.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["scan", "CHUNK"]

CHUNK = 64  # steps a recorded chunk


def scan(step: Callable, carry: tuple, xs: tuple, reverse: bool = False):
    """``step(carry, x) -> (carry, y)``; ``carry`` a tuple of tensors (or
    numbers), ``xs`` a non-empty tuple of ``[T, ...]`` tensors, ``y`` a
    tuple of tensors. Returns (carry, ys), each of ``ys`` ``[T, ...]``;
    T must be at least 1."""
    n = xs[0].shape[0]
    ys_full: list = []

    def eager(lo: int, hi: int) -> None:
        nonlocal carry
        for t in range(hi - 1, lo - 1, -1) if reverse else range(lo, hi):
            carry, y = step(carry, tuple(x[t] for x in xs))
            if not ys_full:
                ys_full.extend(v.new_empty((n, *v.shape)) for v in y)
            for full, v in zip(ys_full, y):
                full[t].copy_(v)

    k = CHUNK
    if n <= 2 * k or not all(isinstance(c, torch.Tensor) for c in carry):
        eager(0, n)
        return carry, tuple(ys_full)
    # chunk starts in scan order; the first steps eagerly, the tail is the
    # positions no whole chunk covers
    starts = [n - k * (i + 1) for i in range(n // k)] if reverse else [k * i for i in range(n // k)]
    tail = (0, n % k) if reverse else (n - n % k, n)
    eager(starts[0], starts[0] + k)
    static = tuple(c.clone() for c in carry)
    xs_in = tuple(x[:k].clone() for x in xs)
    ys_out = tuple(full[:k].clone() for full in ys_full)

    def chunk() -> None:
        c = static
        for j in range(k - 1, -1, -1) if reverse else range(k):
            c, y = step(c, tuple(x[j] for x in xs_in))
            for out, v in zip(ys_out, y):
                out[j].copy_(v)
        for s, v in zip(static, c):
            if v is not s:
                s.copy_(v)

    run = chunk
    if static[0].is_cuda:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chunk()
        run = graph.replay
    for lo in starts[1:]:
        for buf, x in zip(xs_in, xs):
            buf.copy_(x[lo:lo + k])
        run()
        for full, out in zip(ys_full, ys_out):
            full[lo:lo + k].copy_(out)
    carry = static
    eager(*tail)
    return carry, tuple(ys_full)

"""The LM coding step as a CUDA graph: captured once, replayed a step.

Stands for ``lac_tpu``'s jitted scans of coding steps: the segment scans
``_seg_intervals`` and ``_seg_decode`` (``lac_tpu/runtime/lm_engine.py``
:360-372, :539-554) and the whole-block scans ``_encode_intervals``
(:49-68) and ``_decode_scan`` (:265-286). There XLA compiles a run of
steps into one program; here one step is captured per (lanes, cache
width, direction) and the host launches one replay a step, where an eager
step launches some 800-1,000 small kernels (PERF.md section 5).

A runner holds one coding call's static state: the previous tokens, the
device index ``t`` of the position the next step codes, the block's
symbols and the outputs ``[B, T]``, and its graphs; the cache's cursor
``pos`` is a device tensor too (``models/transformer.py``; under kv8 the
cache holds four buffers, all captured). A step reads only these tensors
and the parameters: the model step and the integer CDF
(``_step_cdf``), then the direction's tail, which codes position ``t`` from
the CDF (``SegIntervals``: its interval, ``gather_intervals``;
``SegDecode``: its symbol, ``_decode_step``), writes it at column ``t``
and advances ``t``; the model step wrote the cache at ``pos`` and advanced
``pos``. No value a step reads is a host number that changes from step to
step, so one graph serves every position at its width.

On CUDA the first step at each cache width runs eagerly on the runner's
capture stream: the warm-up sets up the lazy state of that stream (cuBLAS's
workspace among it) and codes its position like any other step. The graph
is captured right after it (a capture runs nothing) and replayed for the
width's later steps. On the CPU every step runs eagerly. The encoder and
the decoder run the same schedule, so the same positions run eagerly and
the rest replay graphs of the same ops at the same shapes: the
determinism contract of ``lm_engine.py`` carried over. A capture or replay
that fails raises; nothing falls back to eager steps.

Under det8 a step is the det8 forward with ``quantize_logits(det=True)``
and captures and replays like a float step (its RoPE tables are a device
tensor that the step gathers from). det8's encoder does not step:
``SegChunks`` codes up to ``DET_ENCODE_CHUNK`` positions a forward,
eagerly, and gives the serial steps' intervals bit for bit, since det8's
logits do not depend on how the positions are split (``lac_tpu``'s
chunked encode, ``lm_engine.py:72-154``).
"""

from __future__ import annotations

import torch

from ..coder.vector import _decode_step, rans_decode_init
from ..models.transformer import LMConfig, Transformer, forward, index_write
from ..ops.quantize import cdf_from_freq, gather_intervals, quantize_logits

__all__ = ["SegIntervals", "SegChunks", "SegDecode", "DET_ENCODE_CHUNK"]

DET_ENCODE_CHUNK = 128  # positions a forward of det8's encode (lac_tpu's :85)


def _step_cdf(cfg: LMConfig, params: Transformer, cache: dict, prev: torch.Tensor,
              prob_bits: int):
    """One lock-step model step: prev tokens [B] -> (cdf [B, V+1], cache)."""
    logits, cache = forward(cfg, params, prev[:, None], cache)
    return cdf_from_freq(quantize_logits(logits[:, 0, :], prob_bits, det=cfg.det8)), cache


class _Runner:
    """The static state of one coding call (module docstring) and its
    graphs, keyed by cache width. ``symbols`` [B, T] int64: the block's
    tokens, known (encoder) or decoded so far (decoder); ``cdf``: the last
    step's CDF (after a replay, the graph's output tensor)."""

    symbols: torch.Tensor

    def __init__(self, cfg: LMConfig, params: Transformer, prob_bits: int, lanes: int):
        self.cfg, self.params, self.prob_bits, self.lanes = cfg, params, prob_bits, lanes
        self.device = params.embed.device
        self.prev = torch.full((lanes,), cfg.bos_id, dtype=torch.int64, device=self.device)
        self.t = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.cdf = None
        self._graphs: dict[int, tuple[dict, torch.cuda.CUDAGraph, torch.Tensor]] = {}
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def code(self, cdf: torch.Tensor) -> None:
        """Code position ``t`` from ``cdf`` [B, V+1] and advance ``t``."""
        raise NotImplementedError

    def _step(self, cache: dict) -> None:
        self.cdf, _ = _step_cdf(self.cfg, self.params, cache, self.prev, self.prob_bits)
        self.code(self.cdf)

    def steps(self, cache: dict, n: int) -> None:
        """Run ``n`` steps on ``cache`` from the current position. A width
        keeps the cache its graph was captured on."""
        if self._stream is None:
            for _ in range(n):
                self._step(cache)
            return
        if n <= 0:
            return
        width = cache["k"].shape[2]
        entry = self._graphs.get(width)
        if entry is None:
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                self._step(cache)  # the warm-up codes its position
            eager_cdf = self.cdf
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                self._step(cache)  # recorded, not run: self.cdf is the graph's output
            cur.wait_stream(self._stream)
            entry = self._graphs[width] = (cache, graph, self.cdf)
            self.cdf = eager_cdf
            n -= 1
        elif entry[0] is not cache:
            raise ValueError(f"the step at cache width {width} was captured on another cache")
        for _ in range(n):
            entry[1].replay()
            self.cdf = entry[2]


class SegIntervals(_Runner):
    """The encode direction (``lac_tpu``'s ``_seg_intervals``): each
    position's coding interval into ``lo`` and ``f`` [B, T] int32."""

    def __init__(self, cfg: LMConfig, params: Transformer, prob_bits: int,
                 tokens: torch.Tensor):
        super().__init__(cfg, params, prob_bits, tokens.shape[0])
        self.symbols = tokens
        self.lo = torch.zeros(tokens.shape, dtype=torch.int32, device=self.device)
        self.f = torch.zeros_like(self.lo)

    def code(self, cdf: torch.Tensor) -> None:
        tok = self.symbols.index_select(1, self.t)  # [B, 1]
        lo, f = gather_intervals(cdf, tok[:, 0])
        index_write(self.lo, 1, self.t, lo[:, None])
        index_write(self.f, 1, self.t, f[:, None])
        self.prev.copy_(tok[:, 0])
        self.t += 1


class SegChunks(SegIntervals):
    """det8's encode (``lac_tpu``'s ``_chunk_intervals`` and
    ``_seg_intervals_chunked``, :88-128): a run of n positions in chunks of
    up to ``chunk``, each one cached forward of ``[prev | tokens[:, i : i +
    m - 1]]`` that gives every position's interval at once. det8's logits
    do not depend on how the positions are split, so a chunk gives the
    intervals of its m serial steps (the decoder's) bit for bit. Under
    slide, chunks also end at the ring's boundaries, so that no write
    wraps. A chunk runs eagerly; ``code`` (a re-prime's position) is the
    encoder's."""

    def __init__(self, cfg: LMConfig, params: Transformer, prob_bits: int,
                 tokens: torch.Tensor, chunk: int = DET_ENCODE_CHUNK):
        super().__init__(cfg, params, prob_bits, tokens)
        self.chunk = chunk
        self.done = 0  # positions coded, on the host

    def code(self, cdf: torch.Tensor) -> None:
        super().code(cdf)
        self.done += 1

    def steps(self, cache: dict, n: int) -> None:
        ring = cache["k"].shape[2] if self.cfg.slide else 0
        end = self.done + n
        while self.done < end:  # under slide the cursor is pos % ring, pos == done
            m = min(self.chunk, end - self.done)
            if ring:
                m = min(m, ring - self.done % ring)
            self._chunk(cache, m)

    def _chunk(self, cache: dict, m: int) -> None:
        t0 = self.done
        seg = self.symbols[:, t0 : t0 + m]
        inp = torch.cat([self.prev[:, None], seg[:, :-1]], dim=1)
        logits, _ = forward(self.cfg, self.params, inp, cache)
        cdf = cdf_from_freq(quantize_logits(logits, self.prob_bits, det=True))
        lo, f = gather_intervals(cdf, seg)
        self.lo[:, t0 : t0 + m] = lo
        self.f[:, t0 : t0 + m] = f
        self.prev.copy_(seg[:, -1])
        self.t += m
        self.done += m


class SegDecode(_Runner):
    """The decode direction (``lac_tpu``'s ``_seg_decode``): each position's
    symbol into ``symbols`` [B, T] int64 (0 past a lane's length)."""

    def __init__(self, cfg: LMConfig, params: Transformer, prob_bits: int,
                 words: torch.Tensor, lengths: torch.Tensor, t_len: int):
        super().__init__(cfg, params, prob_bits, words.shape[0])
        self.state = rans_decode_init(words)
        self.lengths = lengths
        self.symbols = torch.zeros((self.lanes, t_len), dtype=torch.int64, device=self.device)

    def code(self, cdf: torch.Tensor) -> None:
        sym, state = _decode_step(self.state, cdf, self.prob_bits, self.t < self.lengths)
        self.state.x.copy_(state.x)
        self.state.pos.copy_(state.pos)
        index_write(self.symbols, 1, self.t, sym[:, None])
        self.prev.copy_(sym)
        self.t += 1

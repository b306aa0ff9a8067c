"""Classical adaptive predictors (host-side correctness oracles + the
CPU-runnable coding path of BASELINE config #1).

Ports ``lac_tpu/models/classical.py`` (:41-194), a copy: pure integer
Python on the host in both packages.

Capability parity with the reference's model zoo (arith_code.py:364-522):

- ``CountsPredictor``  — adaptive base with cached distribution
                         (ProbPredictor capability, arith_code.py:111-135).
- ``AdaptiveOrder0``   — Laplace-smoothed symbol counts (the natural
                         completion of the reference's uniform-prob default).
- ``HistoryRL``        — run-length history-match model
                         (History, arith_code.py:364-398).
- ``MarkovMix``        — mixture-of-orders n-gram model
                         (Markov_up_to_n, arith_code.py:443-464).
- ``FSMPredictor``     — finite-state model (NFA, arith_code.py:423-434,
                         with the broken-initialization defect SURVEY.md
                         §2.6.4 fixed: state is constructed properly here).

The reference's ``PMarkov``/``ModifiedMarkov`` stubs (arith_code.py:437-441,
468-522) are deliberately superseded by ``MarkovMix`` with per-order counts
rather than replicated as stubs.

All models expose integer cumulative counts via ``freq_cdf`` and are fully
deterministic across platforms (pure integer state).
"""

from __future__ import annotations

from typing import Callable, Sequence

from .base import CDFBackedPredictor

__all__ = [
    "CountsPredictor",
    "AdaptiveOrder0",
    "HistoryRL",
    "MarkovMix",
    "FSMPredictor",
]


class CountsPredictor(CDFBackedPredictor):
    """Adaptive base: subclasses provide per-symbol weights; the cumulative
    CDF is rebuilt lazily and invalidated on ``accept``."""

    def __init__(self, n: int):
        super().__init__(n)
        self._cdf_cache: tuple[int, Sequence[int]] | None = None

    def weight(self, symbol: int) -> int:
        return 1

    def weights(self) -> list[int]:
        return [self.weight(s) for s in range(self.n)]

    def freq_cdf(self) -> Sequence[int]:
        c = self._cdf_cache
        if c is not None and c[0] == self._epoch:
            return c[1]
        acc = 0
        cdf = []
        for w in self.weights():
            if w <= 0:
                raise ValueError("model produced non-positive weight")
            acc += w
            cdf.append(acc)
        self._cdf_cache = (self._epoch, cdf)
        return cdf


class AdaptiveOrder0(CountsPredictor):
    """Order-0 adaptive byte/symbol model: count(s) + 1 (Laplace)."""

    def __init__(self, n: int = 256, inc: int = 1):
        super().__init__(n)
        self.inc = inc
        self.counts = [0] * n

    def weights(self) -> list[int]:
        return [c + 1 for c in self.counts]

    def accept(self, symbol: int) -> None:
        self.counts[symbol] += self.inc
        self._invalidate()

    def copy(self) -> "AdaptiveOrder0":
        p = AdaptiveOrder0(self.n, self.inc)
        p.counts = list(self.counts)
        return p


class HistoryRL(CountsPredictor):
    """Run-length history matcher: for each lag into a circular buffer of
    recent symbols, measure how long the current suffix matches the sequence
    at that lag, and boost the symbol that followed the matching context by
    ``score(run, lag)``. A cheap LZ-flavored adaptive model (capability of
    reference History, arith_code.py:364-398)."""

    def __init__(
        self,
        n: int,
        window: int = 256,
        score: Callable[[int, int, int, int], int] = lambda r, lag, n, w: n * r**3 + 1,
    ):
        super().__init__(n)
        self.window = window
        self.score = score
        self.buf = [-1] * window
        self.head = 0  # next write position

    def weights(self) -> list[int]:
        w = [1] * self.n
        m = self.window
        buf = self.buf
        for lag in range(m):
            cand = buf[(self.head - 1 - lag) % m]
            if cand < 0:
                continue
            run = 0
            for j in range(1, m - lag):
                if buf[(self.head - 1 - lag - j) % m] != buf[(self.head - j) % m]:
                    break
                run += 1
            w[cand] += self.score(run, lag, self.n, m)
        return w

    def accept(self, symbol: int) -> None:
        self.buf[self.head] = symbol
        self.head = (self.head + 1) % self.window
        self._invalidate()

    def copy(self) -> "HistoryRL":
        p = HistoryRL(self.n, self.window, self.score)
        p.buf = list(self.buf)
        p.head = self.head
        return p


class MarkovMix(CountsPredictor):
    """Mixture of n-gram orders: weight(s) = 1 + sum over orders o<=order of
    ``score(count(context_o + s), o)`` (capability of reference
    Markov_up_to_n, arith_code.py:443-464)."""

    def __init__(
        self,
        n: int,
        order: int,
        score: Callable[[int, int, int, int], int] = lambda c, o, n, m: c * n * o**3,
    ):
        super().__init__(n)
        self.order = order
        self.score = score
        self.table: dict[tuple, int] = {}
        self.context: tuple = ()

    def weight(self, symbol: int) -> int:
        key = self.context + (symbol,)
        total = 1
        for o in range(len(self.context) + 1):
            total += self.score(self.table.get(key[-o - 1 :], 0), o, self.n, self.order)
        return total

    def accept(self, symbol: int) -> None:
        key = self.context + (symbol,)
        for o in range(len(key)):
            k = key[-o - 1 :]
            self.table[k] = self.table.get(k, 0) + 1
        self.context = key[-self.order :] if self.order else ()
        self._invalidate()

    def copy(self) -> "MarkovMix":
        p = MarkovMix(self.n, self.order, self.score)
        p.table = dict(self.table)
        p.context = self.context
        return p


class FSMPredictor(CountsPredictor):
    """Finite-state model: each state carries (weights, transition table).
    ``transitions[state] = (weights[n], next_state[n])``."""

    def __init__(self, n: int, transitions: Sequence[tuple[Sequence[int], Sequence[int]]], state: int = 0):
        super().__init__(n)
        self.transitions = transitions
        self.state = state

    def weights(self) -> list[int]:
        return list(self.transitions[self.state][0])

    def accept(self, symbol: int) -> None:
        self.state = self.transitions[self.state][1][symbol]
        self._invalidate()

    def copy(self) -> "FSMPredictor":
        return FSMPredictor(self.n, self.transitions, self.state)

"""PPM: prediction by partial matching over a count trie.

Ports ``lac_tpu/models/ppm.py`` (:29-85), a copy: exact integer weights
on the host in both packages.

This completes — rather than replicates — the reference's abandoned
``ModifiedMarkov`` count-trie model (arith_code.py:468-522, marked
``#incomplete``: its ``est_prob`` computes nothing and ``get_dist`` returns a
placeholder). The trie update it did implement (arith_code.py:508-516) is
the same structure kept here; prediction is real PPM method-C blending:

    p(s) = sum over orders k = K..0 of  [ prod_{j>k} esc_j ] * c_k(s)/(T_k+d_k)
           + [ prod_j esc_j ] * 1/n                      (uniform ground floor)

with ``esc_k = d_k/(T_k+d_k)`` (method C: escape mass = distinct-symbol
count). All terms are put over the common denominator
``n * prod_k (T_k + d_k)`` so the weights are **exact integers** — no
floats anywhere, hence bit-identical across platforms (the determinism
contract, SURVEY.md §2.5). The coder rescales the bignum CDF into its live
width with a >=1 floor (ops.quantize.rescale_cdf), which implements PPM's
"every symbol codable" requirement without explicit escape symbols in the
bitstream.
"""

from __future__ import annotations

from .classical import CountsPredictor

__all__ = ["PPM"]


class PPM(CountsPredictor):
    """Order-``order`` PPM-C with integer blending (no escape symbols in the
    stream; escapes become mixture weights)."""

    def __init__(self, n: int = 256, order: int = 3):
        super().__init__(n)
        if order < 0:
            raise ValueError("order must be >= 0")
        self.order = order
        # tables[k]: context tuple (len k) -> {symbol: count}; k=0 context ()
        self.tables: list[dict[tuple, dict[int, int]]] = [
            {} for _ in range(order + 1)
        ]
        self.history: list[int] = []

    def weights(self) -> list[int]:
        n = self.n
        num = [0] * n
        carry = 1  # product of escape numerators so far
        denom = 1  # product of (T_k + d_k) so far
        # highest order first; unseen contexts pass through (esc = 1)
        for k in range(min(self.order, len(self.history)), -1, -1):
            ctx = tuple(self.history[len(self.history) - k :])
            counts = self.tables[k].get(ctx)
            if not counts:
                continue
            t = sum(counts.values())
            d = len(counts)
            scale = t + d
            # bring existing numerators to the new common denominator
            for s in range(n):
                num[s] *= scale
            for s, c in counts.items():
                num[s] += carry * c
            carry *= d
            denom *= scale
        # uniform ground floor: remaining escape mass spread over n symbols
        return [x * n + carry for x in num]

    def accept(self, symbol: int) -> None:
        h = self.history
        for k in range(0, min(self.order, len(h)) + 1):
            ctx = tuple(h[len(h) - k :])
            tbl = self.tables[k].setdefault(ctx, {})
            tbl[symbol] = tbl.get(symbol, 0) + 1
        h.append(symbol)
        if len(h) > self.order:
            del h[: len(h) - self.order]
        self._invalidate()

    def copy(self) -> "PPM":
        p = PPM(self.n, self.order)
        p.tables = [
            {ctx: dict(cnt) for ctx, cnt in tbl.items()} for tbl in self.tables
        ]
        p.history = list(self.history)
        return p

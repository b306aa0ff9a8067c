"""Text files for the byte alphabet, cut from a pinned data file: the
``i``-th call codes ``file_bytes`` bytes at ``base + i * stride`` (taken
round the end of the data), where ``base`` is drawn from the seed. Every
seed codes files of one size, in one rhythm, at its own offsets: with
``stride`` equal to ``file_bytes`` the calls tile the data from the seed's
offset on, and with a stride that is not a divisor of the data's length
they sample it all over.

Traffic keys: ``data`` (``path`` under the checkout and its ``sha256``),
``file_bytes``, ``stride``; ``coding``, the file API's arguments.
"""

from __future__ import annotations

import numpy as np

from harness.manifest import pinned


class TextFiles:
    alphabet = "bytes"

    def __init__(self, data: bytes, file_bytes: int, stride: int, seed: int):
        if not 0 < file_bytes <= len(data):
            raise ValueError(f"{len(data)} bytes hold no file of {file_bytes}")
        self.data, self.file_bytes, self.stride = data, file_bytes, stride
        self.base = int(np.random.default_rng([seed, 0x7E47]).integers(len(data)))

    def key(self, i: int) -> int:
        """The offset in the data of the ``i``-th call's file."""
        return (self.base + i * self.stride) % len(self.data)

    def item(self, i: int) -> bytes:
        at = self.key(i)
        end = at + self.file_bytes
        if end <= len(self.data):
            return self.data[at:end]
        return self.data[at:] + self.data[: end - len(self.data)]

    def symbols(self, item) -> int:
        return len(item)

    def nbytes(self, item) -> int:
        return len(item)


def make(traffic: dict, ctx) -> TextFiles:
    spec = traffic["data"]
    data = pinned(ctx.cell.root, spec["path"], spec["sha256"]).read_bytes()
    return TextFiles(data, traffic["file_bytes"], traffic["stride"], ctx.seed)

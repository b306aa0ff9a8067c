"""Fixtures of the benchmark's tests: the harness on ``sys.path``, a
throwaway checkout holding a copy of the benchmark beside the program, and
the card, looked for inside a fixture.

Run from the root of the repository: ``python -m pytest benchmark/tests``
(the CPU tests), and on the card ``python -m pytest -m gpu benchmark/tests``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small byte cell that runs on the CPU: the shipped checkpoint, 4 lanes of 64
TINY_TRAFFIC = {"kind": "text_files",
                "data": {"path": "benchmark/data/heldout_slice.bin",
                         "sha256": "7198dd6de1ddd7b8c96283b4a7041359e6800bb90e5d6e203825ac284e8717d7"},
                "file_bytes": 256, "stride": 256, "coding": {"block_tokens": 64, "lanes": 4}}
TINY_SETTINGS = {"sample_calls": 2, "reference_rows": 4,
                 "limits": {"gap_mean_bits": {"max": 0.5}},
                 "control": {"kind": "reference", "quant": {"weight_bits": 4, "kv_bits": 4}}}


class Checkout:
    """A directory laid out as a checkout: ``BENCHMARK.json`` and a copy of
    ``benchmark/``, with the program and the byte checkpoint linked in."""

    def __init__(self, root: Path):
        self.root = root
        shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
        shutil.copytree(BENCH, root / "benchmark",
                        ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
        (root / "checkpoints").mkdir()
        os.symlink(ROOT / "checkpoints" / "byte16l-pysrc.npz",
                   root / "checkpoints" / "byte16l-pysrc.npz")
        os.symlink(ROOT / "lac_tpu_torch", root / "lac_tpu_torch")

    @property
    def bench(self) -> Path:
        return self.root / "benchmark"

    def manifest(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def add_cell(self, name: str, config: str, traffic: str, traffic_spec: dict,
                 settings: dict) -> None:
        """A new cell as files and entries only."""
        m = self.manifest()
        m["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a throwaway cell of the tests"})
        (self.root / "BENCHMARK.json").write_text(json.dumps(m))
        (self.bench / "traffic" / f"{traffic}.json").write_text(json.dumps(traffic_spec))
        (self.bench / "workloads" / f"{name}.json").write_text(json.dumps(settings))

    def add_metric(self, kind: str, entry: dict, source: str) -> None:
        m = self.manifest()
        m[kind].append(entry)
        (self.root / "BENCHMARK.json").write_text(json.dumps(m))
        folder = "end_to_end" if kind == "end_to_end" else "layer_metrics"
        (self.bench / folder / f"{entry['name']}.py").write_text(source)


@pytest.fixture
def checkout(tmp_path) -> Checkout:
    return Checkout(tmp_path)


@pytest.fixture
def tiny(checkout) -> Checkout:
    """A checkout with the tiny byte cell ``tiny.files``."""
    checkout.add_cell("tiny.files", "byte16l-pysrc", "tiny_files", TINY_TRAFFIC, TINY_SETTINGS)
    return checkout


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

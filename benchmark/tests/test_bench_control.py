"""On the card: each cell's control, put in the program's place, comes out
not correct, and the program on the same seeds comes out correct (a short
window at the cell's own load, ``check_seconds`` in ``workloads/<cell>.json``:
long enough for as many files as a run compares; each run is a process of
its own, as the benchmark's are).

    python -m pytest -m gpu benchmark/tests/test_bench_control.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _run(cell: str, seed: int, control: int) -> dict:
    seconds = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())[
        "check_seconds"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", "0", "--control",
                          str(control)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell, seed):
    program = _run(cell, seed, 0)
    control = _run(cell, seed, 1)
    for side, r in (("program", program), ("control", control)):
        print(f"{cell} {seed} {side} correct={r['correct']} "
              + " ".join(f"{k}={v['value']}" for k, v in r["checks"].items()))
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]

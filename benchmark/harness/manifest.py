"""Find everything a cell names, by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``), its
own settings (``workloads/<cell>.json``), the metrics it reports and the
files that compute them (``end_to_end/<metric>.py``,
``layer_metrics/<metric>.py``), the generator of its traffic's kind
(``generators/<kind>.py``) and the reference of its model's family
(``reference/<family>.py``). Adding any of these is adding files and
entries; this module names none of them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    root: Path            # the checkout: BENCHMARK.json's directory
    bench: Path           # the benchmark's own directory
    entry: dict           # the cell's entry in BENCHMARK.json
    config: dict          # its configuration file
    traffic: dict         # its traffic mix
    settings: dict        # workloads/<cell>.json: the comparison's sample, limits, control,
                          # and the short window (check_seconds) of the control test
    end_to_end: list      # the BENCHMARK.json entries of the metrics it reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def coding(self) -> dict:
        return self.traffic["coding"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Path = BENCH_DIR) -> Cell:
    root = bench.parent
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    settings = json.loads((bench / "workloads" / f"{name}.json").read_text())
    return Cell(name, root, bench, entry, config, traffic, settings,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def load_module(path: Path):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    key = f"_bench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(cell: Cell, kind: str, metric: str):
    """The module that computes ``metric``: ``end_to_end/`` or
    ``layer_metrics/``."""
    return load_module(cell.bench / kind / f"{metric}.py")


def generator(cell: Cell):
    return load_module(cell.bench / "generators" / f"{cell.traffic['kind']}.py")


def family(cell: Cell):
    """The plain reference of the configuration's family, imported as a
    module of the ``reference`` package."""
    if str(cell.bench) not in sys.path:
        sys.path.insert(0, str(cell.bench))
    return importlib.import_module(f"reference.{cell.config['family']}")


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def pinned(root: Path, rel: str, digest: str) -> Path:
    """``root / rel``, refused unless its sha256 is ``digest``."""
    path = root / rel
    if not path.is_file():
        raise FileNotFoundError(f"{rel}: missing from the checkout")
    got = sha256(path)
    if got != digest:
        raise ValueError(f"{rel}: sha256 {got}, the benchmark pins {digest}")
    return path

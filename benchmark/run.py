"""The benchmark of lac_tpu_torch: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic,
metrics and limits are found by name (``harness/manifest.py``). The last
line of standard output is the result, one JSON object; the numbers that
decide ``correct`` are also the last lines of standard error. Exits with
another code than 0, and prints no result, without a CUDA device, when a
pinned input is missing or altered, or when JAX or the JAX package was
loaded. ``--control 1`` puts the cell's control (``workloads/<cell>.json``)
in the program's place in the comparison, to show that it comes out not
correct; the benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import manifest, runner

    cell = manifest.load_cell(args.workload, BENCH)
    runner.cache_dirs(cell.root)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                        control=bool(args.control))
    found = runner.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

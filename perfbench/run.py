#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; ``checks`` last).
The last lines of standard error are the numbers compared, each beside
its limit.  Without a CUDA card, or with fewer than the cell asks for,
the run fails and prints no result.
"""
import time

T0 = time.perf_counter()   # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import harness
    try:
        bench = harness.Bench(ROOT)
        cell = bench.cell(args.workload)
    except harness.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    try:
        result = harness.execute(bench, args.workload, args.seed,
                                 args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), t0=T0)
    except harness.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()   # the window has closed
    if found:
        print(f"perfbench: this process loaded {', '.join(found)}; the "
              f"port must run without JAX or the JAX package",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        limit = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        print(f"check {name} {c['value']} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

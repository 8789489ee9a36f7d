"""Readings that set a cell's limits; not part of a benchmark run.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--control int8] [--seconds 3]

For each seed, in one process, the cell's loop runs a short window at the
cell's own load and sizes and prints the numbers it compares: with the
program as the configuration states it (the lower readings), or with
``--control`` (``int8``: the program's own int8 path, the precision below
bf16) in its place (the upper readings).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--override", action="append", default=[], metavar="KEY=JSON",
                    help="a configuration key for the program and the reference alike, e.g. compute_dtype='\"float32\"'")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    traffic = harness.load_json("traffic", cell["traffic"])
    cfg = harness.run_config(harness.load_json("configs", cell["config"]), traffic)
    cfg.update({k: json.loads(v) for k, v in (o.split("=", 1) for o in args.override)})
    limits = harness.load_json("limits", cell["name"])
    loop = harness.load_loop(traffic["loop"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = loop.run(cell, cfg, traffic, seed, args.seconds, False, time.perf_counter(), limits,
                       control=args.control)
        print(json.dumps({"seed": seed, "control": args.control, "e2e": out.e2e, "failed": out.failed,
                          "readings": {c.name: c.value for c in out.checks}, "diagnostics": out.diagnostics,
                          "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of the PyTorch and CUDA port, one cell per run:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the mix names its loop kind. The run makes its
inputs and weights from the seed, warms up the cell's shapes, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, ``breakdown`` when traced, and last
``checks``: each number compared beside its limit, also printed as the last
lines of standard error.
"""

import time

T0 = time.perf_counter()  # process start, as near as Python gets: set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(metrics, trace):
    from benchmark.harness import load_reader

    out = {}
    for m in metrics:
        value = load_reader(m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    harness.set_cache_dirs()
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    cfg = harness.run_config(harness.load_json("configs", cell["config"]), traffic := harness.load_json(
        "traffic", cell["traffic"]))
    limits = harness.load_json("limits", cell["name"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    e2e_metrics, layer_metrics = harness.cell_metrics(bench, cell["name"])
    loop = harness.load_loop(traffic["loop"])
    outcome = loop.run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), T0, limits)

    found = harness.forbidden_loaded()
    if found:
        print(f"modules of the JAX side are loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(outcome.memory_peak)}
    line = {"attempted": outcome.attempted, "failed": outcome.failed}
    finite = all(math.isfinite(outcome.e2e[m["name"]]) for m in e2e_metrics)
    if args.trace:
        tr = outcome.trace
        line["metrics"] = per_layer(layer_metrics, tr)
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        print(json.dumps({"kernel_launches_in_window": tr.launches,
                          "range_kernels": tr.range_kernels, "range_device_s": tr.range_device_s}), flush=True)
        line["breakdown"] = {"device_ops": [[n, s] for n, s in tr.device_ops],
                             "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    else:
        line["metrics"] = {m["name"]: {"value": outcome.e2e[m["name"]] if finite else None, "unit": m["unit"]}
                           for m in e2e_metrics}
    line["device"] = device
    line["correct"] = bool(finite and outcome.failed == 0 and all(c.ok for c in outcome.checks))
    line["diagnostics"] = dict(outcome.diagnostics, card=harness.card_line())
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None, "limit": c.limit}
                      for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({"correct": line.pop("correct"), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

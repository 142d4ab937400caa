"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the checkout's root; its configuration, traffic mix, runner
and per-layer metric readers by the names there (portbench/core/registry.py). The program under test is
``uniception_tpu_torch``. A run needs CUDA cards (as many as the cell asks for): without them it exits with
code 3 and prints no result. With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, the device's busy and window seconds of a traced window, and a breakdown.
The last lines of standard error, and the result line's last key ``checks``, give each number compared with
the plain reference beside its limit.
"""

import time

T_START = time.perf_counter()  # set-up is measured from here, before any heavy import

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench.core.guards import forbidden_loaded, pin_cache_dirs  # noqa: E402

__all__ = ["main", "result_line", "layer_metrics"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    return args


def layer_metrics(cell, record) -> dict:
    "Every per-layer metric of the cell that its reader finds something to read for, by name."
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, record, trace: bool, correct: bool, checks: dict) -> dict:
    "The result line's object, ``checks`` last."
    from portbench.core.device import describe

    import torch

    if trace:
        metrics = layer_metrics(cell, record)
    else:
        metrics = {m["name"]: {"value": record.end_to_end[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": correct, "attempted": record.attempted, "failed": record.failed, "metrics": metrics,
            "device": describe(torch, cell.chips, record.peak_bytes)}
    if trace:
        line["device"].update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
        line["breakdown"] = record.trace.breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    pin_cache_dirs(CHECKOUT)
    from portbench.core.compare import judge, print_checks
    from portbench.core.device import require_cards
    from portbench.core.record import RunContext
    from portbench.core.registry import Cell

    import torch

    cell = Cell(args.workload, CHECKOUT / "BENCHMARK.json")
    require_cards(torch, cell.chips)
    ctx = RunContext(torch=torch, cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), t_start=T_START)
    record = cell.runner().run(ctx)
    correct, checks = judge(record.values, cell.limits)
    line = result_line(cell, record, bool(args.trace), correct, checks)
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded modules it may not hold: {loaded}", file=sys.stderr)
        return 4
    print(f"portbench: {json.dumps(record.notes)}", file=sys.stderr)
    print_checks(checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set a cell's limits: the numbers the check compares, for the program on many seeds and for the
control on a few, in one process on the card.

    python3 portbench/control.py --workload <name> --seeds 11,12,... --control-seeds 21,22,23 --seconds 3
    python3 portbench/control.py --workload <name> --fault half_batch_mean --fault-seeds 31,32,33

The control is the program with its own lower-precision path switched on (for DUSt3R: the int8 trunk, one rung
below the configured bf16 trunk); a limit holds only between the program's largest reading and the control's
smallest. A fault of portbench/faults.py, planted in the program, gives a training number's other upper reading.
Each run drives the cell's traffic for ``--seconds`` and compares as many pairs as a benchmark run
does. One JSON line per run goes to standard output; the benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench.core.guards import pin_cache_dirs  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(torch, cell, seed: int, seconds: float, control: bool, device, fault=None) -> dict:
    "One run of the cell's runner, without the trace; the numbers compared and the rate, as a dict."
    from portbench.core.record import RunContext
    from portbench.faults import SERVING, TRAINING

    plant = {**SERVING, **TRAINING}[fault] if fault else None
    ctx = RunContext(torch=torch, cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                     t_start=time.perf_counter(), control=control, fault=plant)
    record = cell.runner().run(ctx)
    path = fault or ("control" if control else "program")
    out = {"seed": seed, "path": path, **record.values, "units_per_s": record.units / record.window_s}
    del record
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None, help="a fault of portbench/faults.py planted in the program's runs")
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    pin_cache_dirs(CHECKOUT)
    from portbench.core.device import require_cards
    from portbench.core.registry import Cell

    import torch

    cell = Cell(args.workload, CHECKOUT / "BENCHMARK.json")
    require_cards(torch, cell.chips)
    device = torch.device("cuda", 0)
    runs = [(False, None, args.seeds), (True, None, args.control_seeds), (False, args.fault, args.fault_seeds)]
    for control, fault, seeds in runs:
        for seed in seeds:
            out = readings(torch, cell, seed, args.seconds, control, device, fault)
            print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Finds every piece of a cell by the names ``BENCHMARK.json`` gives, so that a new configuration, traffic mix,
traffic kind, model family or per-layer metric is a new file and an entry, never an edit:

    configs/<file named by the configuration's entry>   sizes, precision, limits of the check
    traffic/<traffic>.json                               the mix: its kind and parameters
    traffic/<kind>.py                                    the runner of a kind: run(ctx) -> Record
    limits/<configuration>.<kind>.json                   the limit of each number the check compares
    models/<family>.py                                   the program's constructor, the reference's, the op counts
    layer_metrics/<metric>.py                            read(record) -> value, or None when there is nothing
"""

import importlib.util
import json
from pathlib import Path

__all__ = ["CHECKOUT", "HERE", "Cell", "load_module"]

HERE = Path(__file__).resolve().parent.parent  # portbench/
CHECKOUT = HERE.parent


def load_module(kind: str, name: str, base: Path = HERE):
    "The module ``<base>/<kind>/<name>.py`` (``base`` the benchmark's folder), loaded from its file."
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and metrics, read from ``bench_path``; the
    traffic mixes and modules come from ``base``, the benchmark's folder."""

    def __init__(self, name: str, bench_path: Path = CHECKOUT / "BENCHMARK.json", base: Path = HERE):
        if not bench_path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json at {bench_path}")
        bench = json.loads(bench_path.read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path}; known: {sorted(cells)}")
        self.name, self.entry, self.base = name, cells[name], base
        self.chips = int(self.entry["chips"])
        self.run_seconds = int(bench["run_seconds"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((bench_path.parent / self.config_entry["file"]).read_text())
        self.traffic_name = self.entry["traffic"]
        self.traffic = json.loads((base / "traffic" / f"{self.traffic_name}.json").read_text())
        self.limits = json.loads((base / "limits" / f"{self.config['name']}.{self.traffic['kind']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]

    def family(self):
        "The model family's module (``models/<family>.py``)."
        return load_module("models", self.config["family"], self.base)

    def runner(self):
        "The traffic kind's runner (``traffic/<kind>.py``)."
        return load_module("traffic", self.traffic["kind"], self.base)

    def metric_reader(self, name: str):
        "The per-layer metric's reader (``layer_metrics/<name>.py``)."
        return load_module("layer_metrics", name, self.base)

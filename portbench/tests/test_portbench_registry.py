"""Every piece of a cell is found by name: a new configuration, traffic mix, metric or cell is files and entries,
with no edit of the harness; and BENCHMARK.json keeps to its contract."""

import json
import re
import shutil
from pathlib import Path

from portbench.core.registry import CHECKOUT, HERE, Cell, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = Cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.chips == w["chips"]
        assert callable(cell.runner().run) and callable(cell.family().build_program)
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_benchmark_json_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and len(bench["command"]) <= 32
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = list(cells) + [c["name"] for c in bench["configs"]] + list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(set(pairs)) == len(pairs)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        reported = [m for m in e2e.values() if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in cells and ("workloads" not in moved or cell in moved["workloads"])


def test_new_files_are_found_without_an_edit(tmp_path: Path):
    "A copy of the benchmark with one more configuration, mix, limits, metric and cell: new files and entries."
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    cfg = json.loads((HERE / "configs" / "dust3r_vitl512_linear.json").read_text()) | {"name": "dust3r_new"}
    (base / "configs" / "dust3r_new.json").write_text(json.dumps(cfg))
    (base / "limits" / "dust3r_new.serve_closed.json").write_text(json.dumps({"pts3d_rel": 0.5}))
    mix = json.loads((HERE / "traffic" / "serve_b16.json").read_text()) | {"pairs_per_batch": 4}
    (base / "traffic" / "serve_b4.json").write_text(json.dumps(mix))
    (base / "layer_metrics" / "new.metric.py").write_text("def read(record):\n    return 42.0\n")
    bench["configs"].append({"name": "dust3r_new", "source": "s", "file": "portbench/configs/dust3r_new.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "dust3r_new.serve_b4", "config": "dust3r_new", "traffic": "serve_b4",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "pairs_per_s", "workloads": ["dust3r_new.serve_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("dust3r_new.serve_b4", tmp_path / "BENCHMARK.json", base)
    assert cell.traffic["pairs_per_batch"] == 4 and cell.config["name"] == "dust3r_new"
    assert cell.limits == {"pts3d_rel": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert cell.metric_reader("new.metric").read(None) == 42.0
    assert Path(cell.runner().__file__).parent == base / "traffic"
    old = Cell("dust3r_linear.serve_b16", tmp_path / "BENCHMARK.json", base)
    assert "new.metric" not in [m["name"] for m in old.per_layer]
    assert load_module("layer_metrics", "new.metric", base).read(None) == 42.0

"""Each cell of BENCHMARK.json for a few seconds on the card, its result line parsed. Marked ``cuda``: skips
without a card (decided in the fixture). Run on the card: ``python -m pytest portbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest

from portbench.core.registry import CHECKOUT, Cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def _cells():
    return [w["name"] for w in json.loads((CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_cell_runs_and_is_correct(card, workload):
    cmd = [sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2147483659", "--seconds", "3",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True, line
    assert line["device"]["kind"] == card and line["device"]["platform"] == "gpu"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in Cell(workload).end_to_end}

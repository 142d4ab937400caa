"""The whole-name check of forbidden modules, in a fresh process, and the refusal to run without a card."""

import json
import subprocess
import sys

from portbench.core.guards import forbidden_loaded
from portbench.core.registry import CHECKOUT


def test_top_level_names_are_compared_whole():
    mods = ["uniception_tpu_torch", "uniception_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert forbidden_loaded(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.nnx", "optax", "uniception_tpu", "uniception_tpu.ops"]
    assert forbidden_loaded(mods + bad) == sorted(bad)


def test_the_harness_and_the_program_load_no_jax():
    "Everything a run imports on the card, in a fresh process: no module of a forbidden top-level name."
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench.core.registry import Cell, load_module\n"
        "import portbench.run, portbench.control\n"
        "from portbench.core.guards import forbidden_loaded\n"
        "for name in [w['name'] for w in json.load(open(%r))['workloads']]:\n"
        "    cell = Cell(name); fam = cell.family(); cell.runner()\n"
        "    fam.launch_counters(); [cell.metric_reader(m['name']) for m in cell.per_layer]\n"
        "[load_module('traffic', k) for k in ('serve_closed', 'train_steps')]\n"
        "import uniception_tpu_torch.serve, uniception_tpu_torch.parallel.training\n"
        "print(json.dumps([forbidden_loaded(), 'uniception_tpu_torch' in sys.modules]))\n"
    ) % (str(CHECKOUT), str(CHECKOUT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.dust3r\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('uniception')))\n") % str(CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    "Without CUDA a run exits with another code than 0 and prints nothing on standard output."
    code = ("import sys, runpy; import torch; torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['run.py', '--workload', 'dust3r_linear.serve_b16', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']\n"
            "runpy.run_path(%r, run_name='__main__')\n") % str(CHECKOUT / "portbench" / "run.py")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""

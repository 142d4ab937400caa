"""The frozen reference against the program at tiny widths on the CPU, and the comparison's verdict on sound runs,
on the lower-precision control and on a timed path broken underneath."""

import time

import pytest
import torch

from portbench.core.compare import judge
from portbench.core.record import RunContext
from portbench.faults import SERVING
from portbench.tests.tiny_cells import tiny_cell

torch.set_num_threads(2)


def _run(cell, seed=2**31 + 11, control=False, fault=None):
    ctx = RunContext(torch=torch, cell=cell, seed=seed, seconds=0.3, trace=False, device=torch.device("cpu"),
                     t_start=time.perf_counter(), control=control, fault=fault)
    return cell.runner().run(ctx)


@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_reference_matches_the_program_in_fp32(head):
    "With the program's trunk in fp32 on the CPU (its plain versions), only rounding order separates the two."
    values = _run(tiny_cell(head, trunk="float32")).values
    assert values["pts3d_rel"] < 1e-5 and values["conf_rel"] < 1e-5


@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_program_passes_and_the_int8_control_does_not(head):
    cell = tiny_cell(head)
    sound = _run(cell)
    assert judge(sound.values, cell.limits)[0], sound.values
    control = _run(cell, control=True)
    assert not judge(control.values, cell.limits)[0], control.values


@pytest.mark.parametrize("fault", sorted(SERVING))
def test_a_broken_timed_path_is_not_correct(fault):
    cell = tiny_cell("linear")
    record = _run(cell, fault=SERVING[fault])
    assert not judge(record.values, cell.limits)[0]

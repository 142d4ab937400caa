"""The training runner against the plain reference's training at tiny widths on the CPU: the fp32 program agrees
to rounding, the bf16 program passes, the fp8 control does not, and a broken step is not correct."""

import time

import pytest
import torch

from portbench.core.compare import judge
from portbench.core.record import RunContext
from portbench.faults import TRAINING
from portbench.tests.tiny_cells import tiny_train_cell

torch.set_num_threads(2)


def _run(cell, control=False, fault=None, seed=2**31 + 21):
    ctx = RunContext(torch=torch, cell=cell, seed=seed, seconds=0.2, trace=False, device=torch.device("cpu"),
                     t_start=time.perf_counter(), control=control, fault=fault)
    return cell.runner().run(ctx)


def test_fp32_program_follows_the_reference():
    values = _run(tiny_train_cell(trunk="float32")).values
    assert values["loss_gap"] < 1e-5 and values["grad_gap"] < 1e-4 and values["update_gap"] < 1e-3


def test_bf16_program_passes_and_the_fp8_control_does_not():
    cell = tiny_train_cell()
    sound = _run(cell)
    assert judge(sound.values, cell.limits)[0], sound.values
    assert sound.attempted > 0 and sound.end_to_end["train_pairs_per_s"] > 0
    control = _run(cell, control=True).values
    assert not judge(control, cell.limits)[0], control


@pytest.mark.parametrize("fault", sorted(TRAINING))
def test_a_broken_step_is_not_correct(fault):
    cell = tiny_train_cell()
    record = _run(cell, fault=TRAINING[fault])
    assert not judge(record.values, cell.limits)[0], record.values

"""
The port's training entry point (``python -m uniception_tpu_torch.train``) on the CPU, as the JAX package's
tests/examples/test_train_example.py drives examples/train_dust3r.py: save then --resume equals an uninterrupted
run bit for bit, SIGTERM under --preempt-safe saves at the step boundary, exits 0 and resumes bit for bit,
--ckpt-every's asynchronous saves land and read back, a save cut short leaves the previous checkpoint, the
argument errors and the flags the port does not take, and smokes of --mixed-ar, --lora and --model flow.
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

from uniception_tpu_torch import train
from uniception_tpu_torch.parallel import training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a small model and data set on the CPU (the learning rate the default, 1e-4: the DPT heads' exp output blows up
# at 1e-3)
BASE = ["--device", "cpu", "--img", "32", "--embed-dim", "128", "--heads", "2", "--depth", "2", "--batch", "2",
        "--dataset-size", "6"]



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for these small CPU models: with one thread per core in each of the test run's
    workers, torch's spinning OpenMP threads oversubscribe the cores and every worker slows severalfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

def _state(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, training.STATE_FILE), map_location="cpu", weights_only=True)


def _assert_same_state(a, b):
    "Two train states bit for bit: every parameter, moment, accumulator and counter."
    sa, sb = _state(a), _state(b)
    assert {k: v for k, v in sa.items() if k != "tensors"} == {k: v for k, v in sb.items() if k != "tensors"}
    assert sorted(sa["tensors"]) == sorted(sb["tensors"])
    for k, v in sa["tensors"].items():
        assert v.dtype == sb["tensors"][k].dtype and torch.equal(v, sb["tensors"][k]), k


@pytest.mark.parametrize("options", [
    [],
    ["--warmup-cosine", "2", "--mu-bf16", "--clip-grad", "1.0", "--skip-nonfinite", "--grad-accum", "2"],
], ids=["constant", "warmup_cosine_mu_bf16_clip_skip_accum"])
def test_save_then_resume_equals_the_uninterrupted_run(tmp_path, capsys, options):
    """Two runs of 2 steps (the second with --resume) and one of 4: the same losses and the same train state bit
    for bit. With the warmup-cosine schedule too: its horizon is the step the run ends at, so the resumed run
    follows the uninterrupted run's rates."""
    part, whole = str(tmp_path / "part"), str(tmp_path / "whole")
    first = train.main(BASE + options + ["--steps", "2", "--ckpt-dir", part])
    second = train.main(BASE + options + ["--steps", "2", "--ckpt-dir", part, "--resume"])
    assert "resumed from" in capsys.readouterr().out
    ref = train.main(BASE + options + ["--steps", "4", "--ckpt-dir", whole])
    assert first + second == ref
    assert _state(part)["step"] == 4
    _assert_same_state(part, whole)


def test_sigterm_saves_at_the_step_boundary_and_resumes_bit_for_bit(tmp_path):
    """--preempt-safe: SIGTERM after the first step's line ends the run at a step boundary with a checkpoint
    and exit code 0; two more steps from it equal an uninterrupted run to the same step."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "uniception_tpu_torch.train", *BASE, "--steps", "400", "--preempt-safe",
         "--ckpt-every", "3", "--ckpt-dir", ckpt],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("step "):
            proc.send_signal(signal.SIGTERM)
            break
    out, err = proc.communicate(timeout=300)
    stdout = "".join(lines) + out
    assert proc.returncode == 0, err[-2000:]
    assert "preempted: saved at step" in stdout, stdout
    saved = int(stdout.split("preempted: saved at step")[1].split(";")[0])
    assert 0 < saved < 400 and _state(ckpt)["step"] == saved

    resumed = train.main(BASE + ["--steps", "2", "--ckpt-dir", ckpt, "--resume"])
    oracle = train.main(BASE + ["--steps", str(saved + 2), "--ckpt-dir", str(tmp_path / "oracle")])
    assert resumed == oracle[-2:]
    _assert_same_state(ckpt, str(tmp_path / "oracle"))


def test_ckpt_every_saves_in_the_background_and_each_lands(tmp_path, monkeypatch):
    "--ckpt-every 1: a save in a thread after steps 1-3, each whole when the next one starts, and the final one."
    ckpt = str(tmp_path / "ckpt")
    calls = []

    def recording(path, state, step=0, wait=True):
        if calls and not calls[-1][1]:  # the loop waited on the previous save before this one
            assert _state(path)["step"] == calls[-1][0]
        calls.append((step, wait))
        return training.save_train_state(path, state, step=step, wait=wait)

    monkeypatch.setattr(train, "save_train_state", recording)
    train.main(BASE + ["--steps", "4", "--ckpt-every", "1", "--ckpt-dir", ckpt, "--ema", "0.9"])
    assert calls[:4] == [(1, False), (2, False), (3, False), (4, True)]
    assert calls[4] == (4, True) and len(calls) == 5  # the EMA, beside the checkpoint
    assert _state(ckpt)["step"] == 4 and not os.path.exists(os.path.join(ckpt, training.STATE_FILE + ".tmp"))
    ema = _state(ckpt + "_ema")
    assert ema["step"] == 4 and all(k.startswith("params.") for k in ema["tensors"])


@pytest.mark.parametrize("cut", ["before_rename", "mid_write"])
@pytest.mark.parametrize("wait", [True, False], ids=["sync", "async"])
def test_a_save_cut_short_leaves_the_previous_checkpoint(tmp_path, monkeypatch, cut, wait):
    model = torch.nn.Linear(4, 3)
    ctx = training.make_train_step(model, loss_fn=lambda m, x, _, t, __: ((m(x) - t) ** 2).mean(), learning_rate=0.1)
    x, t = torch.randn(5, 4), torch.randn(5, 3)
    ctx.step(x, None, t, None)
    ckpt = str(tmp_path / "ckpt")
    training.save_train_state(ckpt, ctx, step=1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    ctx.step(x, None, t, None)

    def crash(*args, **kwargs):
        if cut == "mid_write":
            args[1].write(b"partial")
        raise OSError("the process died here")

    if cut == "before_rename":
        monkeypatch.setattr(training.os, "replace", crash)
    else:
        monkeypatch.setattr(training.torch, "save", crash)
    with pytest.raises(OSError):
        pending = training.save_train_state(ckpt, ctx, step=2, wait=wait)
        pending.wait_until_finished()
    monkeypatch.undo()

    fresh = torch.nn.Linear(4, 3)
    restored = training.make_train_step(fresh, loss_fn=ctx.loss_fn, learning_rate=0.1)
    assert training.restore_train_state(ckpt, restored) == 1
    assert all(torch.equal(v, saved[k]) for k, v in fresh.state_dict().items())
    assert restored.optimizer.count == 1


def test_restore_refuses_another_models_state(tmp_path):
    ctx = training.make_train_step(torch.nn.Linear(4, 3), loss_fn=None, learning_rate=0.1)
    training.save_train_state(str(tmp_path), ctx, step=3)
    for other in (training.make_train_step(torch.nn.Linear(4, 2), loss_fn=None, learning_rate=0.1),
                  training.make_train_step(torch.nn.Linear(4, 3), loss_fn=None, learning_rate=0.1,
                                           mu_dtype=torch.bfloat16),
                  training.make_train_step(torch.nn.Linear(4, 3), loss_fn=None, learning_rate=0.1, grad_accum=2)):
        with pytest.raises(ValueError):
            training.restore_train_state(str(tmp_path), other)


ARG_ERRORS = {
    "preempt_without_dir": (["--preempt-safe"], "requires --ckpt-dir"),
    "ckpt_every_without_dir": (["--ckpt-every", "2"], "requires --ckpt-dir"),
    "lora_and_freeze": (["--lora", "4", "--freeze-encoder"], "pick one"),
    "flow_mixed_ar": (["--model", "flow", "--mixed-ar"], "DUSt3R-specific"),
    "flow_norm_loss": (["--model", "flow", "--norm-loss"], "DUSt3R-specific"),
    "tp": (["--tp", "2"], "ROADMAP queue 1 item 12"),
    "zero1": (["--zero1"], "ROADMAP queue 1 item 12"),
    "fsdp": (["--fsdp"], "ROADMAP queue 1 item 12"),
    "scan": (["--scan"], "loop layout"),
}


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_argument_errors_before_any_model(case, capsys, monkeypatch):
    flags, message = ARG_ERRORS[case]
    monkeypatch.setattr(train, "build_model", lambda *a: pytest.fail("a model was built"))
    with pytest.raises(SystemExit) as exc:
        train.main(BASE + flags)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_preemption_guard_refuses_several_processes(tmp_path):
    guard = training.PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not guard.should_stop()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested and guard.should_stop()
        torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
        try:
            # a world of one keeps the local flag; across ranks the flags are ORed (tests/test_torch_parallel_serving.py)
            assert guard.should_stop()
        finally:
            torch.distributed.destroy_process_group()
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL


@pytest.mark.parametrize("flags,expect", [
    (["--mixed-ar", "--norm-loss", "--head", "dpt", "--head-remat", "on"], "on cpu"),
    (["--lora", "4", "--bf16"], "lora: wrapped 40 linears at rank 4"),
    (["--model", "flow", "--head", "dpt", "--remat"], "on cpu"),
], ids=["mixed_ar_dpt", "lora", "flow"])
def test_training_smokes(tmp_path, capsys, flags, expect):
    losses = train.main(BASE + flags + ["--steps", "2", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(map(torch.isfinite, torch.tensor(losses)))
    assert expect in out and "saved params+opt_state+step" in out

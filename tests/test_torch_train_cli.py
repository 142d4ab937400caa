"""
The port's training entry point (``python -m uniception_tpu_torch.train``) on the CPU, as the JAX package's
tests/examples/test_train_example.py drives examples/train_dust3r.py: save then --resume equals an uninterrupted
run bit for bit, SIGTERM under --preempt-safe saves at the step boundary, exits 0 and resumes bit for bit,
--ckpt-every's asynchronous saves land and read back, a save cut short leaves the previous checkpoint, the
argument errors and the flags the port does not take, and smokes of --mixed-ar, --lora and --model flow. Then the
sharded flags: --zero1 and --fsdp in a world of one, and under torchrun (2 gloo ranks on the CPU, all runs started
together) --zero1, --fsdp, --tp 2 and --lora 4 --tp 2 (bit for bit the one-process --lora 4 run: no wrapped layer is
sharded), an --fsdp run saved at step 2 and resumed, bit for bit the uninterrupted one, and --ema under --fsdp and --tp
2, written whole.
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

    def recording(path, state, step=0, wait=True, **kw):
        if calls and not calls[-1][1]:  # the loop waited on the previous save before this one
            assert _state(path)["step"] == calls[-1][0]
        calls.append((step, wait))
        return training.save_train_state(path, state, step=step, wait=wait, **kw)

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
    "tp_not_dividing_the_world": (["--tp", "3"], "divide the world of 2"),
    "tp_zero": (["--tp", "0"], "must be at least 1"),
    "fsdp_tp_over_the_world": (["--fsdp", "--tp", "4"], "divide the world of 2"),
    "scan": (["--scan"], "loop layout"),
}
ARG_WORLD = {"tp_not_dividing_the_world": 2, "fsdp_tp_over_the_world": 2}  # WORLD_SIZE, as torchrun sets it


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_argument_errors_before_any_model(case, capsys, monkeypatch):
    flags, message = ARG_ERRORS[case]
    monkeypatch.setenv("WORLD_SIZE", str(ARG_WORLD.get(case, 1)))
    monkeypatch.setattr(train, "build_model", lambda *a: pytest.fail("a model was built"))
    with pytest.raises(SystemExit) as exc:
        train.main(BASE + flags)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_preemption_guard_keeps_the_local_flag_in_a_world_of_one(tmp_path):
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


@pytest.mark.parametrize("flag", ["--zero1", "--fsdp"])
def test_sharding_flags_in_a_world_of_one_train_as_one_device(tmp_path, flag):
    "A world of one: --zero1 and --fsdp shard over a data axis of 1, so the run is the plain run bit for bit."
    plain, sharded = str(tmp_path / "plain"), str(tmp_path / "sharded")
    assert train.main(BASE + ["--steps", "2", "--ckpt-dir", plain]) == train.main(
        BASE + [flag, "--steps", "2", "--ckpt-dir", sharded])
    _assert_same_state(plain, sharded)


def _torchrun(flags, log):
    "Start ``train`` under torchrun on 2 CPU ranks (gloo), its output to ``log``."
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
           "uniception_tpu_torch.train"] + BASE + ["--backend", "gloo"] + flags
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=open(log, "w"), stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def torchrun_runs(tmp_path_factory):
    """Every torchrun case of the module, started together: each flag for 3 steps, --fsdp for 4 steps and for
    2 + 2 (the second resumed), one step of --fsdp and of --tp 2 with --ema, and --lora 4 --tp 2 for 3 steps.
    Returns {name: (exit code, output, checkpoint dir)}."""
    d = tmp_path_factory.mktemp("torchrun")
    cases = {"zero1": ["--zero1", "--steps", "3"], "fsdp": ["--fsdp", "--steps", "3"], "tp": ["--tp", "2", "--steps", "3"],
             "whole": ["--fsdp", "--steps", "4", "--ckpt-dir", str(d / "whole")],
             "part": ["--fsdp", "--steps", "2", "--ckpt-dir", str(d / "part")],
             "fsdp_ema": ["--fsdp", "--steps", "1", "--ema", "0.5", "--ckpt-dir", str(d / "fsdp_ema")],
             "tp_ema": ["--tp", "2", "--steps", "1", "--ema", "0.5", "--ckpt-dir", str(d / "tp_ema")],
             "lora_tp": ["--lora", "4", "--tp", "2", "--steps", "3", "--ckpt-dir", str(d / "lora_tp")]}
    procs = {name: _torchrun(flags, str(d / f"{name}.log")) for name, flags in cases.items()}
    out = {}
    for name, p in procs.items():
        out[name] = (p.wait(timeout=600), open(d / f"{name}.log").read(), str(d / name))
    p = _torchrun(["--fsdp", "--steps", "2", "--ckpt-dir", str(d / "part"), "--resume"], str(d / "resumed.log"))
    out["resumed"] = (p.wait(timeout=600), open(d / "resumed.log").read(), str(d / "part"))
    return out


@pytest.mark.parametrize("name,want", [("zero1", "mesh {'data': 2, 'model': 1}"), ("fsdp", "mesh {'data': 2, 'model': 1}"),
                                       ("tp", "mesh {'data': 1, 'model': 2}"),
                                       ("lora_tp", "mesh {'data': 1, 'model': 2}")])
def test_sharding_flags_train_under_torchrun(torchrun_runs, name, want):
    """--zero1, --fsdp, --tp 2 and --lora 4 --tp 2 on 2 gloo ranks exit 0, rank 0 alone printing its mesh and finite
    losses."""
    code, log, _ = torchrun_runs[name]
    assert code == 0, log
    assert want in log and log.count("params=") == 1
    losses = [float(line.split()[3]) for line in log.splitlines() if line.startswith("step ")]
    assert losses and all(map(torch.isfinite, torch.tensor(losses))), log


def test_lora_under_tp_trains_as_one_process(torchrun_runs, tmp_path):
    """--lora 4 --tp 2: as in the JAX package, whose TP rules match ``qkv.kernel`` and not ``qkv.base.kernel``, every
    wrapped layer and its adapters stay whole on both "model" ranks, so the run writes the one-process --lora 4 run's
    train state bit for bit (on one thread, as each rank runs)."""
    code, log, ckpt = torchrun_runs["lora_tp"]
    assert code == 0, log
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(BASE + ["--lora", "4", "--steps", "3", "--ckpt-dir", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(before)
    _assert_same_state(str(tmp_path / "one"), ckpt)


def test_sharded_resume_under_torchrun_equals_the_uninterrupted_run(torchrun_runs):
    "An --fsdp run of 2 steps and its --resume of 2 more write the train state the 4-step run writes, bit for bit."
    for name in ("whole", "part", "resumed"):
        assert torchrun_runs[name][0] == 0, torchrun_runs[name][1]
    assert "resumed from" in torchrun_runs["resumed"][1]
    _assert_same_state(torchrun_runs["whole"][2], torchrun_runs["resumed"][2])


@pytest.mark.parametrize("name", ["fsdp_ema", "tp_ema"])
def test_sharded_ema_is_written_whole_under_torchrun(torchrun_runs, name):
    """--ema 0.5 under --fsdp and --tp 2: rank 0 writes the unsharded EMA under the single-device model's names, after
    one step 0.5 * init + 0.5 * the parameters of the (gathered) train state, bit for bit."""
    code, log, ckpt = torchrun_runs[name]
    assert code == 0, log
    init = dict(train.build_model(train.parse_args(BASE), torch.device("cpu")).named_parameters())
    ema, params = _state(ckpt + "_ema")["tensors"], _state(ckpt)["tensors"]
    assert sorted(ema) == sorted(f"params.{k}" for k in init)
    with torch.no_grad():
        for k, p in init.items():
            assert torch.equal(ema[f"params.{k}"], p * 0.5 + params[f"params.{k}"] * (1.0 - 0.5)), k

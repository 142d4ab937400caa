"""
Package-level contracts of the PyTorch port (uniception_tpu_torch): it imports
without jax and without building kernels, its state-dict keys are the JAX
package's torch-layout keys, its weight loader is strict, the CPU path never
launches a kernel, and its on-card entry points refuse to run without CUDA.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch import serve
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.ops.flash_attention import flash_attention
from uniception_tpu_torch.ops.rope import rope_2d_kernel
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2, info_sharing_num_heads=4
)

_IMPORT_ALL = r"""
import importlib, json, pkgutil, subprocess, sys
calls = []
_popen_init = subprocess.Popen.__init__
def _record(self, args, *a, **k):
    calls.append(args if isinstance(args, str) else " ".join(map(str, args)))
    return _popen_init(self, args, *a, **k)
subprocess.Popen.__init__ = _record
import uniception_tpu_torch
from uniception_tpu_torch.ops import kernel_lib
names = [m.name for m in pkgutil.walk_packages(uniception_tpu_torch.__path__, "uniception_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "uniception_tpu": sorted(m for m in sys.modules if m == "uniception_tpu" or m.startswith("uniception_tpu.")),
    "subprocesses": calls,
    "library_loaded": kernel_lib._lib is not None,
}))
"""


def test_import_everything_without_jax_or_nvcc():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=300, check=True
    )
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "uniception_tpu_torch.models.factory.dust3r" in report["modules"]
    assert "uniception_tpu_torch.serve" in report["modules"]
    for name in ("data.bucketing", "data.pipeline", "utils.coldstart", "utils.checkpoint", "utils.framing",
                 "models.factory.flow", "convert_checkpoints", "models.factory.multiview", "models.encoders.pe_utils",
                 "models.info_sharing.global_attention_transformer",
                 "models.info_sharing.alternating_attention_transformer", "nn.lora", "train", "models.encoders",
                 "models.encoders.vit", "models.encoders.dinov2", "models.encoders.dune",
                 "models.encoders.patch_embedder", "models.encoders.list", "models.encoders.image_normalizations",
                 "models.info_sharing", "convert_dino_to_info_sharing",
                 "models.encoders.radio", "models.encoders.eradio", "models.encoders.dinov3",
                 "models.encoders.perception_encoder", "models.encoders.pixio", "models.encoders.dense_rep_encoder",
                 "models.encoders.global_rep_encoder", "models.libs.perception_encoder.pe",
                 "models.libs.perception_encoder.transforms", "models.prediction_heads.mlp_feature",
                 "models.prediction_heads.mlp_head", "models.prediction_heads.pose_head",
                 "models.prediction_heads.global_head", "models.prediction_heads.moge_conv",
                 "models.info_sharing.diff_cross_attention_transformer", "models.encoders.cosmos",
                 "models.prediction_heads.cosmos", "models.libs.cosmos_tokenizer.image_lib",
                 "models.libs.cosmos_tokenizer.image_cli", "models.libs.cosmos_tokenizer.modules.layers2d", "utils.png",
                 "models.libs.cosmos_tokenizer.modules.layers3d", "models.libs.cosmos_tokenizer.video_lib",
                 "models.libs.cosmos_tokenizer.video_cli", "models.libs.cosmos_tokenizer.networks.continuous_video",
                 "models.libs.cosmos_tokenizer.networks.discrete_video", "models.libs.perception_encoder.transformer"):
        assert f"uniception_tpu_torch.{name}" in report["modules"]
    assert report["jax"] == []
    assert report["uniception_tpu"] == []  # not even its jax-free modules (utils/checkpoint.py, data/bucketing.py)
    assert report["subprocesses"] == []  # no nvcc (or anything else) at import
    assert report["library_loaded"] is False


def test_state_dict_keys_match_jax_export():
    jmod = JaxDUSt3R(name="dust3r_small", img_size=(32, 32), rngs=nnx.Rngs(0), **SMALL)
    tmod = DUSt3R(name="dust3r_small", img_size=(32, 32), **SMALL)
    exported = state_dict_from_module(jmod)
    assert sorted(tmod.state_dict()) == sorted(exported)
    for key, value in tmod.state_dict().items():
        assert tuple(value.shape) == exported[key].shape, key


def test_trunk_dtype_and_fp32_heads():
    # serving: the trunk's parameters are bf16; training: fp32 masters computed in bf16
    model = DUSt3R(name="d", img_size=(32, 32), dtype=torch.bfloat16, param_dtype=torch.bfloat16, **SMALL)
    assert model.encoder.enc_blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert model.info_sharing.norm.weight.dtype == torch.bfloat16
    assert model.head1.linear.weight.dtype == torch.float32
    arrays = {k: v.float().numpy() for k, v in model.state_dict().items()}
    load_state_dict_numpy(model, arrays)  # fp32 arrays are cast to each parameter's dtype
    assert model.encoder.enc_norm.weight.dtype == torch.bfloat16
    train = DUSt3R(name="d", img_size=(32, 32), dtype=torch.bfloat16, **SMALL)
    assert {p.dtype for p in train.parameters()} == {torch.float32}
    assert train.encoder.enc_blocks[0].attn.qkv.compute_dtype == torch.bfloat16
    assert train.head1.linear.weight.dtype == torch.float32


def test_seeded_construction_is_reproducible():
    a = serve.build_model(32, 1, 64, 4, 1, 48, 4, device="cpu", dtype=torch.float32, seed=3).state_dict()
    b = serve.build_model(32, 1, 64, 4, 1, 48, 4, device="cpu", dtype=torch.float32, seed=3).state_dict()
    c = serve.build_model(32, 1, 64, 4, 1, 48, 4, device="cpu", dtype=torch.float32, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.enc_blocks.0.attn.qkv.weight"], c["encoder.enc_blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_weight_loader_is_strict(fault):
    model = DUSt3R(name="d", img_size=(32, 32), **SMALL)
    arrays = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    before = model.head1.linear.bias.clone()
    if fault == "missing":
        del arrays["head1.linear.weight"]
    elif fault == "unexpected":
        arrays["head3.linear.weight"] = np.zeros(3, np.float32)
    else:
        arrays["encoder.enc_norm.weight"] = np.zeros(7, np.float32)
    arrays["head1.linear.bias"] = arrays["head1.linear.bias"] + 1.0
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_state_dict_numpy(model, arrays)
    assert torch.equal(model.head1.linear.bias, before)  # nothing was written


def test_cpu_forward_launches_no_kernel():
    model = DUSt3R(name="d", img_size=(32, 32), **SMALL).eval()
    k1, k2 = flash_attention.launches, rope_2d_kernel.launches
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        res1, _ = model.forward_pair(img, img)
    assert torch.isfinite(res1["pts3d"]).all()
    assert (flash_attention.launches, rope_2d_kernel.launches) == (k1, k2)


def test_serve_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        serve.main(["--img-size", "32"])


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(where, tmp_path):
    "chip_smoke.py exits non-zero and prints no result without a GPU, or without the rest of the repo."
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

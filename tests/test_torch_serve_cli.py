"""
The port's serving and conversion command lines on the CPU at tiny widths:
``convert_checkpoints`` (the .npz interchange file, the vanilla-DUSt3R key
remap against the JAX script's, native serving files in both layouts and
int8) and ``serve.main`` with ``--buckets`` for both models, ``--checkpoint``
from a converted .nsv and from a .pth, a pre-quantized .nsv served int8, and
``--image-dir`` with and without PIL.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from uniception_tpu_torch import convert_checkpoints, serve
from uniception_tpu_torch.nn.quant import Int8Linear
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.coldstart import load_native_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--enc-depth", "2", "--enc-dim", "64", "--enc-heads", "4", "--dec-depth", "2", "--dec-dim", "48",
        "--dec-heads", "4"]
TINY_ARGS = (64, 2, 64, 4, 2, 48, 4)  # img_size, then the widths of TINY
CONVERT = ["--img-size", "64", "--enc-dim", "64", "--enc-depth", "2", "--enc-heads", "4", "--dec-dim", "48",
           "--dec-depth", "2", "--dec-heads", "4"]


def _jax_converter():
    "scripts/convert_checkpoints.py of the JAX package, as a module."
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoints",
                                                  os.path.join(REPO, "scripts", "convert_checkpoints.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pth(tmp_path, model="dust3r", head="dpt", bare=False):
    "A seeded fp32 model's state dict saved with torch.save (a bare state dict or {'model': ...})."
    m = serve.build_model(*TINY_ARGS, device="cpu", dtype=torch.float32, head=head, model=model, seed=1)
    path = str(tmp_path / f"{model}_{head}.pth")
    torch.save(m.state_dict() if bare else {"model": m.state_dict(), "data_norm_type": "dust3r"}, path)
    return path, m


def test_vanilla_dust3r_remap_matches_the_jax_script():
    rng = np.random.RandomState(0)
    vanilla = {k: rng.randn(*shape).astype(np.float32) for k, shape in {
        "patch_embed.proj.weight": (8, 3, 16, 16), "enc_blocks.0.attn.qkv.weight": (24, 8), "enc_norm.weight": (8,),
        "dec_blocks.0.attn.qkv.weight": (18, 6), "decoder_embed.weight": (6, 8), "dec_norm.bias": (6,),
        "downstream_head1.proj.weight": (64, 6), "downstream_head2.proj.bias": (64,),
        "downstream_head1.dpt.head.0.weight": (4, 4, 3, 3), "downstream_head2.dpt.head.4.bias": (4,),
        "downstream_head1.dpt.scratch.refinenet1.out_conv.weight": (4, 4, 1, 1), "downstream_head2.other.w": (2,),
    }.items()}
    mine, ref = convert_checkpoints.remap_vanilla_dust3r(vanilla), _jax_converter().remap_vanilla_dust3r(vanilla)
    assert sorted(mine) == sorted(ref)
    assert "info_sharing.multi_view_branches.1.0.attn.qkv.weight" in mine  # the shared decoder, duplicated
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])


def test_convert_to_the_interchange_npz(tmp_path):
    src, m = _pth(tmp_path, bare=True)
    out = str(tmp_path / "m.npz")
    convert_checkpoints.main([src, out])
    ckpt = load_checkpoint(out)
    assert sorted(ckpt["model"]) == sorted(m.state_dict())
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(ckpt["model"][k], v.numpy())


@pytest.mark.parametrize("scan", [True, False])
def test_convert_serving_layouts(tmp_path, scan):
    src, _ = _pth(tmp_path)
    out = str(tmp_path / "m.nsv")
    convert_checkpoints.main([src, out, "--serving", "--head", "dpt", *CONVERT] + ([] if scan else ["--no-scan"]))
    arrays, meta = load_native_state(out)
    assert meta == {"data_norm_type": "dust3r"}
    stacked = "encoder.enc_blocks.attn.qkv.kernel.value"
    assert (stacked in arrays) == scan and ("encoder.enc_blocks.0.attn.qkv.kernel.value" in arrays) != scan
    assert arrays["encoder.enc_norm.scale.value"].dtype == torch.bfloat16
    with pytest.raises(SystemExit):
        convert_checkpoints.main([src, out, "--serving", "--f32", "--int8", *CONVERT])


def test_serve_buckets_from_a_converted_nsv_and_a_pth(tmp_path, capsys):
    src, m = _pth(tmp_path)
    nsv = str(tmp_path / "m.nsv")
    convert_checkpoints.main([src, nsv, "--serving", "--head", "dpt", *CONVERT])
    for ckpt in (nsv, src):
        stats = serve.main(["--device", "cpu", "--img-size", "64", "--pairs", "6", "--batch", "2", "--head", "dpt",
                            "--buckets", "--checkpoint", ckpt, *TINY])
        assert stats["pairs"] == 6 and set(stats["per_bucket"]) <= {(48, 64), (32, 64)}
        out = capsys.readouterr().out
        assert "pairs/s across" in out and "native orientation" in out and ckpt in out
    pts = stats["last"][0][2]
    assert pts.shape[1:] in ((48, 64, 3), (32, 64, 3)) and torch.isfinite(pts).all()


def test_serve_flow_buckets_with_portrait_canvases(capsys):
    stats = serve.main(["--device", "cpu", "--model", "flow", "--img-size", "64", "--pairs", "7", "--batch", "2",
                        "--buckets", *TINY])
    assert stats["pairs"] == 7
    assert any(h > w for h, w in stats["per_bucket"])  # portrait requests got portrait canvases
    assert "flow:" in capsys.readouterr().out


def test_serve_a_prequantized_nsv_int8(tmp_path, capsys):
    wide = ["--enc-depth", "1", "--enc-dim", "128", "--enc-heads", "4", "--dec-depth", "1", "--dec-dim", "128",
            "--dec-heads", "4"]
    m = serve.build_model(64, 1, 128, 4, 1, 128, 4, device="cpu", dtype=torch.float32, head="linear")
    src, nsv = str(tmp_path / "m.pth"), str(tmp_path / "q.nsv")
    torch.save({"model": m.state_dict()}, src)
    convert_checkpoints.main([src, nsv, "--serving", "--int8", "--img-size", "64", *wide])
    out = serve.main(["--device", "cpu", "--img-size", "64", "--pairs", "2", "--batch", "1", "--checkpoint", nsv, *wide])
    assert "serving int8" in capsys.readouterr().out
    assert torch.isfinite(out[0]).all()
    loaded = serve.build_model(64, 1, 128, 4, 1, 128, 4, device="cpu", checkpoint=nsv)
    assert loaded.quant_spec == ("all", "none")
    assert isinstance(loaded.encoder.enc_blocks[0].mlp.fc1, Int8Linear)


def test_serve_an_image_dir(tmp_path, capsys, monkeypatch):
    from PIL import Image

    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(40, 70), (40, 70), (90, 50), (90, 50)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(tmp_path / f"f{i}.png")
    out = serve.main(["--device", "cpu", "--img-size", "64", "--batch", "2", "--image-dir", str(tmp_path), *TINY])
    assert tuple(out[0].shape) == (2, 64, 64, 3)
    stats = serve.main(["--device", "cpu", "--img-size", "64", "--batch", "1", "--buckets", "--image-dir",
                        str(tmp_path), *TINY])
    assert stats["pairs"] == 2
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without Pillow
    with pytest.raises(SystemExit, match="PIL"):
        serve.main(["--device", "cpu", "--img-size", "64", "--image-dir", str(tmp_path), *TINY])


@pytest.mark.parametrize("model,head,buckets", [("dust3r", "linear", True), ("flow", "dpt", False)])
def test_serve_save_artifact_then_artifact(tmp_path, capsys, model, head, buckets):
    """--save-artifact writes one artifact (square) or one per bucket canvas at <root>.<h>x<w><ext>; --artifact
    binds them all to the one converted .nsv and serves the same outputs as the model built from it, bit for bit.
    The DPT head's artifacts (K7's layouts, both landscape passes) are tests/test_torch_export.py's."""
    src, _ = _pth(tmp_path, model=model, head=head)
    nsv, art = str(tmp_path / "m.nsv"), str(tmp_path / "m.ptexp")
    convert_checkpoints.main([src, nsv, "--serving", "--head", head, "--model", model, *CONVERT])
    common = ["--device", "cpu", "--img-size", "64", "--pairs", "4", "--batch", "2", "--head", head, "--model",
              model, "--checkpoint", nsv, *TINY] + (["--buckets"] if buckets else [])
    paths = serve.main(common + ["--save-artifact", art])
    want = ([serve.bucket_artifact_path(art, hw) for hw in serve.scaled_buckets(64, portrait=model == "flow")]
            if buckets else [art])
    assert paths == want and all(os.path.isfile(p) for p in paths)
    assert "serving artifact written to" in capsys.readouterr().out
    eager = serve.main(common)
    served = serve.main(common + ["--artifact", art])
    assert "(no model construction)" in capsys.readouterr().out
    if buckets:
        assert served["per_bucket"] == eager["per_bucket"] and served["batches"] == eager["batches"]
        eager, served = eager["last"][0], served["last"][0]
    assert len(served) == len(eager) and all(torch.equal(a, b) for a, b in zip(served, eager))


def test_serve_artifact_refusals(tmp_path):
    "--artifact needs a native --checkpoint, and takes no --gptq (the JAX example's two refusals)."
    args = ["--device", "cpu", "--img-size", "32", *TINY, "--artifact", str(tmp_path / "m.ptexp")]
    with pytest.raises(SystemExit, match="--artifact requires --checkpoint to be a native serving checkpoint"):
        serve.main(args)
    src, _ = _pth(tmp_path)
    with pytest.raises(SystemExit, match="--artifact requires --checkpoint to be a native serving checkpoint"):
        serve.main(args + ["--checkpoint", src])
    with pytest.raises(SystemExit, match="--gptq cannot be applied at serve time on the --artifact path"):
        serve.main(args + ["--checkpoint", src, "--gptq", str(tmp_path / "codes.npz")])

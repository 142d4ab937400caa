"""
The port's GPTQ path (uniception_tpu_torch/nn/gptq.py) against the JAX
package's (uniception_tpu/nn/gptq.py) on the CPU: the re-rounding on the same
weights and Hessians, the Hessian and activation-maximum capture on a tiny
DUSt3R carried across from JAX, the npz files in both directions, the
zero-point layers' column sums, and the tools around it (``serve --gptq``,
``convert_checkpoints --int8 --gptq``, ``calibrate_gptq``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.utils.config import get_attention_impl as jax_get_attention_impl
from uniception_tpu.models.utils.config import set_attention_impl as jax_set_attention_impl
from uniception_tpu.nn.gptq import apply_gptq as jax_apply_gptq
from uniception_tpu.nn.gptq import gptq_int8 as jax_gptq_int8
from uniception_tpu.nn.gptq import harvest_act_amax as jax_harvest_act_amax
from uniception_tpu.nn.gptq import harvest_hessians as jax_harvest_hessians
from uniception_tpu.nn.gptq import install_hessian_capture as jax_install_hessian_capture
from uniception_tpu.nn.gptq import load_gptq_npz as jax_load_gptq_npz
from uniception_tpu.nn.quant import quantize_trunk as jax_quantize_trunk
from uniception_tpu.nn.quant import trunk_policy as jax_trunk_policy
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch import calibrate_gptq, convert_checkpoints, nn as tnn, serve
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn.gptq import (
    HessianState,
    apply_gptq,
    gptq_int8,
    harvest_act_amax,
    harvest_hessians,
    install_hessian_capture,
    load_gptq_npz,
)
from uniception_tpu_torch.nn.quant import Int8Linear, quantize_int8, quantize_trunk, trunk_policy
from uniception_tpu_torch.utils.coldstart import load_native_state
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

DIMS = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2,
            info_sharing_num_heads=4)
HW = (32, 48)
# widths whose every trunk linear reaches quantize_trunk's 65536-parameter floor, for the command lines
CLI_DIMS = ["--enc-depth", "1", "--enc-dim", "256", "--enc-heads", "4", "--dec-depth", "1", "--dec-dim", "256",
            "--dec-heads", "4"]
CLI_LAYERS = 4 + 2 * 8  # the encoder block's qkv, proj, fc1, fc2; 8 per decoder block and view (no proj_embed)


@pytest.fixture(autouse=True)
def _plain_routes():
    "JAX through XLA and the port through its plain versions (the CPU's), restored afterwards."
    prev_jax, prev = jax_get_attention_impl(), config.get_attention_impl()
    jax_set_attention_impl("xla")
    config.set_attention_impl("naive")
    yield
    jax_set_attention_impl(prev_jax)
    config.set_attention_impl(prev)


def _correlated(n, d, seed):
    "Calibration inputs whose channels covary (JAX tests/nn/test_gptq.py _calib)."
    rng = np.random.RandomState(seed)
    mix = rng.randn(d, d) / np.sqrt(d) + 0.5 * np.eye(d)
    return rng.randn(n, d) @ mix


def _pair(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, 3, *HW).astype(np.float32) for _ in range(2))


def _models(seed=0):
    "A tiny JAX DUSt3R with perturbed norms and biases, and the port's with its weights."
    jmod = JaxDUSt3R(name="gptq_test", img_size=HW, rngs=nnx.Rngs(seed), **DIMS)
    rng = np.random.RandomState(seed + 100)
    sd = {}
    for k, v in state_dict_from_module(jmod).items():
        v = np.asarray(v, np.float32)
        if k.endswith(".bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif "norm" in k and k.endswith(".weight"):
            v = (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        sd[k] = v
    missing, unexpected = load_torch_state_dict(jmod, sd)
    assert not missing and not unexpected
    tmod = DUSt3R(name="gptq_test", img_size=HW, **DIMS)
    load_state_dict_numpy(tmod, sd)
    return jmod, tmod.eval()


def _capture_both(policy="all", pairs=(1, 2)):
    jmod, tmod = _models()
    enc, dec = jax_trunk_policy(policy)
    n_j = jax_install_hessian_capture(jmod.encoder, min_params=0, predicate=enc)
    n_j += jax_install_hessian_capture(jmod.info_sharing, min_params=0, predicate=dec)
    enc, dec = trunk_policy(policy)
    n_t = install_hessian_capture(tmod.encoder, min_params=0, predicate=enc)
    n_t += install_hessian_capture(tmod.info_sharing, min_params=0, predicate=dec)
    assert n_t == n_j > 0
    with torch.no_grad():
        for seed in pairs:
            a, b = _pair(seed)
            jmod.forward_pair(jnp.asarray(a), jnp.asarray(b))
            tmod.forward_pair(torch.from_numpy(a), torch.from_numpy(b))
    out = (jax_harvest_act_amax(jmod), jax_harvest_hessians(jmod), harvest_act_amax(tmod), harvest_hessians(tmod))
    return jmod, tmod, n_t, out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("d_in,d_out,blocksize,dead", [(96, 80, 128, False), (200, 64, 64, False),
                                                       (130, 48, 128, True)])
def test_gptq_int8_matches_jax_float64(d_in, d_out, blocksize, dead):
    rng = np.random.RandomState(d_in)
    w = rng.randn(d_in, d_out) * 0.05
    x = _correlated(4 * d_in, d_in, seed=d_in + 1)
    if dead:
        x[:, 7] = 0.0  # a channel no input reaches: H_jj = 0
    H = x.T @ x / len(x)
    j_q, j_s = jax_gptq_int8(w, H, blocksize=blocksize)
    t_q, t_s = gptq_int8(torch.from_numpy(w), torch.from_numpy(H), blocksize=blocksize)
    assert t_q.dtype == torch.int8 and t_s.dtype == torch.float32
    assert tuple(t_q.shape) == (d_in, d_out) and tuple(t_s.shape) == (1, d_out)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))  # bit for bit
    diff = t_q.numpy().astype(np.int32) - np.asarray(j_q, np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-3, (diff != 0).mean()
    if dead:
        assert not t_q.numpy()[7].any()


def test_gptq_identity_hessian_equals_rtn():
    w = torch.from_numpy(np.random.RandomState(1).randn(32, 48).astype(np.float32))
    g_q, g_s = gptq_int8(w, torch.eye(32, dtype=torch.float64), percdamp=0.0)
    r_q, r_s = quantize_int8(w, axis=0)
    assert torch.equal(g_s, r_s)
    assert torch.equal(g_q, r_q)


def test_gptq_beats_rtn_on_correlated_inputs():
    rng = np.random.RandomState(2)
    d_in, d_out = 64, 96
    w = rng.randn(d_in, d_out) * 0.05
    x = _correlated(2048, d_in, seed=0)
    H = x.T @ x / len(x)
    g_q, g_s = gptq_int8(torch.from_numpy(w), torch.from_numpy(H))
    r_q, r_s = quantize_int8(torch.from_numpy(w).float(), axis=0)
    ref = x @ w
    err_gptq = np.linalg.norm(x @ (g_q.numpy().astype(np.float64) * g_s.numpy()) - ref)
    err_rtn = np.linalg.norm(x @ (r_q.numpy().astype(np.float64) * r_s.numpy()) - ref)
    assert err_gptq < 0.9 * err_rtn, (err_gptq, err_rtn)


def test_gptq_float32_codes_stay_near_float64():
    rng = np.random.RandomState(3)
    w = (rng.randn(128, 64) * 0.05).astype(np.float32).astype(np.float64)  # fp32 weights, as a model's
    x = _correlated(1024, 128, seed=4)
    H = torch.from_numpy(x.T @ x / len(x))
    q64, s64 = gptq_int8(torch.from_numpy(w), H)
    q32, s32 = gptq_int8(torch.from_numpy(w), H, dtype=torch.float32)
    assert torch.equal(s32, s64)
    assert (q32 != q64).float().mean().item() <= 0.02


@pytest.mark.parametrize("policy", ["all", "enc.qkv,dec.cross,dec.fc2"])
def test_captured_hessians_and_amax_match_jax(policy):
    jmod, tmod, n, (j_amax, j_h, t_amax, t_h) = _capture_both(policy)
    assert set(t_h) == set(j_h) == set(t_amax) == set(j_amax)
    assert len(t_h) == n
    for k in j_h:
        assert t_h[k].dtype == torch.float64
        assert _rel(t_h[k], j_h[k]) <= 1e-5, k
        assert _rel(t_amax[k], j_amax[k]) <= 1e-5, k
        np.testing.assert_allclose(t_h[k].numpy(), t_h[k].numpy().T, rtol=0, atol=0)  # symmetric
    # unwrapped: the model is the float model again, and its state-dict keys are JAX's
    assert sorted(tmod.state_dict()) == sorted(state_dict_from_module(jmod))


def test_harvested_keys_match_quantize_trunk():
    _, tmod, n, (_, _, _, t_h) = _capture_both()
    quantized = quantize_trunk(tmod, "all", min_params=0)
    assert quantized == n
    assert set(t_h) == {p for p, m in tmod.named_modules() if isinstance(m, Int8Linear)}


def test_hessian_state_accumulates_full_fp32():
    x = torch.from_numpy(_correlated(64, 16, seed=5).astype(np.float32)).reshape(4, 16, 16)
    st = HessianState(16)
    st.update(x[:2])
    st.update(x[2:])
    xf = x.reshape(-1, 16).double()
    assert float(st.n) == 64.0
    assert _rel(st.h.numpy(), (xf.T @ xf).numpy()) <= 1e-6
    assert torch.equal(st.amax, x.reshape(-1, 16).abs().amax(0))


def _codes(hessians, model_weights):
    "GPTQ codes (in, out) for every captured layer from the port's float64 gptq_int8."
    return {p: gptq_int8(model_weights[p], torch.as_tensor(H)) for p, H in hessians.items()}


def _weights(tmod, paths):
    return {p: m.weight.detach().t().double() for p, m in tmod.named_modules() if p in paths}


def test_jax_npz_loads_in_port_and_port_npz_in_jax(tmp_path):
    jmod, tmod, _, (_, j_h, _, t_h) = _capture_both()
    jmod_f, tmod_f = _models()  # float copies for the codes
    kernels = {p: np.asarray(w, np.float64).T for p, w in
               ((p, m.weight.detach().numpy()) for p, m in tmod_f.named_modules() if p in j_h)}
    # JAX's codes, saved as scripts/calibrate_gptq.py saves them
    j_codes = {p: jax_gptq_int8(kernels[p], j_h[p]) for p in sorted(j_h)}
    j_path = str(tmp_path / "jax.npz")
    np.savez(j_path, **{f"{p}.{n}": a for p, (q, s) in j_codes.items() for n, a in (("w_q", q), ("w_scale", s))})
    # the port's codes, through the calibration's writer
    t_path = str(tmp_path / "port.npz")
    calibrate_gptq.save_codes(t_path, _codes(t_h, _weights(tmod_f, t_h)))

    jax_quantize_trunk(jmod, "all", min_params=0)
    quantize_trunk(tmod, "all", min_params=0)
    assert apply_gptq(tmod, load_gptq_npz(j_path)) == len(j_codes)
    exported = tmod.state_dict()
    for p, (q, s) in j_codes.items():
        np.testing.assert_array_equal(exported[f"{p}.w_q"].numpy(), np.asarray(q))  # (in, out), bit for bit
        np.testing.assert_array_equal(exported[f"{p}.w_scale"].numpy(), np.asarray(s))
    assert jax_apply_gptq(jmod, jax_load_gptq_npz(t_path)) == len(j_codes)
    j_exported = state_dict_from_module(jmod)
    t_codes = load_gptq_npz(t_path)
    for p, (q, s) in t_codes.items():
        np.testing.assert_array_equal(np.asarray(j_exported[f"{p}.w_q"]), q)
        np.testing.assert_array_equal(np.asarray(j_exported[f"{p}.w_scale"]), s)


def test_apply_gptq_refreshes_zero_point_colsums_as_jax():
    jmod, tmod = _models()
    jax_quantize_trunk(jmod, "all", asym="all", min_params=0)
    quantize_trunk(tmod, "all", asym="all", min_params=0)
    rng = np.random.RandomState(9)
    codes = {p: (rng.randint(-127, 128, size=(m.in_features, m.out_features)).astype(np.int8),
                 np.abs(rng.randn(1, m.out_features)).astype(np.float32) * 1e-2)
             for p, m in tmod.named_modules() if isinstance(m, Int8Linear)}
    before = {p: m.w_colsum.clone() for p, m in tmod.named_modules() if isinstance(m, Int8Linear)}
    assert apply_gptq(tmod, codes) == jax_apply_gptq(jmod, codes) == len(codes)
    j_exported = state_dict_from_module(jmod)
    for p, m in tmod.named_modules():
        if isinstance(m, Int8Linear):
            want = codes[p][0].astype(np.int32).sum(axis=0, keepdims=True).astype(np.float32) * codes[p][1]
            np.testing.assert_array_equal(m.w_colsum.numpy(), want)
            np.testing.assert_array_equal(m.w_colsum.numpy(), np.asarray(j_exported[f"{p}.w_colsum"]))
            assert not torch.equal(m.w_colsum, before[p])


def test_apply_gptq_rejects_a_wrong_shape_and_skips_missing_paths():
    _, tmod = _models()
    quantize_trunk(tmod, "all", min_params=0)
    assert apply_gptq(tmod, {"encoder.no.such.layer": (np.zeros((2, 2), np.int8), np.ones((1, 2), np.float32))}) == 0
    with pytest.raises(ValueError, match="encoder.enc_blocks.0.attn.qkv"):
        apply_gptq(tmod, {"encoder.enc_blocks.0.attn.qkv": (np.zeros((3, 5), np.int8), np.ones((1, 5), np.float32))})


def test_capture_raises_under_fused():
    _, tmod = _models()
    config.set_attention_impl("fused")
    with pytest.raises(ValueError, match="fused"):
        install_hessian_capture(tmod.encoder, min_params=0)
    assert not any(type(m).__name__ == "_HessianCapture" for m in tmod.modules())


def test_nn_root_exports_the_jax_names():
    import uniception_tpu.nn as jnn
    from uniception_tpu.nn import smooth as jsmooth

    for name in ("apply_gptq", "gptq_int8", "harvest_hessians", "install_hessian_capture", "load_gptq_npz"):
        assert hasattr(jnn, name) and hasattr(tnn, name), name
    for name in jsmooth.__all__:
        assert hasattr(tnn, name), name


def test_serve_gptq_without_int8_raises_the_jax_message(tmp_path):
    path = str(tmp_path / "codes.npz")
    np.savez(path, **{"x.w_q": np.zeros((2, 2), np.int8), "x.w_scale": np.ones((1, 2), np.float32)})
    msg = "--gptq requires an int8-quantized model (--int8 or a quantized checkpoint)"
    with pytest.raises(SystemExit, match=msg.replace("(", r"\(").replace(")", r"\)")):
        serve.main(["--device", "cpu", "--img-size", "32", "--gptq", path, *CLI_DIMS])
    with pytest.raises(SystemExit, match="int8-quantized"):
        serve.build_model(32, 1, 64, 4, 1, 48, 4, device="cpu", gptq=path)


def test_calibrate_on_cpu_then_serve_and_convert_with_the_codes(tmp_path, capsys):
    out = str(tmp_path / "tiny.npz")
    res = calibrate_gptq.main(["--device", "cpu", "--img", "32", "--pairs", "1", "--out", out, "--diag-every", "1",
                               *CLI_DIMS])
    log = capsys.readouterr().out
    assert "calibrating the port's own seeded model" in log
    assert res["layers"] == CLI_LAYERS and len(res["ratios"]) == CLI_LAYERS
    assert all(np.isfinite(r) and r > 0 for r in res["ratios"].values())
    codes = load_gptq_npz(out)
    assert len(codes) == CLI_LAYERS and all(q.dtype == np.int8 for q, _ in codes.values())

    dims = (32, 1, 256, 4, 1, 256, 4)
    rtn = serve.build_model(*dims, device="cpu", int8=True)
    served = serve.build_model(*dims, device="cpu", int8=True, gptq=out)
    assert f"GPTQ codes applied to {CLI_LAYERS} layers from {out}" in capsys.readouterr().out
    exported, rtn_sd = served.state_dict(), rtn.state_dict()
    for p, (q, s) in codes.items():
        np.testing.assert_array_equal(exported[f"{p}.w_q"].numpy(), q)
        np.testing.assert_array_equal(exported[f"{p}.w_scale"].numpy(), s)  # the RTN grid
        np.testing.assert_array_equal(rtn_sd[f"{p}.w_scale"].numpy(), s)
    assert sum(not torch.equal(exported[f"{p}.w_q"], rtn_sd[f"{p}.w_q"]) for p in codes) > 0

    # the converter: a seeded fp32 .pth to an int8 .nsv with the codes embedded
    pth, nsv = str(tmp_path / "m.pth"), str(tmp_path / "m.nsv")
    torch.save({"model": serve.build_model(*dims, device="cpu", dtype=torch.float32).state_dict()}, pth)
    convert_checkpoints.main(["--serving", "--int8", "--gptq", out, "--device", "cpu", "--img-size", "32",
                              "--enc-dim", "256", "--enc-depth", "1", "--enc-heads", "4", "--dec-dim", "256",
                              "--dec-depth", "1", "--dec-heads", "4", pth, nsv])
    _, meta = load_native_state(nsv)
    assert meta["quant_gptq_layers"] == CLI_LAYERS and meta["quant_layers"] == CLI_LAYERS
    loaded = serve.build_model(*dims, device="cpu", checkpoint=nsv).state_dict()
    trunk = [k for k in exported if k.startswith(("encoder.", "info_sharing."))]  # the converter casts heads to bf16
    assert all(torch.equal(loaded[k], exported[k]) for k in trunk)
    # a quantized checkpoint takes --gptq without --int8; a float one refuses it after reading its meta
    again = serve.build_model(*dims, device="cpu", checkpoint=nsv, gptq=out).state_dict()
    assert all(torch.equal(again[k], exported[k]) for k in trunk)
    float_nsv = str(tmp_path / "f.nsv")
    convert_checkpoints.main(["--serving", "--img-size", "32", "--enc-dim", "256", "--enc-depth", "1", "--enc-heads",
                              "4", "--dec-dim", "256", "--dec-depth", "1", "--dec-heads", "4", pth, float_nsv])
    with pytest.raises(SystemExit, match="int8-quantized"):
        serve.build_model(*dims, device="cpu", checkpoint=float_nsv, gptq=out)
    with pytest.raises(SystemExit, match="requires --int8"):
        convert_checkpoints.main(["--serving", "--gptq", out, "--device", "cpu", pth, nsv])


@pytest.mark.parametrize("source", ["sd", "cache"])
def test_calibrate_reads_sd_and_cache_weights(tmp_path, capsys, source):
    "--sd (a .pth) and --cache (an oracle's sd.* entries) of the seeded model's weights give its codes bit for bit."
    dims = (32, 1, 256, 4, 1, 256, 4)
    state = serve.build_model(*dims, device="cpu", dtype=torch.float32, seed=0).state_dict()
    if source == "sd":
        weights = str(tmp_path / "m.pth")
        torch.save({"model": state}, weights)
    else:
        weights = str(tmp_path / "oracle.npz")
        np.savez(weights, pts3d=np.zeros((1, 32, 32, 3), np.float32),
                 **{f"sd.{k}": v.numpy() for k, v in state.items()})
    common = ["--device", "cpu", "--img", "32", "--pairs", "1", "--diag-every", "5", *CLI_DIMS]
    seeded, loaded = str(tmp_path / "seeded.npz"), str(tmp_path / "loaded.npz")
    calibrate_gptq.main([*common, "--out", seeded])
    calibrate_gptq.main([*common, "--out", loaded, f"--{source}", weights])
    assert ("weights from" in capsys.readouterr().out)
    a, b = load_gptq_npz(seeded), load_gptq_npz(loaded)
    assert sorted(a) == sorted(b) and len(a) == CLI_LAYERS
    for p in a:
        np.testing.assert_array_equal(a[p][0], b[p][0])
        np.testing.assert_array_equal(a[p][1], b[p][1])


def test_calibrate_flow_model_and_image_dir(tmp_path):
    "The UFM-style flow model's trunk, calibrated on frames of a directory (PIL), the policy narrowing the layers."
    from PIL import Image

    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (40, 50, 3), np.uint8)).save(tmp_path / f"f{i}.png")
    out = str(tmp_path / "flow.npz")
    res = calibrate_gptq.main(["--device", "cpu", "--model", "flow", "--img", "32", "--pairs", "2", "--image-dir",
                               str(tmp_path), "--policy", "enc.*", "--out", out, *CLI_DIMS[:6], "--dec-depth", "2",
                               *CLI_DIMS[8:]])  # the DPT head needs 2 info-sharing blocks
    assert res["layers"] == 4 and sorted(load_gptq_npz(out)) == sorted(
        f"encoder.enc_blocks.0.{n}" for n in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"))


def test_calibration_images_are_the_jax_scripts(tmp_path):
    "RandomState(7) draws, two (1, 3, img, img) images per pair, as scripts/calibrate_gptq.py draws them."
    pairs = list(calibrate_gptq.calibration_pairs(16, 2, "cpu"))
    rng = np.random.RandomState(7)
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), rng.randn(1, 3, 16, 16).astype(np.float32))
        np.testing.assert_array_equal(b.numpy(), rng.randn(1, 3, 16, 16).astype(np.float32))


def test_calibrate_refuses_a_model_with_nothing_to_quantize(tmp_path):
    "64-wide linears are below quantize_trunk's 65,536-parameter floor: nothing to calibrate, said before GPTQ runs."
    with pytest.raises(SystemExit, match="65,536 parameters"):
        calibrate_gptq.main(["--device", "cpu", "--img", "32", "--pairs", "1", "--out", str(tmp_path / "x.npz"),
                             "--enc-depth", "1", "--enc-dim", "64", "--enc-heads", "4", "--dec-depth", "1",
                             "--dec-dim", "48", "--dec-heads", "4"])
    assert not (tmp_path / "x.npz").exists()

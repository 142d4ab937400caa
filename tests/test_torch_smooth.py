"""
The port's zero-cost weight transforms (uniception_tpu_torch/nn/smooth.py:
SmoothQuant scale migration, QuaRot head rotation) against the JAX package's
on the CPU: the Hadamard and the seeded rotation, the fp32 forward left in
place, the transformed weights and the analytically updated Hessians against
JAX's on the same statistics, the update against a fresh capture, the
differential blocks' gate, and the int8 bill on a planted outlier channel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.utils.config import get_attention_impl as jax_get_attention_impl
from uniception_tpu.models.utils.config import set_attention_impl as jax_set_attention_impl
from uniception_tpu.nn import blocks as jblocks
from uniception_tpu.nn.gptq import harvest_act_amax as jax_harvest_act_amax
from uniception_tpu.nn.gptq import harvest_hessians as jax_harvest_hessians
from uniception_tpu.nn.gptq import install_hessian_capture as jax_install_hessian_capture
from uniception_tpu.nn.smooth import hadamard as jax_hadamard
from uniception_tpu.nn.smooth import head_rotation as jax_head_rotation
from uniception_tpu.nn.smooth import rotate_trunk as jax_rotate_trunk
from uniception_tpu.nn.smooth import smooth_trunk as jax_smooth_trunk
from uniception_tpu.utils.torch_compat import load_torch_state_dict, state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.nn import blocks
from uniception_tpu_torch.nn.gptq import harvest_act_amax, harvest_hessians, install_hessian_capture
from uniception_tpu_torch.nn.quant import quantize_linears
from uniception_tpu_torch.nn.smooth import hadamard, head_rotation, rotate_trunk, smooth_trunk
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

# head dims 16 on both sides, so the rotation reaches every block (the JAX test's configuration)
DIMS = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2,
            info_sharing_num_heads=3)
HW = (32, 48)
FOLDS = 2 * 3 + 2 * 2 * 6  # per self block qkv, proj, fc1; per cross block those and projq, projk+projv, cross proj
ROTATIONS = 2 + 2 * 2 * 2  # one per self block, two per cross block
TOL = 5e-5


@pytest.fixture(autouse=True)
def _plain_routes():
    prev_jax, prev = jax_get_attention_impl(), config.get_attention_impl()
    jax_set_attention_impl("xla")
    config.set_attention_impl("naive")
    yield
    jax_set_attention_impl(prev_jax)
    config.set_attention_impl(prev)


def _state(seed=0):
    "A tiny JAX DUSt3R's state dict with perturbed norms and biases."
    jmod = JaxDUSt3R(name="smooth_test", img_size=HW, rngs=nnx.Rngs(seed), **DIMS)
    rng = np.random.RandomState(seed + 100)
    sd = {}
    for k, v in state_dict_from_module(jmod).items():
        v = np.asarray(v, np.float32)
        if k.endswith(".bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif "norm" in k and k.endswith(".weight"):
            v = (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        sd[k] = v
    return sd


def _jax(sd):
    jmod = JaxDUSt3R(name="smooth_test", img_size=HW, rngs=nnx.Rngs(0), **DIMS)
    missing, unexpected = load_torch_state_dict(jmod, sd)
    assert not missing and not unexpected
    return jmod


def _port(sd):
    tmod = DUSt3R(name="smooth_test", img_size=HW, **DIMS)
    load_state_dict_numpy(tmod, sd)
    return tmod.eval()


def _pair(seed=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, 3, *HW).astype(np.float32) for _ in range(2))


def _port_capture(tmod, pair):
    install_hessian_capture(tmod.encoder, min_params=0)
    install_hessian_capture(tmod.info_sharing, min_params=0)
    with torch.no_grad():
        tmod.forward_pair(*(torch.from_numpy(a) for a in pair))
    return harvest_act_amax(tmod), harvest_hessians(tmod)


def _jax_capture(jmod, pair):
    jax_install_hessian_capture(jmod.encoder, min_params=0)
    jax_install_hessian_capture(jmod.info_sharing, min_params=0)
    jmod.forward_pair(*(jnp.asarray(a) for a in pair))
    return jax_harvest_act_amax(jmod), jax_harvest_hessians(jmod)


def _forward(tmod, pair):
    with torch.no_grad():
        res1, res2 = tmod.forward_pair(*(torch.from_numpy(a) for a in pair))
    return {f"{k}1": v for k, v in res1.items()} | {f"{k}2": v for k, v in res2.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("n", [1, 2, 4, 16, 64, 128])
def test_hadamard_is_orthogonal_and_matches_jax(n):
    H = hadamard(n)
    assert H.dtype == torch.float64
    torch.testing.assert_close(H @ H.T, torch.eye(n, dtype=torch.float64), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(H.numpy(), jax_hadamard(n))


def test_hadamard_rejects_other_orders():
    with pytest.raises(ValueError, match="power of 2"):
        hadamard(12)


@pytest.mark.parametrize("head_dim,seed", [(16, 0), (64, 0), (64, 3), (128, 7)])
def test_head_rotation_is_jax_bit_for_bit(head_dim, seed):
    R = head_rotation(head_dim, seed)
    np.testing.assert_array_equal(R.numpy(), jax_head_rotation(head_dim, seed))
    torch.testing.assert_close(R @ R.T, torch.eye(head_dim, dtype=torch.float64), rtol=0, atol=1e-12)


@pytest.mark.parametrize("transform", ["smooth", "rotate", "both"])
def test_transforms_leave_the_fp32_forward(transform):
    sd, pair = _state(), _pair()
    ref = _forward(_port(sd), pair)
    amax, _ = _port_capture(_port(sd), pair)
    tmod = _port(sd)
    if transform in ("smooth", "both"):
        assert smooth_trunk(tmod, amax, alpha=0.25) == FOLDS
    if transform in ("rotate", "both"):
        assert rotate_trunk(tmod, seed=0) == ROTATIONS
    changed = _rel(tmod.encoder.enc_blocks[0].attn.proj.weight.detach(), torch.from_numpy(
        sd["encoder.enc_blocks.0.attn.proj.weight"]))
    assert changed > 1e-3  # the transform moved weights
    out = _forward(tmod, pair)
    for k, r in ref.items():
        scale = max(1.0, float(r.abs().max()))  # the exp adaptors scale errors with the output
        assert (out[k] - r).abs().max().item() <= TOL * scale, k


@pytest.mark.parametrize("transform,alpha", [("smooth", 0.25), ("smooth", 0.0), ("rotate", None),
                                             ("both", 0.5)])
def test_transformed_weights_and_hessians_match_jax(transform, alpha):
    sd, pair = _state(), _pair()
    j_amax, j_h = _jax_capture(_jax(sd), pair)
    jmod, tmod = _jax(sd), _port(sd)
    j_hess = {k: v.copy() for k, v in j_h.items()}
    t_hess = {k: torch.from_numpy(v.copy()) for k, v in j_h.items()}
    if transform in ("smooth", "both"):
        assert smooth_trunk(tmod, j_amax, alpha=alpha, hessians=t_hess) == jax_smooth_trunk(
            jmod, j_amax, alpha=alpha, hessians=j_hess) == FOLDS
    if transform in ("rotate", "both"):
        done = rotate_trunk(tmod, hessians=t_hess, seed=0)
        assert done == jax_rotate_trunk(jmod, hessians=j_hess, seed=0) == ROTATIONS
    want = state_dict_from_module(jmod)
    got = tmod.state_dict()
    assert sorted(got) == sorted(want)
    moved = 0
    for k, v in want.items():
        assert _rel(got[k].numpy(), v) <= 1e-6, k
        moved += not np.array_equal(np.asarray(v), sd[k])
    assert moved > 0
    # the updates are float64 in both; the fp32 scales s may differ from JAX's by an ulp (pow), hence 1e-6
    assert set(t_hess) == set(j_hess)
    for k in j_hess:
        assert _rel(t_hess[k].numpy(), j_hess[k]) <= 1e-6, k


def test_hessian_updates_match_a_fresh_capture():
    "The analytic updates (D^-1 H D^-1, B^T H B) against Hessians captured on the transformed model."
    sd, pair = _state(), _pair()
    amax, hessians = _port_capture(_port(sd), pair)
    tmod = _port(sd)
    smooth_trunk(tmod, amax, alpha=0.5, hessians=hessians)
    rotate_trunk(tmod, hessians=hessians, seed=0)
    _, fresh = _port_capture(tmod, pair)
    assert set(fresh) == set(hessians)
    for k in sorted(hessians):
        assert _rel(hessians[k].numpy(), fresh[k].numpy()) <= 1e-3, k


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_differential_blocks_keep_their_attention(kind):
    "The differential attention is skipped (only mlp.fc1, and a cross block's plain self-attention, move)."
    if kind == "self":
        jblk = jblocks.DiffSelfAttentionBlock(64, 1, 4, rngs=nnx.Rngs(0))
        tblk = blocks.DiffSelfAttentionBlock(64, 1, 4)
        want_folds, want_rot = 1, 0
    else:
        jblk = jblocks.DiffCrossAttentionBlock(64, 1, 4, norm_cross_tokens=True, rngs=nnx.Rngs(0))
        tblk = blocks.DiffCrossAttentionBlock(64, 1, 4, norm_cross_tokens=True)
        want_folds, want_rot = 3, 1
    rels = ("attn.qkv", "attn.proj", "mlp.fc1", "cross_attn.projq", "cross_attn.projv", "cross_attn.proj")
    amax = {r: np.linspace(0.5, 2.0, 64) for r in rels}
    load_state_dict_numpy(tblk, state_dict_from_module(jblk))
    assert smooth_trunk(tblk, amax) == jax_smooth_trunk(jblk, amax) == want_folds
    assert rotate_trunk(tblk) == jax_rotate_trunk(jblk) == want_rot
    want = state_dict_from_module(jblk)
    for k, v in tblk.state_dict().items():
        assert _rel(v.numpy(), want[k]) <= 1e-6, k


def test_smoothing_cuts_the_int8_bill_of_an_outlier_channel():
    "A spiked norm1 gain plants an activation outlier into qkv; balanced smoothing cuts the int8 error (JAX's test)."
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 64).astype(np.float32))

    def make_block():
        blk = blocks.SelfAttentionBlock(64, num_heads=4, qkv_bias=True, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            blk.norm1.weight[3] *= 30.0
        return blk.eval()

    with torch.no_grad():
        ref = make_block()(x)

        def int8_err(blk):
            quantize_linears(blk, min_params=1)
            return ((blk(x) - ref).norm() / ref.norm()).item()

        e_rtn = int8_err(make_block())
        blk = make_block()
        assert install_hessian_capture(blk, min_params=1) >= 1
        blk(x)
        amax = harvest_act_amax(blk)
        harvest_hessians(blk)
        assert amax["attn.qkv"][3] > 10 * amax["attn.qkv"].median()
        assert smooth_trunk(blk, amax, alpha=0.5) >= 1
        assert int8_err(blk) < 0.7 * e_rtn

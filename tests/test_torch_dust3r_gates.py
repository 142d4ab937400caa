"""
Two-view DUSt3R gates of the port against the JAX package on the CPU, with
seeded JAX weights carried across (``state_dict_from_module`` ->
``load_state_dict_numpy``): at 224 with linear heads, a few blocks at the full
head dim (64) and the ManyAR patch embed, in the fast tier; and the full ViT-L
512 in fp32, marked ``slow``, at the reference's own golden thresholds (abs <
1e-2, rel < 1e-3, as tests/models/test_dust3r_fullsize.py holds the JAX
package to the torch reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.utils.config import get_attention_impl as jax_get_attention_impl
from uniception_tpu.models.utils.config import set_attention_impl as jax_set_attention_impl
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

OUTPUTS = (("pts3d", 0), ("conf", 0), ("pts3d_in_other_view", 1), ("conf", 1))


@pytest.fixture(autouse=True)
def _plain_routes():
    prev_jax, prev = jax_get_attention_impl(), config.get_attention_impl()
    jax_set_attention_impl("xla")
    config.set_attention_impl("naive")
    yield
    jax_set_attention_impl(prev_jax)
    config.set_attention_impl(prev)


def _both(img, batch, seed, **dims):
    "Both packages' DUSt3R (linear heads, ManyAR) on the same seeded images: [(name, port, jax) per output]."
    cfg = dict(name=f"dust3r_{img}_linear", img_size=(img, img), patch_embed_cls="ManyAR_PatchEmbed",
               pred_head_type="linear", **dims)
    jmod = JaxDUSt3R(rngs=nnx.Rngs(seed), **cfg)
    tmod = DUSt3R(**cfg)
    load_state_dict_numpy(tmod, state_dict_from_module(jmod), ignore=tmod.checkpoint_alias_patterns())
    rng = np.random.RandomState(42)
    img1, img2 = (rng.randn(batch, 3, img, img).astype(np.float32) for _ in range(2))
    j_out = jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2))
    del jmod
    with torch.no_grad():
        t_out = tmod.eval().forward_pair(torch.from_numpy(img1), torch.from_numpy(img2))
    return [(f"{k}{v + 1}", t_out[v][k].numpy(), np.asarray(j_out[v][k])) for k, v in OUTPUTS]


def test_dust3r_224_linear_matches_jax():
    outs = _both(224, 2, 0, enc_embed_dim=256, enc_depth=2, enc_num_heads=4, info_sharing_dim=192,
                 info_sharing_depth=2, info_sharing_num_heads=3)
    for name, out, ref in outs:
        assert out.shape == ref.shape == ((2, 224, 224, 3) if "pts" in name else (2, 224, 224, 1)), name
        assert np.isfinite(out).all(), name
        # the repo's fp32 bar per component, scaled by the exp adaptors' output
        assert np.abs(out - ref).max() <= 5e-5 * max(1.0, np.abs(ref).max()), name


@pytest.mark.slow
def test_dust3r_vitl_512_fp32_matches_jax():
    for name, out, ref in _both(512, 1, 0):  # the published widths: ViT-L 24 x 1024, 12 x 768 info sharing
        abs_err = np.abs(out - ref).max()
        rel_err = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        print(f"[512 linear] {name}: abs={abs_err:.2e} rel={rel_err:.2e}")
        assert abs_err < 1e-2, (name, abs_err)
        assert rel_err < 1e-3, (name, rel_err)

"""
The port's mixed-orientation DUSt3R (``landscape_only``) and its
reference-compatible forward over view dicts against the JAX package on the
CPU: ManyAR batches with landscape and portrait rows at a non-square canvas
(linear and DPT heads), the symmetrized-pair dedup, and the skip of the
transposed head pass when no row is portrait. Weights go from the port's
seeded modules to JAX modules built from zeros; inputs come from numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.factory.dust3r import interleave as jax_interleave
from uniception_tpu.models.factory.dust3r import is_symmetrized as jax_is_symmetrized
from uniception_tpu_torch.models.factory.dust3r import DUSt3R, interleave, is_symmetrized
from tests.test_torch_dpt import _carry, _composed_tol

SMALL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, info_sharing_dim=48, info_sharing_depth=2,
             info_sharing_num_heads=4)
# rows: landscape, portrait, landscape, portrait (of a 32 x 48 canvas: true shapes 32x48 and 48x32)
TS1 = np.array([[32, 48], [48, 32], [32, 48], [48, 32]], np.int32)
TS2 = np.array([[48, 32], [48, 32], [32, 48], [32, 48]], np.int32)
LAND = np.array([[32, 48]] * 4, np.int32)


def _pair(head, **extra):
    kw = dict(name="dust3r_lo", img_size=(32, 48), patch_embed_cls="ManyAR_PatchEmbed", pred_head_type=head,
              landscape_only=True, **SMALL, **extra)
    return _carry(lambda: JaxDUSt3R(rngs=nnx.Rngs(0), **kw), DUSt3R(generator=torch.Generator().manual_seed(0), **kw))


@pytest.fixture(scope="module", params=["linear", "dpt"])
def models(request):
    return _pair(request.param)


def _images(seed, b=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, 3, 32, 48).astype(np.float32) for _ in range(2)]


def _close(out, ref):
    for res, want in zip(out, ref):
        assert sorted(res) == sorted(want)
        for key in want:
            w = np.asarray(want[key])
            got = res[key].detach().numpy()
            assert got.shape == w.shape and np.isfinite(got).all()
            assert np.abs(got - w).max() <= _composed_tol(w), key


def test_mixed_orientation_batch_matches_jax(models):
    jmod, tmod = models
    img1, img2 = _images(0)
    ref = jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(TS1), jnp.asarray(TS2))
    with torch.no_grad():
        out = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(TS1),
                                torch.from_numpy(TS2))
    _close(out, ref)
    # the portrait rows really differ from what the canvas grid alone gives (the flag is doing something)
    tmod.landscape_only = False
    try:
        with torch.no_grad():
            plain = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(TS1),
                                      torch.from_numpy(TS2))
    finally:
        tmod.landscape_only = True
    assert not torch.allclose(plain[0]["pts3d"][1], out[0]["pts3d"][1])


def test_symmetrized_view_dicts_match_the_plain_path_and_jax(models):
    jmod, tmod = models
    a, b = _images(1, b=2)
    # pairs (a0, b0), (b0, a0), (a1, b1), (b1, a1): rows 2i and 2i + 1 are each other's swap
    img1 = np.stack([a[0], b[0], a[1], b[1]])
    img2 = np.stack([b[0], a[0], b[1], a[1]])
    ts1, ts2 = TS1[[0, 1, 2, 3]], TS1[[1, 0, 3, 2]]
    inst1, inst2 = ["a0", "b0", "a1", "b1"], ["b0", "a0", "b1", "a1"]
    assert is_symmetrized({"instance": inst1}, {"instance": inst2})
    assert jax_is_symmetrized({"instance": inst1}, {"instance": inst2})
    view1 = {"img": torch.from_numpy(img1), "instance": inst1, "true_shape": torch.from_numpy(ts1)}
    view2 = {"img": torch.from_numpy(img2), "instance": inst2, "true_shape": torch.from_numpy(ts2)}
    with torch.no_grad():
        out = tmod(view1, view2)
        plain = tmod.forward_pair(view1["img"], view2["img"], view1["true_shape"], view2["true_shape"])
    for res, want in zip(out, plain):
        for key in want:
            assert torch.allclose(res[key], want[key], rtol=1e-5, atol=1e-5), key
    ref = jmod({"img": jnp.asarray(img1), "instance": inst1, "true_shape": jnp.asarray(ts1)},
               {"img": jnp.asarray(img2), "instance": inst2, "true_shape": jnp.asarray(ts2)})
    _close(out, ref)


def test_symmetry_helpers_match_jax():
    assert not is_symmetrized({"instance": ["a"]}, {"instance": ["b"]})
    assert not is_symmetrized({"instance": ["a", "b"]}, {"instance": ["b", "c"]})
    x, y = np.arange(6.0).reshape(3, 2), -np.arange(6.0).reshape(3, 2)
    for got, want in zip(interleave(torch.from_numpy(x), torch.from_numpy(y)), jax_interleave(x, y)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_landscape_batch_skips_the_transposed_pass(models):
    """No portrait row: one head pass per view, the same outputs as without landscape_only, and JAX's (which runs
    the transposed pass too and selects the canvas pass for every row)."""
    jmod, tmod = models
    img1, img2 = _images(2)
    heads = tmod.heads()
    calls = [0]
    hooks = [heads[0].register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))]
    try:
        with torch.no_grad():
            out = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(LAND),
                                    torch.from_numpy(LAND))
            assert calls[0] == 1
            tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(TS1),
                              torch.from_numpy(TS2))
            assert calls[0] == 3  # with a portrait row in view 1: both passes
            tmod.landscape_only = False
            try:
                plain = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(LAND),
                                          torch.from_numpy(LAND))
            finally:
                tmod.landscape_only = True
    finally:
        for h in hooks:
            h.remove()
    for res, want in zip(out, plain):
        for key in want:
            assert torch.equal(res[key], want[key]), key
    _close(out, jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(LAND), jnp.asarray(LAND)))

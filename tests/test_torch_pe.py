"""
The port's Perception Encoder against the JAX package on the CPU: the PE vision transformer (PE-G14's narrow
stand-in: no cls token, heads of 96, attention pooling; PE-L14's: a cls token, heads of 64; PE-Lang: LayerScale,
no pooling) on its own grid and off it (the PE table resized bilinearly, non-square), its interleaved RoPE table
with and without the cls offset and built once per grid, the PerceptionEncoder and its intermediate-feature returner, ``truncate``, and the
copied preprocessing transforms. f32 within the repo's 5e-5 bar; the narrow configurations and the helpers are
tests/test_torch_encoder_zoo.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.encoders import perception_encoder as jpenc
from uniception_tpu.models.libs.perception_encoder import pe as jpe
from uniception_tpu.models.libs.perception_encoder import transforms as jtransforms
from uniception_tpu_torch.models.encoders import perception_encoder
from uniception_tpu_torch.models.libs.perception_encoder import pe, transforms
from tests.test_torch_encoder_zoo import (  # noqa: F401  (the autouse fixtures apply here too)
    _carry,
    _close,
    _close_outputs,
    _few_threads,
    _image,
    _inputs,
    _jax_forward,
    _jax_normed_features,
    _no_grad,
    narrow,
)


@pytest.mark.parametrize("grid", ["native", "resized"])
@pytest.mark.parametrize("name", ["PE-Core-G14-448", "PE-Core-L14-336", "PE-Lang-G14-448"])
def test_pe_vision_transformer_matches_jax(name, grid):
    """The PE ViT (G14: no cls token, heads of 96, attention pooling; L14: a cls token, heads of 64; Lang:
    LayerScale, no pooling) on its own grid and off it (the PE table resized bilinearly, non-square): the tokens
    and the pooled embedding."""
    jmod, tmod = _carry(lambda: jpe.VisionTransformer.from_config(name, rngs=nnx.Rngs(0)),
                        pe.VisionTransformer.from_config(name))
    size = tmod.image_size
    hw = (size, size) if grid == "native" else (size + 14, size - 14)
    img = _image(9, *hw)
    _close(tmod.forward_features(torch.from_numpy(img), norm=True), _jax_normed_features(jmod, jnp.asarray(img)))
    _close(tmod(torch.from_numpy(img)), _jax_forward(jmod, jnp.asarray(img)))


@pytest.mark.parametrize("use_cls", [False, True])
def test_pe_rope_table_matches_jax(use_cls):
    "The interleaved axial table (x axis first; positions start at 1 behind a cls token, whose row is zeros)."
    got = pe.PERope2D(96, use_cls_token=use_cls).freqs_for_grid(3, 5)
    want = jpe.PERope2D(96, use_cls_token=use_cls).freqs_for_grid(3, 5)[0, 0]
    _close(got, want, tol=0)


def test_pe_rope_table_is_built_once_per_grid(monkeypatch):
    """Every block of a forward shares the rope, and its table is built once for each grid: a second forward at the
    same grid builds nothing, a new grid builds one more, and the rotation matches a freshly built table."""
    rope, built = pe.PERope2D(32, use_cls_token=True), []
    build = rope.freqs_for_grid
    monkeypatch.setattr(rope, "freqs_for_grid", lambda *a, **k: built.append(a) or build(*a, **k))
    q, k = (torch.from_numpy(np.random.RandomState(i).randn(2, 13, 3, 32).astype(np.float32)) for i in (0, 1))
    first = rope(q, k, (3, 4))
    assert all(torch.equal(a, b) for a, b in zip(rope(q, k, (3, 4)), first))
    rope(q[:, :7], k[:, :7], (2, 3))
    assert built == [(3, 4), (2, 3)]
    freqs = build(3, 4)[None, :, None, :]
    assert torch.equal(first[0], pe._apply_rotary_emb(freqs, q))
    assert torch.equal(first[1], pe._apply_rotary_emb(freqs, k))


@pytest.mark.parametrize("ckpt_type,size", [("core", "giant"), ("core", "large"), ("spatial", "giant")])
def test_perception_encoder_and_its_returner_match_jax(ckpt_type, size):
    patch = 14
    kw = dict(name="pe", size=size, checkpoint_type=ckpt_type, patch_size=patch)
    jmod, tmod = _carry(lambda: jpenc.PerceptionEncoder(rngs=nnx.Rngs(0), **kw), perception_encoder.PerceptionEncoder(**kw))
    t_in, j_in = _inputs(_image(10, 56, 42), "perception_encoder")
    got = tmod(t_in)
    assert tuple(got.features.shape) == (2, tmod.model.width, 4, 3)
    _close_outputs(got, _jax_forward(jmod, j_in))
    ifr_kw = dict(kw, indices=[0, 1])
    jifr, tifr = _carry(lambda: jpenc.PerceptionEncoderIntermediateFeatureReturner(rngs=nnx.Rngs(0), **ifr_kw),
                        perception_encoder.PerceptionEncoderIntermediateFeatureReturner(**ifr_kw), seed=1)
    _close_outputs(tifr(t_in), _jax_forward(jifr, j_in))


def test_perception_encoder_truncates_as_the_reference():
    "keep_first_n_layers=n is PE's truncate(n): blocks 0..n."
    kw = dict(name="pe", size="giant", keep_first_n_layers=1)
    jmod, tmod = _carry(lambda: jpenc.PerceptionEncoder(rngs=nnx.Rngs(0), **kw), perception_encoder.PerceptionEncoder(**kw))
    assert tmod.model.layers == jmod.model.layers == len(tmod.model.transformer.resblocks) == 2
    t_in, j_in = _inputs(_image(11, 56, 56), "perception_encoder")
    _close_outputs(tmod(t_in), _jax_forward(jmod, j_in))
    with pytest.raises(ValueError, match="Unsupported combination"):
        perception_encoder.PerceptionEncoder(name="pe", size="base", checkpoint_type="spatial", device="meta")


def test_pe_transforms_copy_gives_the_jax_arrays():
    image = (np.random.RandomState(12).rand(37, 53, 3) * 255).astype(np.uint8)
    for kw in (dict(image_size=32), dict(image_size=32, center_crop=True, interpolation="bicubic", channels_last=True)):
        np.testing.assert_array_equal(transforms.get_image_transform(**kw)(image),
                                      jtransforms.get_image_transform(**kw)(image))

"""
The port's public names against the JAX package's, and the small names it
took over: every module both trees share is compared by AST (no JAX module is
imported for it), with the deliberate omissions listed by ROADMAP item; then
``normalize_image``, the cos/sin RoPE pair, ``xavier_uniform``, the
info-sharing I/O bases, ``print_available_encoder_models``, ``fast_init``,
``utils/debug.py`` and ``utils/viz.py``, each against the JAX package.
"""

import argparse
import ast
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT, PORT_ROOT = os.path.join(REPO, "uniception_tpu"), os.path.join(REPO, "uniception_tpu_torch")

# Names the JAX package exports and the port does not, each with why: a ROADMAP queue 1 item or "Not ported".
OMITTED = {
    "ops/rope.py": {"rope_2d_pallas": "Not ported: the port's kernel entry is rope_2d_kernel (K2, csrc/rope.cu)"},
    # JAX pins GSPMD's layout of the attention activations to batch-on-data (and heads-on-model under TP); in the
    # port every rank already holds exactly its batch rows and, under TP, its heads, so there is no layout to pin
    "ops/attention.py": {n: "Not ported: XLA-only (GSPMD's attention activation layout; each rank holds its rows "
                            "and heads)" for n in ("activation_sharding", "set_activation_sharding")},
    "nn/quant.py": {"force_xla_int8": "Not ported: XLA-only (Pallas does not SPMD-partition; K4 runs on each rank's "
                                      "shards)"},
}
LABEL = re.compile(r"^(ROADMAP queue 1 item (4|12)|Not ported: .+)$")


def _public(path, port):
    """The module's public names: its ``__all__`` where it has one, else its top-level public functions and
    classes. The port's side also counts every top-level public binding (an import, an assignment)."""
    tree = ast.parse(open(path).read())
    declared, defined, literals = None, set(), {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    value = node.value
                    if isinstance(value, ast.Call) and value.args and isinstance(value.args[0], ast.Name):
                        declared = set(literals[value.args[0].id])  # list(_LAZY): a literal defined above
                    else:
                        try:
                            declared = set(ast.literal_eval(value))
                        except ValueError:  # computed: the module's own bindings stand in
                            declared = None
                elif isinstance(t, ast.Name):
                    try:
                        literals[t.id] = ast.literal_eval(node.value)
                    except ValueError:
                        pass
                    if port:
                        defined.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif port and isinstance(node, (ast.Import, ast.ImportFrom)):
            defined.update((a.asname or a.name).split(".")[0] for a in node.names)
    defined = {n for n in defined if not n.startswith("_")}
    if port:
        return (declared or set()) | defined
    return declared if declared is not None else defined


def _shared_modules():
    for root, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), JAX_ROOT)
                if os.path.exists(os.path.join(PORT_ROOT, rel)):
                    yield rel


def test_every_shared_module_has_the_jax_public_names():
    shared = list(_shared_modules())
    assert {"nn/gptq.py", "nn/smooth.py", "utils/viz.py", "utils/debug.py", "ops/rope.py",
            "models/libs/perception_encoder/transformer.py", "models/libs/cosmos_tokenizer/modules/layers3d.py",
            "models/libs/cosmos_tokenizer/video_lib.py"} <= set(shared)
    missing = {}
    for rel in shared:
        lacking = _public(os.path.join(JAX_ROOT, rel), False) - _public(os.path.join(PORT_ROOT, rel), True)
        if lacking:
            missing[rel] = lacking
    unlisted = {rel: sorted(n - set(OMITTED.get(rel, {}))) for rel, n in missing.items()}
    assert not {rel: n for rel, n in unlisted.items() if n}, unlisted
    # every listed omission is really missing (the list goes when a name is ported) and names its reason
    for rel, names in OMITTED.items():
        assert set(names) <= missing.get(rel, set()), (rel, set(names) - missing.get(rel, set()))
        for name, why in names.items():
            assert LABEL.match(why), (rel, name, why)


def test_omitted_items_are_queued_in_the_roadmap():
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    for item in sorted({m.group(2) for names in OMITTED.values() for why in names.values()
                        if (m := LABEL.match(why)) and m.group(2)}):
        assert f"**Item {item} " in roadmap, item


# --- image normalization -----------------------------------------------------------------------------------


def test_normalization_table_holds_float32_tensors_equal_to_jax():
    from uniception_tpu.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT as JAX_NORMS
    from uniception_tpu_torch.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT

    assert set(IMAGE_NORMALIZATION_DICT) == set(JAX_NORMS)
    for key, norm in IMAGE_NORMALIZATION_DICT.items():
        for got, want in ((norm.mean, JAX_NORMS[key].mean), (norm.std, JAX_NORMS[key].std)):
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and tuple(got.shape) == (3,)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("norm_type", sorted(["dummy", "croco", "dust3r", "dune", "dinov2", "dinov3",
                                              "perception_encoder", "identity", "patch_embedder", "radio",
                                              "sea_raft", "unimatch", "roma", "cosmos", "pixio"]))
def test_normalize_image_matches_jax(norm_type):
    from uniception_tpu.models.encoders.image_normalizations import normalize_image as jax_normalize_image
    from uniception_tpu_torch.models.encoders.image_normalizations import normalize_image

    img = np.random.RandomState(0).rand(2, 3, 5, 7).astype(np.float32)
    want = np.asarray(jax_normalize_image(jnp.asarray(img), norm_type))
    got_np = normalize_image(img, norm_type)
    got_t = normalize_image(torch.from_numpy(img), norm_type)
    assert isinstance(got_np, np.ndarray) and got_np.dtype == np.float32
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32
    np.testing.assert_allclose(got_np, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))


def test_frame_normalizer_still_matches_normalize_image():
    from uniception_tpu_torch.data.pipeline import make_frame_normalizer
    from uniception_tpu_torch.models.encoders.image_normalizations import normalize_image

    frames = np.random.RandomState(1).randint(0, 256, size=(2, 4, 6, 3), dtype=np.uint8)
    got = make_frame_normalizer("dinov2", "cpu")(frames)
    want = normalize_image(torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255, "dinov2")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# --- RoPE from precomputed tables ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,base,f0", [(64, 100.0, 1.0), (16, 10000.0, 2.0)])
def test_rope_cos_sin_pair_matches_jax(dtype, D, base, f0):
    from uniception_tpu.ops.rope import rope_2d_from_cos_sin as jax_from_cos_sin
    from uniception_tpu.ops.rope import rope_precompute_cos_sin as jax_precompute
    from uniception_tpu_torch.ops.rope import rope_2d, rope_2d_from_cos_sin, rope_precompute_cos_sin

    rng = np.random.RandomState(D)
    tokens = rng.randn(2, 9, 3, D).astype(np.float32)
    pos = rng.randint(0, 12, size=(2, 9, 2)).astype(np.int32)
    cos, sin = rope_precompute_cos_sin(torch.from_numpy(pos), D, base, f0)
    j_cos, j_sin = jax_precompute(jnp.asarray(pos), D, base, f0)
    assert tuple(cos.shape) == (2, 9, 2, D // 4) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(j_cos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(j_sin), rtol=0, atol=1e-6)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    t = torch.from_numpy(tokens).to(dtype)
    out = rope_2d_from_cos_sin(t, cos, sin)
    want = np.asarray(jax_from_cos_sin(jnp.asarray(tokens).astype(jdt), j_cos, j_sin).astype(jnp.float32))
    assert out.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
        torch.testing.assert_close(out, rope_2d(t, torch.from_numpy(pos), base, f0), rtol=0, atol=1e-5)
    else:  # the rotation runs in bf16: one rounding of each product and sum, as JAX's
        ulp = np.maximum(np.abs(want), 2.0**-8) * 2.0**-7
        assert (np.abs(out.float().numpy() - want) <= 2 * ulp).all()


# --- init ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 32), (96, 16, 3, 3)])
def test_xavier_uniform_bounds_and_generator(shape):
    from uniception_tpu.nn.common import xavier_uniform as jax_xavier_uniform
    from uniception_tpu_torch.nn.common import xavier_uniform

    fan_out, fan_in = shape[0] * int(np.prod(shape[2:])), shape[1] * int(np.prod(shape[2:]))
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    a = xavier_uniform(shape, generator=torch.Generator().manual_seed(0))
    b = xavier_uniform(shape, generator=torch.Generator().manual_seed(0))
    assert a.dtype == torch.float32 and tuple(a.shape) == shape and torch.equal(a, b)
    assert a.abs().max().item() <= limit and a.abs().max().item() > 0.9 * limit
    assert abs(a.std().item() - limit / np.sqrt(3)) < 0.1 * limit
    if len(shape) == 2:  # the same bound as JAX's on the (in, out) kernel of the same layer
        import jax

        j = np.asarray(jax_xavier_uniform(jax.random.PRNGKey(0), shape[::-1]))
        assert np.abs(j).max() <= limit and np.abs(j).max() > 0.9 * limit


def test_fast_init_toggles_zero_fill():
    from uniception_tpu.models.utils import config as jax_config
    from uniception_tpu_torch.models.utils import config
    from uniception_tpu_torch.nn.common import LinearX, trunc_normal, xavier_uniform
    from uniception_tpu_torch.utils.coldstart import abstract_construct

    assert config.get_fast_init() is jax_config.get_fast_init() is False
    with config.fast_init():
        assert config.get_fast_init()
        assert not xavier_uniform((8, 4)).any()
        assert not LinearX(4, 8).weight.any()
        assert not trunc_normal(torch.ones(5)).any()
        with config.fast_init(False):
            assert not config.get_fast_init() and xavier_uniform((8, 4)).any()
        assert config.get_fast_init()
    assert not config.get_fast_init() and LinearX(4, 8).weight.any()
    config.set_fast_init(True)
    try:
        assert config.get_fast_init()
    finally:
        config.set_fast_init(False)
    seen = []
    abstract_construct(lambda: seen.append(config.get_fast_init()) or LinearX(4, 8))
    assert seen == [True] and not config.get_fast_init()


# --- info-sharing I/O -------------------------------------------------------------------------------------------


def test_info_sharing_io_types_share_the_jax_bases():
    from uniception_tpu.models.info_sharing import base as jbase
    from uniception_tpu_torch.models.info_sharing import base

    names = ["MultiViewTransformerInput", "MultiViewTransformerOutput", "MultiSetTransformerInput",
             "MultiSetTransformerOutput"]
    for name in names:
        for root in ("InfoSharingInput", "InfoSharingOutput"):
            assert issubclass(getattr(base, name), getattr(base, root)) == issubclass(
                getattr(jbase, name), getattr(jbase, root)), (name, root)
    x = base.MultiViewTransformerInput(features=[torch.zeros(1, 2, 1, 1)])
    assert isinstance(x, base.InfoSharingInput) and not isinstance(x, base.InfoSharingOutput)


# --- encoder registry ---------------------------------------------------------------------------------------------


def test_print_available_encoder_models_matches_jax(capsys):
    from uniception_tpu.models.encoders import print_available_encoder_models as jax_print
    from uniception_tpu_torch.models.encoders import print_available_encoder_models

    jax_print()
    want = capsys.readouterr().out
    print_available_encoder_models()
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 10


# --- utils/debug.py -------------------------------------------------------------------------------------------------


@dataclasses.dataclass
class _Out:
    pts: object
    conf: object = None


def _tree(mod):
    nan, inf = float("nan"), float("inf")
    return {"b": [mod.array([1.0, nan, inf]), mod.array([0.0])], "a": (mod.array([inf, inf]), {"z": mod.array([1])}),
            "c": mod.array([2.0])}


def test_find_nonfinite_paths_and_messages_match_jax():
    from uniception_tpu.utils.debug import assert_finite as jax_assert_finite
    from uniception_tpu.utils.debug import find_nonfinite as jax_find_nonfinite
    from uniception_tpu_torch.utils.debug import assert_finite, find_nonfinite

    class TorchMod:
        array = staticmethod(lambda v: torch.tensor(v))

    want = jax_find_nonfinite(_tree(jnp), prefix="out")
    assert want == [("out['a'][0]", 0, 2), ("out['b'][0]", 1, 1)]
    assert find_nonfinite(_tree(TorchMod), prefix="out") == want
    assert find_nonfinite(_tree(np), prefix="out") == want
    assert find_nonfinite(_Out(pts=torch.tensor([1.0, float("nan")]), conf=[torch.ones(2)])) == [(".pts", 1, 0)]
    assert find_nonfinite({"x": torch.ones(3), "n": None, "s": "text"}) == []
    with pytest.raises(FloatingPointError) as got:
        assert_finite(_tree(TorchMod), label="batch")
    with pytest.raises(FloatingPointError) as ref:
        jax_assert_finite(_tree(jnp), label="batch")
    assert str(got.value) == str(ref.value)
    assert_finite({"x": torch.ones(2)})


def test_checkify_nan_stand_in_raises_on_nonfinite_outputs():
    from uniception_tpu_torch.utils.debug import checkify_nan

    def fn(x):
        return {"y": x * 2, "z": torch.log(x)}

    checked = checkify_nan(fn)
    out = checked(torch.ones(3))
    torch.testing.assert_close(out["y"], torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError, match=r"output of fn: first at \['z'\] \(0 NaN, 1 Inf\)"):
        checked(torch.tensor([1.0, 0.0]))
    assert "not a checkify" in checkify_nan.__doc__


# --- utils/viz.py ----------------------------------------------------------------------------------------------------


def test_viz_copy_takes_the_same_arguments_and_degrades_without_rerun(capsys):
    from uniception_tpu.utils import viz as jviz
    from uniception_tpu_torch.utils import viz

    assert viz.__all__ == jviz.__all__
    assert viz.rerun_available() == jviz.rerun_available()
    ours, theirs = viz.script_add_args(argparse.ArgumentParser()), jviz.script_add_args(argparse.ArgumentParser())
    assert vars(ours.parse_args(["--save", "x.rrd"])) == vars(theirs.parse_args(["--save", "x.rrd"]))
    if not viz.rerun_available():
        assert viz.script_setup(ours.parse_args([]), "app") is None
        res = {"pts3d": torch.zeros(1, 2, 2, 3), "conf": torch.ones(1, 2, 2, 1),
               "pts3d_in_other_view": torch.zeros(1, 2, 2, 3)}
        viz.log_pointmaps_to_rerun("m", res, res, torch.zeros(2, 3, 2, 2))
        assert "rerun is not installed" in capsys.readouterr().out

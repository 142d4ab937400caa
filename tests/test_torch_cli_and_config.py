"""
The port's command lines and settings against the JAX package's: the kernel selection read from the JAX package's
environment variables (uniception_tpu/models/utils/config.py) and ``serve.py``'s matching flags, the training CLI's
width defaults against ``examples/train_dust3r.py``'s, and the image readers of the Cosmos CLI (utils/png.py on
gray + alpha, PIL for the PNG files it refuses).
"""

import ast
import importlib
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from uniception_tpu_torch import serve, train
from uniception_tpu_torch.models.libs.cosmos_tokenizer import image_cli
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.utils.png import read_png

REPO = Path(__file__).resolve().parents[1]
ENV = ("UNICEPTION_TPU_ATTN", "UNICEPTION_TPU_ATTN_QUANT", "UNICEPTION_TPU_CONV3X3", "UNICEPTION_TPU_GELU")


@pytest.fixture
def fresh_config(monkeypatch):
    """Reload models/utils/config.py under the environment a test sets, and reload it again afterwards under the
    environment without the four variables (the settings every other test expects)."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)

    def load(**env):
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        return importlib.reload(config)

    yield load
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    importlib.reload(config)


@pytest.mark.parametrize("var,value,getter,want", [
    ("UNICEPTION_TPU_ATTN", "pallas", "get_attention_impl", "kernel"),
    ("UNICEPTION_TPU_ATTN", "xla", "get_attention_impl", "kernel"),
    ("UNICEPTION_TPU_ATTN", "fused", "get_attention_impl", "fused"),
    ("UNICEPTION_TPU_ATTN", "naive", "get_attention_impl", "naive"),
    ("UNICEPTION_TPU_ATTN", "kernel", "get_attention_impl", "kernel"),
    ("UNICEPTION_TPU_ATTN_QUANT", "int8", "get_attention_quant", "int8"),
    ("UNICEPTION_TPU_ATTN_QUANT", "int8pv", "get_attention_quant", "int8pv"),
    ("UNICEPTION_TPU_ATTN_QUANT", "none", "get_attention_quant", "none"),
    ("UNICEPTION_TPU_CONV3X3", "pallas", "get_conv3x3_impl", "kernel"),
    ("UNICEPTION_TPU_CONV3X3", "xla", "get_conv3x3_impl", "torch"),
    ("UNICEPTION_TPU_GELU", "tanh", "get_gelu_mode", "tanh"),
    ("UNICEPTION_TPU_GELU", "exact", "get_gelu_mode", "exact"),
])
def test_environment_variables_select_the_kernels(fresh_config, var, value, getter, want):
    "Each of the JAX package's variables takes effect at import, its values mapped to the port's names."
    assert getattr(fresh_config(**{var: value}), getter)() == want


def test_defaults_without_the_environment_variables(fresh_config):
    cfg = fresh_config()
    got = (cfg.get_attention_impl(), cfg.get_attention_quant(), cfg.get_conv3x3_impl(), cfg.get_gelu_mode())
    assert got == ("kernel", "none", "torch", "exact")


@pytest.mark.parametrize("var", ENV)
def test_an_unknown_value_raises_naming_the_variable(fresh_config, var):
    with pytest.raises(ValueError, match=var):
        fresh_config(**{var: "turbo"})


def test_serve_flags_set_what_the_variables_set(fresh_config):
    fresh_config()
    serve.apply_kernel_flags(serve.parse_args(["--attn", "fused", "--attn-quant", "int8", "--conv3x3", "kernel",
                                               "--gelu", "tanh"]))
    assert (config.get_attention_impl(), config.get_attention_quant(), config.get_conv3x3_impl(),
            config.get_gelu_mode()) == ("fused", "int8", "kernel", "tanh")


def test_serve_without_the_flags_keeps_the_environment(fresh_config):
    fresh_config(UNICEPTION_TPU_ATTN="fused", UNICEPTION_TPU_GELU="tanh")
    serve.apply_kernel_flags(serve.parse_args([]))
    assert (config.get_attention_impl(), config.get_gelu_mode()) == ("fused", "tanh")


def _example_defaults():
    "The defaults of examples/train_dust3r.py's parser, read from its source (its parser lives inside main)."
    tree = ast.parse((REPO / "examples" / "train_dust3r.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument" and node.args:
            flag = getattr(node.args[0], "value", None)
            for kw in node.keywords:
                if kw.arg == "default" and isinstance(kw.value, ast.Constant):
                    out[flag] = kw.value.value
    return out


def test_training_cli_width_defaults_are_the_jax_examples():
    "The port's training CLI trains, without flags, the JAX example's model: 64 wide, 4 heads (D = 16), 2 deep."
    want = _example_defaults()
    got = vars(train.parse_args([]))
    for flag in ("--img", "--embed-dim", "--depth", "--heads", "--batch", "--steps", "--lr", "--dataset-size"):
        assert got[flag[2:].replace("-", "_")] == want[flag], flag
    assert got["embed_dim"] // got["heads"] == 16


def _png_bytes(w, h, color, depth, rows):
    "A PNG file built by hand: IHDR, one IDAT of filter-0 rows, IEND."
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_gray_and_alpha_reads_as_three_channels_of_the_gray(tmp_path):
    "Colour type 4 (gray + alpha): channel 0 repeated to RGB, the alpha dropped."
    rng = np.random.RandomState(4)
    ga = rng.randint(0, 256, (5, 7, 2)).astype(np.uint8)
    path = tmp_path / "ga.png"
    path.write_bytes(_png_bytes(7, 5, 4, 8, ga.reshape(5, 14)))
    got = read_png(str(path))
    assert got.shape == (5, 7, 3) and got.dtype == np.uint8
    assert np.array_equal(got, np.repeat(ga[..., :1], 3, axis=2))


@pytest.mark.parametrize("mode", ["P", "I;16"])
def test_image_cli_reads_the_pngs_it_refuses_through_pil(tmp_path, mode):
    "A palette or 16-bit PNG, which utils/png.py refuses, reads as the JAX CLI reads it: PIL's RGB conversion."
    from PIL import Image

    rng = np.random.RandomState(6)
    if mode == "P":
        img = Image.fromarray(rng.randint(0, 256, (6, 9, 3)).astype(np.uint8)).convert("P")
    else:
        img = Image.fromarray(rng.randint(0, 65536, (6, 9)).astype(np.uint16))
    path = str(tmp_path / "in.png")
    img.save(path)
    with pytest.raises(ValueError):
        read_png(path)
    got = image_cli._read(path)
    assert np.array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_image_cli_without_pil_names_both_readers(tmp_path, monkeypatch):
    path = tmp_path / "p.png"
    path.write_bytes(_png_bytes(2, 2, 3, 8, np.zeros((2, 2), np.uint8)))  # palette: utils/png.py refuses it
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(ValueError, match="utils/png.py refuses it.*PIL"):
        image_cli._read(str(path))

"""
8-bit PNG files without PIL: read any non-interlaced gray, gray + alpha, RGB or RGBA file (every scanline filter),
write RGB with no filter. The Cosmos image CLI reads and writes ``.png`` through it, so it runs where PIL is absent.

    image = read_png("in.png")  # (H, W, 3) uint8
    write_png("out.png", image)
"""

import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        yield data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    "Undo the per-scanline filters (PNG spec section 9) of ``raw`` (h rows of 1 + stride bytes)."
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 1 or kind == 3 or kind == 4:
            cur = np.zeros(stride, np.int32)
            for x0 in range(0, stride, bpp):  # each pixel needs the one to its left, already decoded
                left = cur[x0 - bpp:x0] if x0 else np.zeros(bpp, np.int32)
                up = prev[x0:x0 + bpp]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) // 2
                else:
                    ul = prev[x0 - bpp:x0] if x0 else np.zeros(bpp, np.int32)
                    p = left + up - ul
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
                cur[x0:x0 + bpp] = (line[x0:x0 + bpp] + pred) & 255
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind == 0:
            cur = line
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    "An 8-bit, non-interlaced PNG file as an (H, W, 3) uint8 RGB array (gray repeated, alpha dropped)."
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNG files are read (depth {depth}, color "
                         f"type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return np.repeat(img[..., :1], 3, axis=2) if ch < 3 else img[..., :3].copy()  # gray (+ alpha): channel 0


def write_png(path: str, image: np.ndarray):
    "Write an (H, W, 3) uint8 array as an RGB PNG file (no filter, zlib level 6)."
    image = np.ascontiguousarray(image, np.uint8)
    h, w, ch = image.shape
    if ch != 3:
        raise ValueError(f"write_png: (H, W, 3) uint8 expected, got {image.shape}")

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))

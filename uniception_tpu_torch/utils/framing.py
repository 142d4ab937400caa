"""
Binary-container framing (counterpart of uniception_tpu/utils/framing.py):
magic bytes + 8-byte little-endian header length + JSON header, the frame of
the native serving checkpoints (utils/coldstart.py, ``UNICEPTION_NSV1``).
Byte for byte the JAX package's, so either package reads the other's files.
"""

import json
from typing import Any, Dict

__all__ = ["write_framed_header", "read_framed_header"]


def write_framed_header(f, magic: bytes, header: Dict[str, Any]) -> None:
    "Write magic + length-prefixed JSON header; payload bytes follow."
    payload = json.dumps(header).encode()
    f.write(magic)
    f.write(len(payload).to_bytes(8, "little"))
    f.write(payload)


def read_framed_header(f, magic: bytes, what: str = "container") -> Dict[str, Any]:
    "Read and validate the frame written by :func:`write_framed_header`."
    got = f.read(len(magic))
    if got != magic:
        raise ValueError(f"not a {what} (bad magic {got!r}, expected {magic!r})")
    hlen = int.from_bytes(f.read(8), "little")
    return json.loads(f.read(hlen).decode())

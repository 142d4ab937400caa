"""
Positional-encoding tables (counterpart of uniception_tpu/models/encoders/pe_utils.py; only the sinusoid table,
which the global- and alternating-attention info sharing use for their view- and set-index encodings).
"""

import numpy as np

__all__ = ["sinusoid_encoding_table"]


def sinusoid_encoding_table(n_position: int, d_hid: int, base: float) -> np.ndarray:
    "Sinusoid PE table (reference dense_rep_encoder.py:178-188): computed in float64, returned as float32."
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(base, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)

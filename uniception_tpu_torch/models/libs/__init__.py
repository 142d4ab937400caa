"""Vendored model libraries the encoders build on (counterpart of uniception_tpu/models/libs/)."""

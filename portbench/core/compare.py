"""The comparison that decides ``correct``: numbers measured against the reference, each beside its limit."""

import math
import sys
from typing import Dict, List, Tuple

__all__ = ["row_rel_err", "row_dev_rel", "judge", "print_checks"]


def row_rel_err(out, ref) -> List[float]:
    """Per leading row: ||out - ref|| / ||ref|| over the rest of the axes, in fp64 on the tensors' device. A row
    with a non-finite value in ``out`` reads inf."""
    d = (out.double() - ref.double()).flatten(1)
    num = d.norm(dim=1)
    den = ref.double().flatten(1).norm(dim=1).clamp_min(1e-30)
    rel = (num / den).tolist()
    finite = out.isfinite().flatten(1).all(dim=1).tolist()
    return [r if ok and math.isfinite(r) else math.inf for r, ok in zip(rel, finite)]


def row_dev_rel(out, ref) -> List[float]:
    """Per leading row: ||out - ref|| over the reference's spread about its own means, ||ref - mean(ref)||, the
    means taken per channel (the last axis) over the row's other axes; fp64. A row with a non-finite value in
    ``out`` reads inf. Unlike :func:`row_rel_err` its size does not hang on how far a channel's values sit from 0."""
    d = (out.double() - ref.double()).flatten(1)
    r = ref.double()
    dev = (r - r.mean(dim=tuple(range(1, r.dim() - 1)), keepdim=True)).flatten(1)
    rel = (d.norm(dim=1) / dev.norm(dim=1).clamp_min(1e-30)).tolist()
    finite = out.isfinite().flatten(1).all(dim=1).tolist()
    return [r if ok and math.isfinite(r) else math.inf for r, ok in zip(rel, finite)]


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` is true when every number is at or below its limit (a missing or non-finite number fails).
    Returns (correct, {name: {"value", "limit"}}) in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        v = v if math.isfinite(v) else math.inf
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": limit}  # JSON has no inf
        ok = ok and v <= limit
    return ok, checks


def print_checks(checks: Dict[str, dict]) -> None:
    "Each compared number beside its limit, as the last lines of standard error."
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)

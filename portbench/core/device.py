"""The card: its check at start, its description in the result line, and the table of published peaks."""

import sys

__all__ = ["PEAKS", "require_cards", "describe", "peak_of"]

# Published dense peaks (NVIDIA's data sheet for the SXM part, without sparsity), by the name that
# torch.cuda.get_device_name() gives. The fp32 heads' operations are counted at the bf16 rate, as the
# metrics that use them say.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def require_cards(torch, n: int) -> None:
    "Exit with code 3, and no result, unless CUDA is available with at least ``n`` cards."
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; a run needs a CUDA card and never falls back to the CPU",
              file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        print(f"portbench: the cell needs {n} cards, {torch.cuda.device_count()} are visible", file=sys.stderr)
        raise SystemExit(3)


def describe(torch, count: int, peak_bytes: int) -> dict:
    "The result line's ``device``: platform, the card's name, the cards used and the peak bytes on the fullest."
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def peak_of(kind: str):
    "The peak table's entry for a card name, or None for a card the table does not know."
    return PEAKS.get(kind)

"""
Intermediate-feature-return (IFR) utilities (counterpart of
uniception_tpu/models/utils/intermediate_feature_return.py; reference
uniception/models/utils/intermediate_feature_return.py:19-85).

``indices`` may be None (all layers), an int (the last n layers) or a list of
ints (specific layers, negative counting from the end).
"""

from typing import List, Optional, Tuple, Union

__all__ = ["IntermediateFeatureReturner", "feature_take_indices"]


class IntermediateFeatureReturner:
    """Mixin holding the intermediate-feature-return configuration.

    Args:
        indices: None -> all layers; int -> last n layers; list -> specific layers.
        norm_intermediate: apply the final norm layer to intermediates.
        stop_early: stop running blocks after the last requested index.
        intermediates_only: return only the intermediates (no final output).
    """

    def __init__(
        self,
        indices: Optional[Union[int, List[int]]] = None,
        norm_intermediate: bool = True,
        stop_early: bool = False,
        intermediates_only: bool = True,
    ):
        self.indices = indices
        self.norm_intermediate = norm_intermediate
        self.stop_early = stop_early
        self.intermediates_only = intermediates_only


def feature_take_indices(num_features: int, indices: Optional[Union[int, List[int]]] = None) -> Tuple[List[int], int]:
    "Resolve ``indices`` into absolute layer indices; returns (indices, the largest one)."
    if indices is None:
        indices = num_features
    if isinstance(indices, int):
        if not 0 < indices <= num_features:
            raise ValueError(f"last-n ({indices}) is out of range (1 to {num_features})")
        take_indices = [num_features - indices + i for i in range(indices)]
    else:
        take_indices = []
        for i in indices:
            idx = num_features + i if i < 0 else i
            if not 0 <= idx < num_features:
                raise ValueError(f"feature index {idx} is out of range (0 to {num_features - 1})")
            take_indices.append(idx)
    return take_indices, max(take_indices)

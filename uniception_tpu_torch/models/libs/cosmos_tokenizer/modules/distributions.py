"""
Distributions of the continuous tokenizers (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/modules/distributions.py; reference
uniception/models/libs/cosmos_tokenizer/modules/distributions.py:20-42).
"""

from typing import Optional

import torch

__all__ = ["IdentityDistribution", "GaussianDistribution"]


class IdentityDistribution:
    "AE formulation: the latent passes through."

    def __call__(self, parameters: torch.Tensor, generator: Optional[torch.Generator] = None):
        zero = torch.zeros((1,), device=parameters.device)
        return parameters, (zero, zero.clone())


class GaussianDistribution:
    """VAE formulation: split (mean, logvar) along the channels and sample with ``generator``; without one the mean
    (inference), as the JAX package does without a key. The draw is :meth:`standard_normal`, one method, so a test
    can give both frameworks the same noise."""

    def __init__(self, min_logvar: float = -30.0, max_logvar: float = 20.0):
        self.min_logvar = min_logvar
        self.max_logvar = max_logvar

    def standard_normal(self, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(like.shape, dtype=like.dtype, device=like.device, generator=generator)

    def __call__(self, parameters: torch.Tensor, generator: Optional[torch.Generator] = None):
        mean, logvar = torch.chunk(parameters, 2, dim=1)
        logvar = logvar.clamp(self.min_logvar, self.max_logvar)
        if generator is None:
            sample = mean  # deterministic (inference)
        else:
            sample = mean + torch.exp(0.5 * logvar) * self.standard_normal(mean, generator)
        return sample, (mean, logvar)

"""Parameter initialisers drawn from an explicit ``torch.Generator``.

They follow the distributions of flax's defaults, which the JAX package
uses: Glorot-uniform for the GATv2 weights and attention vector,
LeCun-normal (truncated at two standard deviations) for Dense kernels,
zeros for biases.  The two frameworks' random streams differ, so the same
seed gives other numbers than in JAX; tests carry JAX's values across with
``utils.convert`` instead.  Draws happen on the generator's device.
"""
from __future__ import annotations

import math

import torch


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(t.shape, generator=generator, device=generator.device)
    with torch.no_grad():
        t.copy_((2.0 * u - 1.0) * limit)
    return t


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, device=generator.device,
                   dtype=torch.float64)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    with torch.no_grad():
        t.copy_((z * std).to(t.dtype))
    return t

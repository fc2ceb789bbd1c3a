"""Activation functions of the EVA trunk.

Counterparts of hirest_tpu/models/layers.py `gelu` and `gelu_bf16_poly`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch's default nn.GELU in the EVA towers."""
    return F.gelu(x, approximate="none")


# Minimax fit of erf(u)/u as an even polynomial in u^2 on u in [0, 2.9]
# (chebfit deg 6; max |erf error| 1.5e-3). Used by gelu_bf16_poly.
GELU_ERF_COEF = (1.128166641, -0.3732706075, 0.1064506995, -0.02129873868,
                 0.002738415506, -0.0001988900883, 6.119205364e-06)


def gelu_bf16_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU to bf16 accuracy: the short erf polynomial of the JAX
    package's production trunk (absolute error <= 1.6e-3, <= 2 bf16 ULP
    where |gelu(x)| >= 0.1). Computed in f32 with the same operations in the
    same order, so it matches the JAX function bit for bit in f32; returns
    the input dtype. Works in place on its own f32 buffers to keep the
    number of full-size temporaries at three."""
    x32 = x.float()
    u = x32.clamp(-4.1, 4.1).mul_(0.7071067811865476)
    s = u * u
    p = s * GELU_ERF_COEF[-1]
    p.add_(GELU_ERF_COEF[-2])
    for c in GELU_ERF_COEF[-3::-1]:
        p.mul_(s).add_(c)
    e = u.mul_(p).clamp_(-1.0, 1.0)
    # 0.5 * x * (1 + e): the halving is exact, so its position is free
    return e.add_(1.0).mul_(x32).mul_(0.5).to(x.dtype)

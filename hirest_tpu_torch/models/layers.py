"""Shared building blocks of the EVA towers and the caption stack.

Counterparts of hirest_tpu/models/layers.py: `gelu` (the EVA towers'
torch GELU) and `gelu_erfc` (its jax.nn.gelu form), `gelu_bf16_poly`,
`causal_mask`, `dot_product_attention`, `split_heads`, `merge_heads` and
`MultiHeadAttention` (its `fused` and `fused_qv_bias` modes, the EVA text
and vision attentions, and its `separate` mode without an output
projection, the BERT attention of the caption stack); `layer_norm_fast_var`,
the arithmetic of the flax `nn.LayerNorm` that the JAX package's unrolled
towers and joint model use; and `dense`, that of a flax `nn.Dense` whose
parameters stay f32 while it computes in another dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch's default nn.GELU in the EVA towers."""
    return F.gelu(x, approximate="none")


def gelu_erfc(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=False), the JAX caption stack's GELU, op for
    op: 0.5 * x * erfc(-x * sqrt(1/2)), the constant and every intermediate
    in x's dtype (in bf16 each product is rounded, as JAX rounds each op)."""
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


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


def layer_norm_fast_var(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=x.dtype)`: statistics in f32 with the fast
    variance E[x^2] - E[x]^2 clipped at 0, (x - mean) * (rsqrt(var + eps) *
    scale) + bias in f32, cast to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.float()
    return ((x32 - mean) * mul + norm.bias.float()).to(x.dtype)


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax `nn.Dense(dtype=x.dtype)` on f32 parameters: weight and bias
    cast to x's dtype, the product rounded to it, then the bias added in
    it (F.linear with a bias would round once, another number in bf16)."""
    y = F.linear(x, lin.weight.to(x.dtype))
    return y + lin.bias.to(x.dtype)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] f32 additive causal bias: -inf above the diagonal."""
    tri = torch.full((length, length), float("-inf"), device=device).triu(1)
    return tri[None, None]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """q, k, v [B, H, T, D] in the working dtype; bias broadcastable to
    [B, H, Tq, Tk] or None. q is scaled in the working dtype, the scores
    are f32 (the products of the working-dtype values, accumulated in f32)
    plus the bias, the softmax is f32 and the probabilities are rounded to
    the working dtype before PV."""
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*D] -> the [B, H, T, D] view of it."""
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] -> [B, T, H*D] (a view when x lies in [B, T, H, D]
    memory, as the attention kernels' outputs do)."""
    return x.transpose(1, 2).flatten(2)


class MultiHeadAttention(nn.Module):
    """Self-attention in three modes, with the reference's parameter
    names:

    - "fused" (the text tower, torch's nn.MultiheadAttention packing):
      `in_proj_weight` [3*inner, dim], `in_proj_bias` [3*inner],
      `out_proj`;
    - "fused_qv_bias" (the vision tower, EVA_clip/vit_model.py:66-150):
      `qkv` without bias, `q_bias` and `v_bias` added after the split in
      the working dtype, `proj`;
    - "separate" (the BERT self-attention of the caption stack,
      clip4caption/modules/module_visual.py): `query`, `key`, `value`,
      each biased, no output projection (the JAX module's
      `use_out_proj=False`; BertSelfOutput projects), computed as `dense`
      in the dtype of x on f32 parameters.

    Attention without a bias in the two fused modes takes the kernels as
    the JAX module's use_pallas path does: head width a multiple of 128 ->
    packed heads (K7), else split heads (K6). With a bias (the text
    tower's causal mask), and always in the separate mode (the JAX caption
    stack leaves use_pallas off), it is the plain
    `dot_product_attention`."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 mode: str = "fused"):
        super().__init__()
        self.num_heads, self.head_dim, self.mode = num_heads, head_dim, mode
        self.scale = head_dim ** -0.5
        inner = num_heads * head_dim
        if mode == "fused":
            self.in_proj_weight = nn.Parameter(torch.zeros(3 * inner, dim))
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * inner))
            self.out_proj = nn.Linear(inner, dim)
        elif mode == "fused_qv_bias":
            self.qkv = nn.Linear(dim, 3 * inner, bias=False)
            self.q_bias = nn.Parameter(torch.zeros(inner))
            self.v_bias = nn.Parameter(torch.zeros(inner))
            self.proj = nn.Linear(inner, dim)
        elif mode == "separate":
            self.query = nn.Linear(dim, inner)
            self.key = nn.Linear(dim, inner)
            self.value = nn.Linear(dim, inner)
        else:
            raise ValueError(mode)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.num_heads
        if self.mode == "separate":
            q, k, v = (dense(x, self.query), dense(x, self.key),
                       dense(x, self.value))
            return merge_heads(dot_product_attention(
                split_heads(q, h), split_heads(k, h), split_heads(v, h),
                bias, self.scale))
        # imported here: ops.attention and ops.quant import this module
        from hirest_tpu_torch.ops.attention import (fused_attention,
                                                    fused_attention_packed)

        if self.mode == "fused":
            q, k, v = F.linear(x, self.in_proj_weight).chunk(3, -1)
            qb, kb, vb = self.in_proj_bias.chunk(3)
            q, k, v = q + qb, k + kb, v + vb
            out_proj = self.out_proj
        else:
            q, k, v = self.qkv(x).chunk(3, -1)
            q, v = q + self.q_bias, v + self.v_bias
            out_proj = self.proj
        if bias is None and self.head_dim % 128 == 0:
            out = fused_attention_packed(q, k, v, self.scale, h)
        elif bias is None:
            out = merge_heads(fused_attention(
                split_heads(q, h), split_heads(k, h), split_heads(v, h),
                self.scale))
        else:
            out = merge_heads(dot_product_attention(
                split_heads(q, h), split_heads(k, h), split_heads(v, h),
                bias, self.scale))
        return out_proj(out)

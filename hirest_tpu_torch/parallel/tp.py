"""Tensor-parallel layers over the mesh's 'model' group.

In the JAX package XLA partitions the sharded weights of parallel/mesh.py
and inserts the collectives itself. Here they are written out, Megatron's
way, with two autograd functions over the model group:

- `copy_to_group`: the identity forward, an all_reduce of the gradient
  backward (the input of a column-parallel layer is replicated, each rank's
  gradient of it partial);
- `reduce_from_group`: an all_reduce forward (each rank holds a partial
  sum), the identity backward.

`ColumnParallelLinear` keeps this rank's rows of an nn.Linear's weight and
bias (its output features), `RowParallelLinear` its columns (input
features), whose partial products are summed and then biased once.
`VocabParallelEmbedding` keeps this rank's rows of the vocabulary: the
lookup is masked to them and summed; the tied classifier's logits over the
local rows are gathered into the full vocabulary by an all_reduce of a
zero-filled [..., V] tensor (`logits`). Only all_reduce is used, on
tensors of the compute device, which both NCCL and gloo (CUDA tensors
included) carry.

Each module computes `models/layers.py::dense`'s arithmetic (the product in
x's dtype, then the bias added in it), which `dense` hands to a module
with `tensor_parallel` set. With a group of None (a model axis of one)
every collective is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def _shard(t: torch.Tensor, dim: int, size: int, index: int) -> nn.Parameter:
    n = t.shape[dim] // size
    return nn.Parameter(t.detach().narrow(dim, index * n, n).clone())


class ColumnParallelLinear(nn.Module):
    """nn.Linear with this rank's 1/size of the output features: y_local =
    x W_local^T + b_local, the input replicated."""

    tensor_parallel = True

    def __init__(self, lin: nn.Linear, group, size: int, index: int):
        super().__init__()
        self.group = group
        self.weight = _shard(lin.weight, 0, size, index)
        self.bias = (None if lin.bias is None
                     else _shard(lin.bias, 0, size, index))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(copy_to_group(x, self.group), self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class RowParallelLinear(nn.Module):
    """nn.Linear with this rank's 1/size of the input features: y = sum over
    the group of x_local W_local^T, then the whole bias added once."""

    tensor_parallel = True

    def __init__(self, lin: nn.Linear, group, size: int, index: int):
        super().__init__()
        self.group = group
        self.weight = _shard(lin.weight, 1, size, index)
        self.bias = (None if lin.bias is None
                     else nn.Parameter(lin.bias.detach().clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_group(F.linear(x, self.weight.to(x.dtype)),
                              self.group)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class VocabParallelEmbedding(nn.Module):
    """An embedding table's rows [start, start + n) of a vocabulary of
    num_embeddings."""

    tensor_parallel = True

    def __init__(self, emb: nn.Embedding, group, size: int, index: int):
        super().__init__()
        self.group = group
        self.num_embeddings = emb.num_embeddings
        self.weight = _shard(emb.weight, 0, size, index)
        self.start = index * self.weight.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the table for ids already within the vocabulary: the
        owner's row, zeros elsewhere, summed over the group."""
        local = ids.long() - self.start
        mine = (local >= 0) & (local < self.weight.shape[0])
        rows = self.weight[local.clamp(0, self.weight.shape[0] - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return reduce_from_group(rows, self.group)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """h [..., H] times the whole table's transpose -> [..., V] in h's
        dtype: this rank's columns computed here, the rest gathered."""
        local = copy_to_group(h, self.group) @ self.weight.to(h.dtype).T
        if self.group is None:
            return local
        full = local.new_zeros((*local.shape[:-1], self.num_embeddings))
        full = full.index_copy(
            -1, torch.arange(self.start, self.start + local.shape[-1],
                             device=local.device), local)
        return reduce_from_group(full, self.group)

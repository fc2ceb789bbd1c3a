"""The rank grid of data and tensor parallelism, on torch.distributed.

Counterpart of hirest_tpu/parallel/mesh.py. The JAX package scales one
controller over a `('data', 'model')` device mesh: batches sharded over
'data', the wide weight matrices over 'model' by path rules, and XLA
inserts the collectives. Here a rank is a process and a device:

- `init_distributed` joins the process group (torchrun's environment, or
  the caller's rank, world size and init_method): NCCL on CUDA, gloo on
  the CPU, each rank bound to `cuda:{LOCAL_RANK}` with no fallback.
- `make_mesh("data:N[,model:M]")` lays the ranks out row-major, as
  `np.array(devices).reshape(sizes)` lays out devices (rank = d * M + m),
  with one process group along each axis: the ranks of one data row share
  a model group (the tensor-parallel collectives), those of one model
  column a data group (the gradient all-reduce). JAX takes the first n of
  more devices; here a rank is a device, so a mesh whose size differs from
  the world size is a ValueError.
- `shard_batch` keeps this rank's rows of every array, `replicate`
  broadcasts rank 0's parameters.
- `TP_RULES` is JAX's table over the port's (the reference's) parameter
  names, as dims of nn.Linear's [out, in] weight: JAX's column-parallel
  P(None, 'model') on an [in, out] kernel is dim 0 here, its row-parallel
  P('model', None) dim 1; an embedding table [V, H] keeps its dim 0.
  `param_shardings` applies them where the dimension divides by the model
  axis, as JAX does; and a q/k/v shard that would split a head, with the
  output projection that reads it, stays replicated (placement only: the
  result is the same). `apply_param_shardings` swaps the matched modules
  for the parallel ones of parallel/tp.py.

JAX's rows for the EVA-CLIP towers (mlp_fc1/fc2, the fused qkv,
token_embedding) are not carried: the port trains MomentModel only, the
towers are frozen feature functions.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

def init_distributed(backend: Optional[str] = None, *,
                     device: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    rank and world_size default to torchrun's RANK and WORLD_SIZE; a
    group is made when either is set (torchrun's one rank too) or an
    init_method is given, and one process without any of them joins none.
    init_method defaults to "env://" (MASTER_ADDR, MASTER_PORT). device: None or "cuda" binds the rank to
    cuda:{LOCAL_RANK}; "cpu", or an explicit "cuda:i", is taken as given.
    The backend is NCCL on CUDA and gloo on the CPU unless named."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    if device in (None, "cuda"):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' "
                               "(CLI: --device cpu) to run on the CPU")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    launched = (world > 1 or init_method is not None
                or "RANK" in os.environ or "WORLD_SIZE" in os.environ)
    if launched and not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank,
            world_size=world)
    return dev


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over the ranks, row-major; `shape` maps an axis to its
    size as JAX's `Mesh.shape` does. An axis the spec leaves out has size 1,
    and its group is None (no collective), as is every group of a
    one-process world."""

    def __init__(self, names: tuple, sizes: tuple):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.rank, world = _world()
        self.devices = np.arange(world).reshape(sizes)
        coords = np.unravel_index(self.rank, sizes)
        self._index = dict(zip(names, (int(c) for c in coords)))
        self._groups: dict = {}
        for i, name in enumerate(names):
            lines = np.moveaxis(self.devices, i, -1).reshape(-1, sizes[i])
            for line in lines:  # every rank makes every group, in one order
                group = (dist.new_group(line.tolist())
                         if world > 1 and sizes[i] > 1 else None)
                if self.rank in line:
                    self._groups[name] = group

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        """This rank's coordinate along axis (0 where the axis is absent)."""
        return self._index.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along axis, or None where
        the line is this rank alone."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def parse_spec(spec: str) -> dict:
    """"data:4,model:2" -> {"data": 4, "model": 2}, in the spec's order."""
    shape: dict = {}
    for part in spec.split(","):
        name, size = part.split(":")
        if name.strip() in shape or int(size) < 1:
            raise ValueError(f"mesh {spec!r}: axes must be distinct and "
                             f"sizes positive")
        shape[name.strip()] = int(size)
    return shape


def make_mesh(spec: Optional[str] = None) -> Mesh:
    """A mesh from a spec like "data:8" or "data:4,model:2" over the ranks
    of the process group (one rank when there is none). With no spec:
    every rank on one 'data' axis. The sizes' product must be the world
    size."""
    _, world = _world()
    if not spec:
        return Mesh(("data",), (world,))
    shape = parse_spec(spec)
    names, sizes = tuple(shape), tuple(shape.values())
    n = int(np.prod(sizes))
    if n != world:
        raise ValueError(f"mesh {spec} needs {n} ranks, the process group "
                         f"has {world} (a rank is a device here)")
    return Mesh(names, sizes)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows, over the 'data' axis, of every array leaf (numpy or
    tensor) with a leading dim; other values pass through untouched. The
    leading dim must divide by the axis."""
    n, i = mesh.size("data"), mesh.index("data")
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            if v.shape[0] % n:
                raise ValueError(
                    f"batch array {k!r} has leading dim {v.shape[0]} not "
                    f"divisible by mesh data axis {n}; enable pad_batch on "
                    "the batcher")
            rows = v.shape[0] // n
            out[k] = v[i * rows:(i + 1) * rows]
        else:
            out[k] = v
    return out


@torch.no_grad()
def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank (broadcast in place)."""
    if mesh.devices.size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


# ---------------------------------------------------------------------------
# Tensor-parallel parameter layout
# ---------------------------------------------------------------------------

# name regex -> the dim sharded over 'model', in torch's layout: 0 for the
# column-parallel up-projections (output features, with their bias) and
# the vocabulary rows, 1 for the row-parallel down-projections (input
# features; their bias stays whole and is added after the reduce)
TP_RULES: list[tuple[str, int]] = [
    # BERT-style blocks: the encoder's attention.self.*, the decoder's
    # slf_attn.att.* and enc_attn.att.*
    (r".*\.(query|key|value)\.weight$", 0),
    (r".*\.(query|key|value)\.bias$", 0),
    (r".*\.(attention\.output|slf_attn\.output|enc_attn\.output)\.dense"
     r"\.weight$", 1),
    (r".*\.intermediate\.dense\.weight$", 0),
    (r".*\.intermediate\.dense\.bias$", 0),
    (r".*\.layer\.\d+\.output\.dense\.weight$", 1),
    # embeddings: the vocabulary rows of the decoder's (tied) table
    (r".*decoder\.embeddings\.word_embeddings\.weight$", 0),
]

_QKV = re.compile(r"(.*)\.(query|key|value)\.(weight|bias)$")
_ATTN_OUT = re.compile(
    r"(.*)\.(attention\.output|slf_attn\.output|enc_attn\.output)\.dense"
    r"\.weight$")


def _head_width(model: nn.Module, prefix: str) -> Optional[int]:
    """The head width of the attention whose q/k/v live under prefix."""
    mod = model.get_submodule(prefix)
    if hasattr(mod, "head_dim"):  # models/layers.py::MultiHeadAttention
        return mod.head_dim
    layer = model.get_submodule(prefix.rsplit(".", 2)[0])  # DecoderLayer
    return layer.hidden_size // layer.heads


def _attention_prefix(name: str) -> Optional[str]:
    m = _QKV.match(name)
    if m:
        return m.group(1)
    m = _ATTN_OUT.match(name)
    if m is None:
        return None
    # the q/k/v that feed this output projection
    return m.group(1) + {"attention.output": ".attention.self",
                         "slf_attn.output": ".slf_attn.att",
                         "enc_attn.output": ".enc_attn.att"}[m.group(2)]


def param_shardings(model: nn.Module, mesh: Mesh) -> dict:
    """{parameter name: the dim sharded over 'model', or None}: the TP
    rules where the mesh has a 'model' axis of more than one rank and the
    dim divides by it, replicated otherwise."""
    m = mesh.size("model")
    out = {}
    for name, p in model.named_parameters():
        out[name] = None
        if m <= 1:
            continue
        for pattern, dim in TP_RULES:
            if re.match(pattern, name):
                if dim < p.dim() and p.shape[dim] % m == 0:
                    out[name] = dim
                break
        prefix = _attention_prefix(name)
        if out[name] is not None and prefix is not None:
            heads = model.get_submodule(prefix + ".query").weight.shape[0] \
                // _head_width(model, prefix)
            if heads % m:  # a shard would split a head
                out[name] = None
    return out


def apply_param_shardings(model: nn.Module, mesh: Mesh) -> dict:
    """Swap the modules whose parameters `param_shardings` shards for the
    tensor-parallel ones (each keeps this rank's slice of the weight) and
    return the shardings. A Linear whose weight and bias disagree is left
    whole."""
    from hirest_tpu_torch.parallel import tp

    shardings = param_shardings(model, mesh)
    group, size, index = (mesh.group("model"), mesh.size("model"),
                          mesh.index("model"))
    for name, mod in list(model.named_modules()):
        dims = {k: shardings.get(f"{name}.{k}") for k, _ in
                mod.named_parameters(recurse=False)}
        if isinstance(mod, nn.Linear):
            w, b = dims.get("weight"), dims.get("bias")
            if w == 0 and (mod.bias is None or b == 0):
                new = tp.ColumnParallelLinear(mod, group, size, index)
            elif w == 1 and b is None:
                new = tp.RowParallelLinear(mod, group, size, index)
            else:
                continue
        elif isinstance(mod, nn.Embedding) and dims.get("weight") == 0:
            new = tp.VocabParallelEmbedding(mod, group, size, index)
        else:
            continue
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, new)
    return shardings

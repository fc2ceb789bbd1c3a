"""Gathering Python objects across ranks.

Counterpart of hirest_tpu/parallel/collectives.py, with its JSON
semantics: each rank's object is serialised to JSON bytes, the lengths are
gathered, the bytes padded to the longest and gathered, and each rank's
bytes decoded, so objects come back JSON-round-tripped (tuples as lists,
keys as strings) as they do in JAX. One process is the identity. The
bytes travel as uint8 tensors on the CPU under gloo and on the current CUDA
device under NCCL.
"""

from __future__ import annotations

import json

import torch
import torch.distributed as dist


def allgather_objects(obj, group=None) -> list:
    """[obj_0, ..., obj_{P-1}] over the ranks of group (the whole world when
    None), in rank order; obj must be JSON-serialisable."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    n = dist.get_world_size(group)
    if n == 1:
        return [obj]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    payload = torch.frombuffer(bytearray(json.dumps(obj).encode("utf-8")),
                               dtype=torch.uint8)
    length = torch.tensor([payload.numel()], dtype=torch.int64,
                          device=device)
    lengths = [torch.empty_like(length) for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    lengths = [int(t.item()) for t in lengths]
    padded = torch.zeros(max(lengths), dtype=torch.uint8, device=device)
    padded[:payload.numel()] = payload.to(device)
    gathered = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(gathered, padded, group=group)
    return [json.loads(t[:m].cpu().numpy().tobytes().decode("utf-8"))
            for t, m in zip(gathered, lengths)]


def merge_prediction_lists(shards: list[dict]) -> dict:
    """Concatenate per-rank accumulator dicts of lists (the shape
    Trainer.predict builds before formatting)."""
    merged: dict = {}
    for shard in shards:
        for key, val in shard.items():
            if isinstance(val, list):
                merged.setdefault(key, []).extend(val)
            else:
                merged[key] = val
    return merged

"""Head-padding weight transform for the EVA vision tower.

Counterpart of hirest_tpu/models/eva_pad.py, on the port's state dict
(nn.Linear's [out, in] layout). Each head's q, k and v rows of the qkv
projection are zero-padded from 88 to 128, the out projection's columns
to match, and the attention-scale correction sqrt(128/88) is folded into
the q rows and q bias. The result is the same model, whose attention runs
at head width 128:

- padded v rows are zero, so the padded output columns are zero and the
  zero columns of the out projection ignore them;
- padded q and k rows are zero, so the scores are unchanged;
- the attention scales by 128^-0.5, so q is pre-multiplied by
  sqrt(128/88) to keep q k * 88^-0.5.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import eva_vision_state_dict


def _pad_heads(w: torch.Tensor, heads: int, old: int, new: int,
               dim: int) -> torch.Tensor:
    """Zero-pad each of `heads` groups of `old` entries along `dim` to
    `new` entries."""
    w = w.movedim(dim, 0)
    grouped = w.reshape(heads, old, *w.shape[1:])
    padded = w.new_zeros((heads, new, *w.shape[1:]))
    padded[:, :old] = grouped
    return padded.reshape(heads * new, *w.shape[1:]).movedim(0, dim)


def pad_vision_head_params(params: Mapping, cfg: EvaVisionConfig,
                           new_head: int = 128):
    """(EVA vision state dict, config) -> (padded state dict, padded config).

    params: reference names, `visual.`-prefixed or bare, tensors or numpy
    arrays; it is not modified. The returned dict holds f32 tensors; the
    config has `head_width=new_head` and `heads_override` = the old head
    count."""
    heads, old = cfg.num_heads, cfg.head_width
    if new_head < old:
        raise ValueError(f"cannot pad head width {old} down to {new_head}")
    scale_fix = float(np.sqrt(new_head / old))
    sd = eva_vision_state_dict(params)
    for i in range(cfg.layers):
        r = f"blocks.{i}.attn"
        q, k, v = sd[f"{r}.qkv.weight"].chunk(3, 0)
        sd[f"{r}.qkv.weight"] = torch.cat(
            [_pad_heads(w, heads, old, new_head, 0)
             for w in (q * scale_fix, k, v)])
        sd[f"{r}.q_bias"] = _pad_heads(sd[f"{r}.q_bias"] * scale_fix, heads,
                                       old, new_head, 0)
        sd[f"{r}.v_bias"] = _pad_heads(sd[f"{r}.v_bias"], heads, old,
                                       new_head, 0)
        sd[f"{r}.proj.weight"] = _pad_heads(sd[f"{r}.proj.weight"], heads,
                                            old, new_head, 1)
    return sd, dataclasses.replace(cfg, head_width=new_head,
                                   heads_override=heads)

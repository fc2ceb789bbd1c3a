"""Optimizers and the LR schedule, with optax's semantics.

Counterpart of hirest_tpu/train/optim.py. The JAX package builds an optax
chain; here the same transformations are plain functions on dicts of
tensors (parameter name -> tensor) with an explicit state, so that a
checkpoint holds the moments, the count and the accumulator as they are:

- `make_optimizer`: the reference's AdamW at a flat base lr with a linear
  warmup-then-decay schedule (trainer_base.py:33-67), optional global-norm
  clipping before it (run.py:265-272) and gradient accumulation
  (run.py:274-295); optax.clip_by_global_norm, optax.adamw and
  optax.MultiSteps, which differ from torch.optim and
  torch.nn.utils.clip_grad_norm_ in the numbers they compute:
  - the schedule is read at optax's count, the number of updates already
    applied, so the first update has lr 0 when warmup > 0;
  - clipping leaves g alone when ||g|| < max_norm and otherwise scales it
    by max_norm / ||g|| (torch divides by ||g|| + 1e-6);
  - AdamW: bias-corrected moments, eps outside the square root, the
    weight decay added to the update before the lr scaling, on every
    parameter;
  - accumulation averages the gradients of k mini-steps (a running mean),
    the inner count advances once per k, and the mini-steps between leave
    the parameters as they are.
- `bert_adam`: the CLIP4Caption pretrain optimizer (reference
  clip4caption/modules/optimization.py:52-167): no bias correction,
  per-tensor clipping by max_norm / (||g|| + 1e-6), the schedule read at
  step / t_total with the step counted from 0, an optional decay mask.

A transformation is `GradientTransformation(init, update)`:
`init(params) -> state` and `update(grads, state, params) -> (updates,
state)`; `apply_updates` adds the updates to the parameters in place. A
parameter without a gradient (autograd's None) takes zeros, as
jax.value_and_grad gives for a parameter the loss does not reach.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional

import torch

Tensors = Mapping[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], dict]
    update: Callable[..., tuple]


def _zeros(params: Tensors) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _count(params: Tensors) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def linear_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int):
    """lr(step) = base * step/warmup for step < warmup, then linear decay to
    0 over the remaining steps (transformers' formula), in f32."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(1.0, float(warmup_steps))
        decay = ((total_steps - s)
                 / max(1.0, float(total_steps - warmup_steps)))
        return base_lr * torch.where(s < warmup_steps, warm,
                                     decay).clamp(0.0, 1.0)

    return schedule


def global_norm(grads: Tensors) -> torch.Tensor:
    """The square root of the sum of every tensor's sum of squares."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        norm_fn: Callable = global_norm) -> dict:
    """optax.clip_by_global_norm: g unchanged when ||g|| < max_norm, else
    (g / ||g||) * max_norm, ||g|| = norm_fn(grads) (`global_norm`; a
    tensor-parallel trainer passes one that counts each shard once).
    Decided on the device: no host sync."""
    g_norm = norm_fn(grads)
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, (g / g_norm) * max_norm)
            for k, g in grads.items()}


def adamw(schedule: Callable, weight_decay: float = 1e-4, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adamw(schedule, weight_decay=...) without a mask: scale_by_adam,
    add_decayed_weights, scale_by_learning_rate. One `count` serves the
    bias correction (read as count + 1) and the schedule (read as count),
    as optax's two counts move together."""

    def init(params: Tensors) -> dict:
        return {"count": _count(params), "mu": _zeros(params),
                "nu": _zeros(params)}

    def update(grads: Tensors, state: dict, params: Tensors):
        count = state["count"]
        count_inc = count + 1
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1 - (one * b1) ** count_inc.float()
        bc2 = 1 - (one * b2) ** count_inc.float()
        step_size = -schedule(count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            updates[k] = step_size * (u + weight_decay * params[k])
        return updates, {"count": count_inc, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def chain_clip(max_norm: float, inner: GradientTransformation,
               norm_fn: Callable = global_norm) -> GradientTransformation:
    """optax.chain(clip_by_global_norm(max_norm), inner): clipping keeps
    no state."""

    def update(grads, state, params):
        return inner.update(clip_by_global_norm(grads, max_norm, norm_fn),
                            state, params)

    return GradientTransformation(inner.init, update)


def multi_steps(inner: GradientTransformation,
                every_k: int) -> GradientTransformation:
    """optax.MultiSteps(inner, every_k_schedule=every_k) with its default
    use_grad_mean: the gradients of every_k mini-steps averaged as a
    running mean (acc + (g - acc) / (n + 1)), the inner transformation
    applied to the mean on the last of them, empty updates (the
    parameters unchanged) on the others. The mini-step counters are
    Python ints: whether a step emits is known on the host."""

    def init(params: Tensors) -> dict:
        return {"mini_step": 0, "gradient_step": 0,
                "inner": inner.init(params), "acc": _zeros(params)}

    def update(grads: Tensors, state: dict, params: Tensors):
        n = state["mini_step"]
        acc = {k: a + (grads[k] - a) / (n + 1)
               for k, a in state["acc"].items()}
        if n != every_k - 1:
            return {}, {**state, "mini_step": n + 1, "acc": acc}
        updates, inner_state = inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "inner": inner_state,
                         "acc": {k: torch.zeros_like(a)
                                 for k, a in acc.items()}}

    return GradientTransformation(init, update)


def make_optimizer(lr: float, warmup_steps: float, total_steps: int,
                   clip_grad_norm: float = -1.0, weight_decay: float = 0.01,
                   accum_steps: int = 1,
                   norm_fn: Callable = global_norm) -> GradientTransformation:
    """The trainer's optimizer. `warmup_steps` < 1 is a ratio of the total
    steps (args.py:35 via trainer_base.py:43-48). weight_decay 0.01 is
    what the reference effectively trains with (torch AdamW's default;
    its --weight_decay flag never reaches the optimizer), and an explicit
    value is honored. norm_fn: the clipping's gradient norm."""
    if warmup_steps < 1:
        warmup = int(total_steps * warmup_steps)
    else:
        warmup = int(warmup_steps)
    tx = adamw(linear_warmup_schedule(lr, warmup, total_steps),
               weight_decay=weight_decay)
    if clip_grad_norm and clip_grad_norm > 0:
        tx = chain_clip(clip_grad_norm, tx, norm_fn)
    if accum_steps > 1:
        tx = multi_steps(tx, accum_steps)
    return tx


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """p += u for every parameter that has an update, in place."""
    for k, u in updates.items():
        params[k].add_(u)


def grads_of(params: Tensors) -> dict:
    """Each parameter's .grad, zeros where autograd left None."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# BertAdam, the CLIP4Caption pretrain optimizer
# ---------------------------------------------------------------------------


def _bert_schedule(name: str):
    def warmup_cosine(x, warmup):
        return torch.where(x < warmup, x / warmup,
                           0.5 * (1.0 + torch.cos(math.pi * x)))

    def warmup_constant(x, warmup):
        return torch.where(x < warmup, x / warmup, torch.ones_like(x))

    def warmup_linear(x, warmup):
        return torch.where(x < warmup, x / warmup,
                           ((x - 1.0) / (warmup - 1.0)).clamp_min(0.0))

    return {"warmup_cosine": warmup_cosine,
            "warmup_constant": warmup_constant,
            "warmup_linear": warmup_linear}[name]


def bert_adam(lr: float, warmup: float = -1.0, t_total: int = -1,
              schedule: str = "warmup_linear", b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-6,
              weight_decay: float = 0.01, max_grad_norm: float = 1.0,
              decay_mask: Optional[Mapping[str, bool]] = None
              ) -> GradientTransformation:
    """BertAdam as one transformation (hirest_tpu/train/optim.py::
    bert_adam): each tensor's gradient clipped by max_grad_norm /
    (||g|| + 1e-6) (at most 1), moments without bias correction, the
    weight decay added to the update before the lr scaling where
    decay_mask says so (None: every tensor), the lr read at step /
    t_total from a step counted from 0 (so warmup_linear's first lr is 0).
    """
    sched = _bert_schedule(schedule)

    def init(params: Tensors) -> dict:
        return {"step": _count(params), "m": _zeros(params),
                "v": _zeros(params)}

    def update(grads: Tensors, state: dict, params: Tensors):
        step = state["step"]
        if t_total != -1:
            lr_t = lr * sched(step.float() / t_total, warmup)
        else:
            lr_t = torch.full((), lr, dtype=torch.float32, device=step.device)
        m, v, updates = {}, {}, {}
        for k, g in grads.items():
            if max_grad_norm > 0:
                norm = torch.sqrt((g.float() * g.float()).sum())
                g = g * (max_grad_norm / (norm + 1e-6)).clamp_max(1.0)
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * g * g
            u = m[k] / (torch.sqrt(v[k]) + eps)
            if weight_decay > 0 and (decay_mask is None or decay_mask[k]):
                u = u + weight_decay * params[k]
            updates[k] = -lr_t * u
        return updates, {"step": step + 1, "m": m, "v": v}

    return GradientTransformation(init, update)

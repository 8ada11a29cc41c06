"""AdamW + cosine schedule + global-norm clipping — the port of
``repro.optim.adamw`` (not ``torch.optim.AdamW``, whose update differs).

The update is the reference's, op for op: gradients clipped by their
global norm (taken in float32), moments kept in each parameter's type,
bias-corrected, and decoupled weight decay on parameters of two or more
dimensions only.  Parameters, moments and the step count stay on the
parameters' device, so a step reads nothing back to the host.  Unlike the
reference (pure functions), ``apply`` updates the parameters and moments
in place: at full width a second copy of each would not fit beside them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate after ``step`` updates (an int or a tensor):
    linear warm-up, then a cosine down to ``min_lr_frac``·lr; float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Zero moments in each parameter's type and shape, step 0 (int32),
    on the parameters' device."""
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
          grads: Dict[str, torch.Tensor], state: Dict[str, object]
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object],
                     Dict[str, torch.Tensor]]:
    """One AdamW update of ``params`` by ``grads`` (both {name: tensor}),
    in place, with ``state`` from ``init`` (its moments in place too).
    -> (params, state with the step advanced, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    for name, p in params.items():
        g = grads[name] * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:       # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p
        p.sub_(lr * u)
    return params, dict(state, step=step), {"grad_norm": gnorm, "lr": lr}

"""AdamW with a cosine schedule and warmup (counterpart of
``repro.training.optimizer``; no ``torch.optim``, whose update rounds in
another order and would hide a difference from the reference).

The optimizer state mirrors the parameters (m and v in f32).  The update is
the reference's: clip by the global norm, bias correction, decoupled weight
decay inside ``delta``; the schedule, the clip scale and the bias
corrections are f32 tensors on the parameters' device (no host sync), and
the update runs in place over all leaves at once (``torch._foreach_*``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.models.model import _leaves


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor           # () int32: updates taken
    m: dict
    v: dict


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int tensor), f32: linear warmup, then a
    cosine from peak_lr down to min_lr_ratio · peak_lr at total_steps."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    # zeros_like: a DTensor parameter's moments are DTensors placed as it is
    return torch.zeros_like(tree, dtype=torch.float32)


def init_opt_state(params) -> OptState:
    dev = next(_leaves(params)).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    _zeros_like_tree(params), _zeros_like_tree(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf after leaf, of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step IN PLACE on ``params`` and ``state``'s m and v (``grads``
    is left as it was).  Returns (params, new state, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    p, m, v = list(_leaves(params)), list(_leaves(state.m)), list(_leaves(state.v))
    g = torch._foreach_mul([x.float() for x in _leaves(grads)], scale)
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_mul_(g, g)                            # g²
    torch._foreach_mul_(g, 1 - cfg.b2)
    torch._foreach_add_(v, g)
    vh = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(vh)
    torch._foreach_add_(vh, cfg.eps)                     # sqrt(v̂) + eps
    delta = torch._foreach_div(m, bc1)                   # m̂
    torch._foreach_div_(delta, vh)
    torch._foreach_add_(delta, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p, delta)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}

"""AdamW with a global-norm clip and LR schedules (counterpart of
``repro.train.optimizer``), with the reference's arithmetic.

Parameters, gradients and the optimizer state are dicts of tensors keyed by
the model's parameter names. The state is ``{"m", "v"}`` f32 dicts plus an
int32 ``step``. ``adamw_update`` updates the parameters and the moments in
place (the reference returns new trees; at a few billion parameters a second
copy of each does not fit beside the first) and returns them.

Weight decay follows the reference's rule, ``p.ndim >= 2`` on the
reference's tree. The reference stacks each layer's leaves on a leading
layer axis, so every per-layer leaf there has rank >= 2 and is decayed, the
norm scales and biases included; only the top-level ``final_norm`` leaves
are rank 1. The port's per-layer tensors lack that axis, so the rank taken
is the reference tree's: one more for a ``layers.*`` name.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | linear | constant
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step: int) -> float:
    s = float(step)
    warm = min(1.0, (s + 1.0) / max(1, cfg.warmup_steps))
    frac = min(max((s - cfg.warmup_steps)
                   / max(1, cfg.total_steps - cfg.warmup_steps), 0.0), 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + math.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def reference_rank(name: str, p: torch.Tensor) -> int:
    """The rank of ``name``'s leaf in the reference's tree (stacked layers)."""
    return p.dim() + 1 if name.startswith("layers.") else p.dim()


def adamw_init(params: Tree) -> Dict:
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    norms = torch._foreach_norm([x.to(torch.float32) for x in tree.values()])
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Tree, grads: Tree,
                 state: Dict) -> Tuple[Tree, Dict, Dict]:
    """One step, in place; returns (params, state, {"grad_norm", "lr"})."""
    step = int(state["step"])
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - b1 ** (step + 1)
    bc2 = 1.0 - b2 ** (step + 1)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * clip
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if reference_rank(name, p) >= 2:       # decoupled decay, reference's rule
            delta.add_(cfg.weight_decay * p.to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * delta)
    state["step"] = state["step"] + 1
    return params, state, {"grad_norm": gnorm, "lr": torch.tensor(lr)}

"""Train-step factory: gradient accumulation over microbatches and the AdamW
update (counterpart of ``repro.train.train_step``).

``grad_sync="auto"`` on one card: the step's gradients are its own (there is
no data-parallel all-reduce to insert yet). The reference's
``grad_sync="int8"`` (compressed reduce-scatter/all-gather over a mesh) and
its mesh arguments are ROADMAP Queue 1 item 6 (M8) and raise here.

Microbatches run one after another, each with its own backward; their
gradients are summed in f32 and multiplied by 1/m, as the reference's
``_accumulate_grads`` does. For f32 parameters the sum is the gradients'
own accumulation in ``.grad``; other dtypes get f32 buffers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.train.optimizer import OptimizerConfig, adamw_init, adamw_update


@dataclass
class TrainState:
    """The model's parameters by name (the model's own tensors, updated in
    place) and the AdamW state."""
    params: Dict[str, torch.Tensor]
    opt: Dict


def init_state(model, gen: torch.Generator, opt_cfg: OptimizerConfig, *,
               grad_sync: str = "auto") -> TrainState:
    """Random weights for ``model`` from ``gen`` and a zero optimizer state."""
    _check_sync(grad_sync)
    model.init(gen)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=adamw_init(params))


def _check_sync(grad_sync: str, mesh=None) -> None:
    if grad_sync == "int8" or mesh is not None:
        raise NotImplementedError(
            "int8 gradient sync and meshes are ROADMAP Queue 1 item 6 (M8); "
            "one card runs grad_sync='auto'")
    if grad_sync != "auto":
        raise ValueError(grad_sync)


def _accumulate_grads(model, batch: Dict, m: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean loss and mean gradients over ``m`` microbatches of ``batch``."""
    tokens = batch["tokens"]
    if tokens.shape[0] % m:
        raise ValueError(f"global batch {tokens.shape[0]} does not split into "
                         f"{m} microbatches")
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    acc: Dict[str, torch.Tensor] = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for mb in tokens.chunk(m):
        loss, _ = model.loss(mb)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        for n, p in params.items():
            if p.dtype != torch.float32:           # f32 accumulator beside it
                acc[n] = p.grad.float() if n not in acc else acc[n].add_(p.grad)
                p.grad = None
    grads = {n: acc.get(n, p.grad) for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if m > 1:
        inv = 1.0 / m
        for g in grads.values():
            g.mul_(inv)
        return loss_sum * inv, grads
    return loss_sum, grads


def make_train_step(model, opt_cfg: OptimizerConfig, *, mesh=None,
                    grad_sync: str = "auto", microbatches: int = 1) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)`` over ``model.loss``;
    ``batch`` is ``{"tokens": (G, T) int}`` on the model's device,
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` (0-d tensors)."""
    _check_sync(grad_sync, mesh)

    def step(state: TrainState, batch: Dict):
        loss, grads = _accumulate_grads(model, batch, microbatches)
        params, opt, om = adamw_update(opt_cfg, state.params, grads, state.opt)
        del grads
        return TrainState(params, opt), {"loss": loss, **om}

    return step

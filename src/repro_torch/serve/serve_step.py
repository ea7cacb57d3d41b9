"""Serving entry points: prefill / decode step factories and a generate loop.

Counterpart of ``repro.serve.serve_step``. PyTorch runs eagerly, so the
factories return plain callables where the reference returns functions to
``jax.jit``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.models.transformer import Model


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """tokens -> (last-position logits, caches)."""
    def prefill(tokens):
        return model.prefill(tokens, max_len)
    return prefill


def make_decode_step(model: Model, *, sample: str = "greedy",
                     temperature: float = 1.0) -> Callable:
    """(tokens, caches, cache_len[, generator]) -> (next_token, logits, caches)."""
    if sample not in ("greedy", "temp"):
        raise ValueError(f"sample must be 'greedy' or 'temp', got {sample!r}")

    def decode(tokens, caches, cache_len: int, generator=None):
        logits, caches = model.decode_step(tokens, caches, cache_len)
        if sample == "greedy":
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt.to(torch.int32), logits, caches
    return decode


def _sync(model: Model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


@torch.inference_mode()
def generate(model: Model, tokens: torch.Tensor, *, steps: int,
             sample: str = "greedy",
             generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Batched greedy/sampled generation from (B, T) prompt tokens.

    Returns (B, steps) int32 tokens: the prefill's argmax, then ``steps - 1``
    decoded ones. If ``timings`` is a dict, it receives ``prefill_s`` and
    ``decode_s``, host-clock seconds each ending in a device synchronize.
    """
    t = tokens.shape[1]
    prefill = make_prefill_step(model, t + steps)
    decode = make_decode_step(model, sample=sample)
    tokens = tokens.to(model.device)
    _sync(model)
    t0 = time.perf_counter()
    logits, caches = prefill(tokens)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    _sync(model)
    t1 = time.perf_counter()
    out = [nxt]
    cache_len = t
    for _ in range(steps - 1):
        tok, _, caches = decode(nxt, caches, cache_len, generator)
        nxt = tok[:, None]
        out.append(nxt)
        cache_len += 1
    result = torch.cat(out, dim=1)
    _sync(model)
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = time.perf_counter() - t1
    return result

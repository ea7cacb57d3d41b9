"""Hymba-style hybrid block: parallel attention and SSM heads (counterpart of
``repro.models.hybrid`` and the hybrid branches of
``repro.models.transformer``).

Attention and a Mamba-1 mixer read the same normed input; their outputs are
normed apart (``norm_a``, ``norm_s``), averaged and added to the residual,
then the MLP follows. Sliding-window attention except in
``cfg.global_layers``. Submodules carry the reference's leaf names, so
``convert.params_from_jax`` loads a hybrid layer as it loads the others.

A layer's cache is ``{"k", "v", "h", "conv"}``: the attention's K/V ring
(``layers.Attention``) and the mixer's state (``mamba.MambaMixer``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, Attention, Cache, Norm
from repro_torch.models.mamba import MambaMixer


class HybridBlock(nn.Module):
    """``x + 0.5 (norm_a(attn(h)) + norm_s(mixer(h)))`` with ``h =
    norm1(x)``, then ``x + mlp(norm2(x))``."""

    def __init__(self, cfg: ModelConfig, window: Optional[int], *, device,
                 dtype):
        super().__init__()

        def norm():
            return Norm(cfg, cfg.d_model, device=device, dtype=dtype)

        self.norm1 = norm()
        self.attn = Attention(cfg, window, device=device, dtype=dtype)
        self.mixer = MambaMixer(cfg, device=device, dtype=dtype)
        self.norm_a, self.norm_s, self.norm2 = norm(), norm(), norm()
        self.mlp = MLP(cfg, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for n in (self.norm1, self.norm_a, self.norm_s, self.norm2):
            n.reset_parameters()
        self.attn.reset_parameters(gen)
        self.mixer.reset_parameters(gen)
        self.mlp.reset_parameters(gen)

    def _merge(self, x, a, s) -> torch.Tensor:
        x = x + 0.5 * (self.norm_a(a) + self.norm_s(s))
        return x + self.mlp(self.norm2(x))

    def forward(self, x, cos, sin) -> torch.Tensor:
        h = self.norm1(x)
        return self._merge(x, self.attn(h, cos, sin)[0], self.mixer(h))

    def prefill(self, x, cos, sin, max_len: int) -> Tuple[torch.Tensor, Cache]:
        h = self.norm1(x)
        a, cache = self.attn(h, cos, sin, max_len)
        s, state = self.mixer.prefill(h)
        return self._merge(x, a, s), {**cache, **state}

    def decode(self, x, cos, sin, cache: Cache, cache_len: int
               ) -> torch.Tensor:
        h = self.norm1(x)
        a = self.attn.decode(h, cos, sin, cache, cache_len)
        return self._merge(x, a, self.mixer.decode(h, cache))

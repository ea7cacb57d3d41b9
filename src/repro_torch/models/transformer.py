"""Decoder LM of the ``dense``, ``ssm`` and ``hybrid`` families (counterpart
of ``repro.models.transformer``).

The reference stacks each segment's layers on a leading axis and runs them
with ``lax.scan``; here the layers are a ``ModuleList`` of blocks
(``DenseBlock`` for ``dense``, ``MambaBlock`` for ``ssm``, ``HybridBlock``
for ``hybrid``) walked by a Python loop. Entry points mirror the reference's
``Model``: ``logits_full`` (teacher-forced), ``prefill`` (last-position
logits plus the caches) and ``decode_step`` (one token against the caches).

Caches are a list with one dict per layer. A dense layer's is ``{"k", "v"}``
(``layers.Attention``: a ring of ``min(max_len, window)`` slots in
sliding-window layers, ``max_len`` in global ones). A mamba layer's is
``{"h": (B, di, S) f32, "conv": (B, K-1, di)}``, whatever ``max_len``. A
hybrid layer's holds all four. ``decode_step`` writes the new position into
the caches in place, where the reference returns updated copies.

``loss`` is the training entry point of all three families. The inference entry
points run under ``torch.no_grad``: they record no graph, whatever the
caller's grad mode.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.hybrid import HybridBlock
from repro_torch.models.layers import (MLP, Attention, Cache, Norm,
                                      chunked_cross_entropy, rope_table)
from repro_torch.models.mamba import MambaMixer


def layer_window(cfg: ModelConfig, i: int) -> Optional[int]:
    """Sliding window of layer i (None = global attention)."""
    return None if (cfg.window is None or i in cfg.global_layers) else cfg.window


class DenseBlock(nn.Module):
    """Pre-norm attention + MLP block."""

    def __init__(self, cfg: ModelConfig, window: Optional[int], *, device,
                 dtype):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg, window, device=device, dtype=dtype)
        self.norm2 = Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.attn.reset_parameters(gen)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(gen)

    def forward(self, x, cos, sin) -> torch.Tensor:
        return self.prefill(x, cos, sin, None)[0]

    def prefill(self, x, cos, sin, max_len: Optional[int]
                ) -> Tuple[torch.Tensor, Cache]:
        a, cache = self.attn(self.norm1(x), cos, sin, max_len)
        x = x + a
        return x + self.mlp(self.norm2(x)), cache

    def decode(self, x, cos, sin, cache: Cache, cache_len: int
               ) -> torch.Tensor:
        x = x + self.attn.decode(self.norm1(x), cos, sin, cache, cache_len)
        return x + self.mlp(self.norm2(x))


class MambaBlock(nn.Module):
    """Pre-norm Mamba-1 block, ``x + mixer(norm1(x))`` (no MLP). It takes
    ``DenseBlock``'s arguments so ``Model`` walks either kind alike; the
    rope tables, ``max_len`` and ``cache_len`` mean nothing to it."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.mixer = MambaMixer(cfg, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.mixer.reset_parameters(gen)

    def forward(self, x, cos, sin) -> torch.Tensor:
        return x + self.mixer(self.norm1(x))

    def prefill(self, x, cos, sin, max_len: int) -> Tuple[torch.Tensor, Cache]:
        out, cache = self.mixer.prefill(self.norm1(x))
        return x + out, cache

    def decode(self, x, cos, sin, cache: Cache, cache_len: int
               ) -> torch.Tensor:
        return x + self.mixer.decode(self.norm1(x), cache)


def _block(cfg: ModelConfig, i: int, **kw) -> nn.Module:
    if cfg.family == "ssm":
        return MambaBlock(cfg, **kw)
    if cfg.family == "hybrid":
        return HybridBlock(cfg, layer_window(cfg, i), **kw)
    return DenseBlock(cfg, layer_window(cfg, i), **kw)


class Model(nn.Module):
    """Config-driven dense, ssm or hybrid LM with teacher-forced / prefill /
    decode entry points. Parameters live on ``device`` in
    ``cfg.param_dtype``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet "
                "(ROADMAP Queue 1: moe M10, audio/vlm M12); 'dense', 'ssm' "
                "and 'hybrid' run")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        pdt = getattr(torch, cfg.param_dtype)
        dev = self.device
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), device=dev, dtype=pdt))
        self.out_embed = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), device=dev, dtype=pdt))
        self.final_norm = Norm(cfg, cfg.d_model, device=dev, dtype=pdt)
        self.layers = nn.ModuleList(_block(cfg, i, device=dev, dtype=pdt)
                                    for i in range(cfg.num_layers))

    # -- init ----------------------------------------------------------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
        """Random weights from ``gen`` (a generator on the model's device)."""
        for emb in (self.embed, self.out_embed):
            if emb is not None:
                emb.copy_(torch.randn(emb.shape, generator=gen,
                                      device=emb.device) * 0.02)
        self.final_norm.reset_parameters()
        for layer in self.layers:
            layer.reset_parameters(gen)
        return self

    # -- helpers ---------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.dtype)

    def _unembed(self) -> torch.Tensor:
        return self.embed if self.out_embed is None else self.out_embed

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self._unembed().to(x.dtype).T

    def _rope(self, b: int, start: int, t: int):
        if self.cfg.attention_free:
            return None, None
        pos = torch.arange(start, start + t, device=self.device)
        return rope_table(self.cfg, pos[None].expand(b, t))

    # -- entry points ------------------------------------------------------------
    def loss(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """Next-token LM loss of (B, T) tokens -> (loss, {"ce", "aux"}).

        Each layer runs under ``torch.utils.checkpoint`` when ``cfg.remat``
        (its activations are recomputed in backward, the reference's
        ``jax.checkpoint`` with ``nothing_saveable``); the CE of
        ``hidden[:, :-1]`` against ``tokens[:, 1:]`` takes ``cfg.loss_chunk``
        tokens per chunk. ``aux`` is 0: no ported family has a router. The
        attention's gradient comes from ``ops.FlashAttention`` and the
        selective scan's from ``ops.SelectiveScan``.
        """
        x = self._embed(tokens)
        cos, sin = self._rope(tokens.shape[0], 0, tokens.shape[1])
        for layer in self.layers:
            if self.cfg.remat:
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = self.final_norm(x)
        ce = chunked_cross_entropy(x[:, :-1], self._unembed(), tokens[:, 1:],
                                   chunk=self.cfg.loss_chunk)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def logits_full(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) for every position."""
        x = self._embed(tokens)
        cos, sin = self._rope(tokens.shape[0], 0, tokens.shape[1])
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self._logits(self.final_norm(x))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, List[Cache]]:
        """Returns (last-position logits (B, V), caches)."""
        x = self._embed(tokens)
        cos, sin = self._rope(tokens.shape[0], 0, tokens.shape[1])
        caches = []
        for layer in self.layers:
            x, cache = layer.prefill(x, cos, sin, max_len)
            caches.append(cache)
        x = self.final_norm(x[:, -1:])
        return self._logits(x)[:, 0], caches

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: List[Cache],
                    cache_len: int) -> Tuple[torch.Tensor, List[Cache]]:
        """tokens (B, 1); ``cache_len`` = positions already cached. Writes the
        new position into ``caches`` in place and returns them."""
        x = self._embed(tokens)
        cos, sin = self._rope(tokens.shape[0], cache_len, 1)
        for layer, cache in zip(self.layers, caches):
            x = layer.decode(x, cos, sin, cache, cache_len)
        return self._logits(self.final_norm(x))[:, 0], caches

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device=device)

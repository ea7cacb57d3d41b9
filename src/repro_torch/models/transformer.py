"""Decoder LM of the ``dense`` and ``ssm`` families (counterpart of
``repro.models.transformer``).

The reference stacks each segment's layers on a leading axis and runs them
with ``lax.scan``; here the layers are a ``ModuleList`` of blocks
(``DenseBlock`` for ``dense``, ``MambaBlock`` for ``ssm``) walked by a Python
loop. Entry points mirror the reference's ``Model``: ``logits_full``
(teacher-forced), ``prefill`` (last-position logits plus the caches) and
``decode_step`` (one token against the caches).

Caches are a list with one dict per layer. A dense layer's is ``{"k", "v"}``,
each (B, size, KV, dh) in the activation dtype, where ``size`` is ``max_len``
for global layers and ``min(max_len, window)`` for sliding-window layers (a
ring: position p sits at slot p % size). A mamba layer's is ``{"h": (B, di, S)
f32, "conv": (B, K-1, di)}``, whatever ``max_len``. ``decode_step`` writes
the new position into the caches in place, where the reference returns
updated copies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (MLP, Attention, Norm, decode_attention,
                                       rope_table)
from repro_torch.models.mamba import MambaMixer

Cache = Dict[str, torch.Tensor]


def layer_window(cfg: ModelConfig, i: int) -> Optional[int]:
    """Sliding window of layer i (None = global attention)."""
    return None if (cfg.window is None or i in cfg.global_layers) else cfg.window


def ring_fill(k: torch.Tensor, v: torch.Tensor, size: int,
              dtype: torch.dtype) -> Cache:
    """A cache of ``size`` slots holding the last ``size`` prefilled K/V
    positions, position p at slot p % size (zeros past the prompt)."""
    t = k.shape[1]
    if t >= size:
        shift = (t - size) % size
        kc = torch.roll(k[:, t - size:], shifts=shift, dims=1)
        vc = torch.roll(v[:, t - size:], shifts=shift, dims=1)
        return {"k": kc.to(dtype), "v": vc.to(dtype)}
    kc = k.new_zeros((k.shape[0], size) + tuple(k.shape[2:]), dtype=dtype)
    vc = v.new_zeros((v.shape[0], size) + tuple(v.shape[2:]), dtype=dtype)
    kc[:, :t] = k
    vc[:, :t] = v
    return {"k": kc, "v": vc}


class DenseBlock(nn.Module):
    """Pre-norm attention + MLP block."""

    def __init__(self, cfg: ModelConfig, window: Optional[int], *, device,
                 dtype):
        super().__init__()
        self.window = window
        self.norm1 = Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.norm2 = Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.attn.reset_parameters(gen)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(gen)

    def _run(self, x, cos, sin
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence block; returns (x, k, v) so prefill can cache k/v."""
        q, k, v = self.attn.qkv(self.norm1(x), cos, sin)
        a = ops.attention(q, k, v, causal=True, window=self.window)
        x = x + self.attn.out(a, x.dtype)
        return x + self.mlp(self.norm2(x)), k, v

    def forward(self, x, cos, sin) -> torch.Tensor:
        return self._run(x, cos, sin)[0]

    def prefill(self, x, cos, sin, max_len: int) -> Tuple[torch.Tensor, Cache]:
        x, k, v = self._run(x, cos, sin)
        size = max_len if self.window is None else min(max_len, self.window)
        return x, ring_fill(k, v, size, x.dtype)

    def decode(self, x, cos, sin, cache: Cache, cache_len: int
               ) -> torch.Tensor:
        q, k, v = self.attn.qkv(self.norm1(x), cos, sin)
        size = cache["k"].shape[1]
        slot = cache_len % size if self.window is not None else cache_len
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        a = decode_attention(q, cache["k"], cache["v"], min(cache_len + 1, size))
        x = x + self.attn.out(a, x.dtype)
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


class Model(nn.Module):
    """Config-driven dense or ssm LM with teacher-forced / prefill / decode
    entry points. Parameters live on ``device`` in ``cfg.param_dtype``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "ssm"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet "
                "(ROADMAP Queue 1: hybrid M11b, moe M10, audio/vlm M12); "
                "'dense' and 'ssm' run")
        if not cfg.attention_free:
            for flag in ("attn_scale_in_q", "attn_probs_bf16"):
                if getattr(cfg, flag):
                    raise NotImplementedError(
                        f"{flag}=True is not ported to repro_torch yet: its "
                        "attention would compute other numbers than the "
                        "reference's (ROADMAP Queue 1)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        pdt = getattr(torch, cfg.param_dtype)
        dev = self.device
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), device=dev, dtype=pdt),
            requires_grad=False)
        self.out_embed = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), device=dev, dtype=pdt),
            requires_grad=False)
        self.final_norm = Norm(cfg, cfg.d_model, device=dev, dtype=pdt)
        self.layers = nn.ModuleList(
            MambaBlock(cfg, device=dev, dtype=pdt) if cfg.family == "ssm"
            else DenseBlock(cfg, layer_window(cfg, i), device=dev, dtype=pdt)
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

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        emb = self.embed if self.out_embed is None else self.out_embed
        return x @ emb.to(x.dtype).T

    def _rope(self, b: int, start: int, t: int):
        if self.cfg.attention_free:
            return None, None
        pos = torch.arange(start, start + t, device=self.device)
        return rope_table(self.cfg, pos[None].expand(b, t))

    # -- entry points ------------------------------------------------------------
    def logits_full(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) for every position."""
        x = self._embed(tokens)
        cos, sin = self._rope(tokens.shape[0], 0, tokens.shape[1])
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self._logits(self.final_norm(x))

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

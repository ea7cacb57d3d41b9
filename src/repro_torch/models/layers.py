"""Building blocks of the dense decoder (counterpart of ``repro.models.layers``).

Conventions, kept from the reference:
  * activations ``x`` are (batch, seq, d_model) in ``cfg.dtype``;
  * parameters are stored in ``cfg.param_dtype`` and cast to the activation
    dtype at every use; norms compute in f32 and cast back;
  * weight layouts are the reference's: ``wq (d, H, dh)``, ``wo (H, dh, d)``,
    ``wi (d, f)``, so converted JAX parameters load as they are.

Prefill attention goes through ``kernels.ops.attention`` with the layer's
window and the config's ``attn_scale_in_q`` / ``attn_probs_bf16``: the CUDA
flash kernel on a card, the plain version on the CPU. Decode attention (one
query position against the cache) is plain PyTorch and reads neither flag,
as in the reference.

Parameters are trainable (``requires_grad``); serving runs under
``torch.inference_mode`` and records no graph. ``chunked_cross_entropy`` is
the training loss.

A layer's K/V cache is ``{"k", "v"}``, each (B, size, KV, dh) in the
activation dtype, where ``size`` is ``max_len`` for global layers and
``min(max_len, window)`` for sliding-window layers (a ring: position p sits
at slot p % size). Decode writes the new position into it in place, where
the reference returns an updated copy.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Cache = Dict[str, torch.Tensor]


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


@torch.no_grad()
def dense_init_(p: torch.Tensor, gen: torch.Generator,
                scale: Optional[float] = None) -> None:
    """N(0, 1/fan_in) init in place; fan_in is prod(shape[:-1]) for a 3-D
    weight (``wq (d, H, dh)`` has fan_in d*H), as in the reference."""
    shape = tuple(p.shape)
    fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    scale = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    p.copy_(torch.randn(shape, generator=gen, device=p.device) * scale)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm (``cfg.norm == "rms"``) or LayerNorm with bias (``"ln"``)."""

    def __init__(self, cfg: ModelConfig, d: int, *, device, dtype,
                 eps: float = 1e-5):
        super().__init__()
        self.kind, self.eps = cfg.norm, eps
        self.scale = _param((d,), device, dtype)
        self.bias = _param((d,), device, dtype) if cfg.norm == "ln" else None

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.kind == "ln":
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            out = ((xf - mu) * torch.rsqrt(var + self.eps) * self.scale.float()
                   + self.bias.float())
        else:
            ms = (xf * xf).mean(-1, keepdim=True)
            out = xf * torch.rsqrt(ms + self.eps) * self.scale.float()
        return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_dim(cfg: ModelConfig) -> int:
    """Dims rotated per head: all (``full``) or the first half (``half``,
    chatglm's partial rotary); 0 for ``none``."""
    return {"full": cfg.head_dim, "half": cfg.head_dim // 2, "none": 0}[cfg.rope]


def rope_table(cfg: ModelConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, T, 1, rot/2) f32, for (B, T) integer positions."""
    rot = rope_dim(cfg)
    exponent = torch.arange(0, rot, 2, dtype=torch.float32,
                            device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exponent)
    theta = positions[..., None].to(torch.float32) * inv
    return torch.cos(theta)[:, :, None, :], torch.sin(theta)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) of the first
    ``rot = 2 * cos.shape[-1]`` dims of each head; the rest pass through.
    This is the reference's pairing, not the rotate-half split."""
    rot = 2 * cos.shape[-1]
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

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


class Attention(nn.Module):
    """Causal GQA attention of one layer, sliding-window when ``window`` is
    set. Projections: ``wq (d, H, dh)``, ``wk/wv (d, KV, dh)``,
    ``wo (H, dh, d)``, optional q/k/v biases."""

    def __init__(self, cfg: ModelConfig, window: Optional[int] = None, *,
                 device, dtype):
        super().__init__()
        self.window = window
        self.flags = dict(scale_in_q=cfg.attn_scale_in_q,
                          probs_bf16=cfg.attn_probs_bf16)
        d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = _param((d, h, dh), device, dtype)
        self.wk = _param((d, kv, dh), device, dtype)
        self.wv = _param((d, kv, dh), device, dtype)
        self.wo = _param((h, dh, d), device, dtype)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = _param((h, dh), device, dtype)
            self.bk = _param((kv, dh), device, dtype)
            self.bv = _param((kv, dh), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, gen)
        h, dh = self.wo.shape[:2]
        dense_init_(self.wo, gen, scale=1.0 / math.sqrt(h * dh))
        if self.qkv_bias:
            for bias in (self.bq, self.bk, self.bv):
                bias.zero_()

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """x (B, T, d) -> rotated q (B,T,H,dh), k (B,T,KV,dh) and v."""
        b, t, d = x.shape
        out = []
        for w, bias in ((self.wq, "bq"), (self.wk, "bk"), (self.wv, "bv")):
            y = (x @ w.to(x.dtype).reshape(d, -1)).reshape(b, t, *w.shape[1:])
            if self.qkv_bias:
                y = y + getattr(self, bias).to(x.dtype)
            out.append(y)
        q, k, v = out
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, a: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
        b, t, h, dv = a.shape
        wo = self.wo.to(a.dtype).reshape(h * dv, -1)
        return (a.reshape(b, t, h * dv) @ wo).to(x_dtype)

    def forward(self, x: torch.Tensor, cos, sin,
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """Full-sequence attention of x (B, T, d) -> (out (B, T, d), the
        layer's K/V cache for ``max_len`` positions, or {} when None)."""
        q, k, v = self.qkv(x, cos, sin)
        a = ops.attention(q, k, v, causal=True, window=self.window, **self.flags)
        cache = {}
        if max_len is not None:
            size = max_len if self.window is None else min(max_len, self.window)
            cache = ring_fill(k, v, size, x.dtype)
        return self.out(a, x.dtype), cache

    def decode(self, x: torch.Tensor, cos, sin, cache: Cache,
               cache_len: int) -> torch.Tensor:
        """One position x (B, 1, d) at ``cache_len``; writes its K/V into
        ``cache`` (a ring slot for windowed layers) and attends over the
        ``min(cache_len + 1, size)`` valid slots."""
        q, k, v = self.qkv(x, cos, sin)
        size = cache["k"].shape[1]
        slot = cache_len % size if self.window is not None else cache_len
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        a = decode_attention(q, cache["k"], cache["v"], min(cache_len + 1, size))
        return self.out(a, x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Attention of q (B, Tq, H, dh) against a (B, S, KV, dh) cache whose
    first ``cache_len`` positions are valid."""
    b, tq, h, dh = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, dh)
    s = (torch.einsum("bthgd,bshd->bthgs", qg, k_cache).to(torch.float32)
         * (1.0 / math.sqrt(dh)))
    valid = torch.arange(k_cache.shape[1], device=q.device) < cache_len
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bthgs,bshd->bthgd", p, v_cache)
    return out.reshape(b, tq, h, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``wi (d, f)``, ``wg (d, f)`` (swiglu only), ``wo (f, d)``; swiglu or
    squared ReLU, the dense archs' two kinds."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        if cfg.mlp not in ("swiglu", "sqrelu"):
            raise ValueError(f"mlp {cfg.mlp!r} is not ported (swiglu, sqrelu)")
        d, f = cfg.d_model, cfg.d_ff
        self.kind = cfg.mlp
        self.wi = _param((d, f), device, dtype)
        self.wg = _param((d, f), device, dtype) if cfg.mlp == "swiglu" else None
        self.wo = _param((f, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            if w is not None:
                dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi.to(x.dtype)
        if self.kind == "swiglu":
            h = F.silu(h) * (x @ self.wg.to(x.dtype))
        else:
            h = torch.relu(h) ** 2
        return h @ self.wo.to(x.dtype)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _chunk_ce(h: torch.Tensor, et: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    logits = (h @ et).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return ((logz - gold) * mask).sum()


def chunked_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 2048,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE without holding the full (tokens, vocab) logits.

    hidden: (B, T, d); embed: (V, d); labels: (B, T) integers; mask (B, T) or
    None. The logits of each ``chunk`` tokens are taken in hidden's dtype
    against ``embed`` cast to it, widened to f32, and their (chunk, V) block
    is recomputed in backward instead of kept (``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint`` of its scan step). The last chunk may
    be shorter; the reference pads it with zero-mask rows, which add nothing.
    """
    b, t, d = hidden.shape
    n = b * t
    hf = hidden.reshape(n, d)
    lf = labels.reshape(n).long()
    mf = (torch.ones((n,), dtype=torch.float32, device=hidden.device)
          if mask is None else mask.reshape(n).to(torch.float32))
    et = embed.to(hidden.dtype).T                # (d, V)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n, chunk):
        total = total + checkpoint(_chunk_ce, hf[i:i + chunk], et, lf[i:i + chunk],
                                   mf[i:i + chunk], use_reentrant=False)
    return total / torch.clamp(mf.sum(), min=1.0)

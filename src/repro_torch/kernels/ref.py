"""Plain PyTorch versions of the kernels (the correctness ground truth).

Counterparts of ``repro.kernels.ref``: deliberately naive, device-agnostic.
The CPU path runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dequant_ref(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """q: (N, F) int8; scales: (N, F//block) f16/f32 -> (N, F) out_dtype.

    The product is taken in f32 and rounded once to ``out_dtype``
    (round-to-nearest-even), the same arithmetic as the CUDA kernel.
    """
    n, f = q.shape
    xb = q.reshape(n, f // block, block).to(torch.float32)
    out = xb * scales.to(torch.float32)[..., None]
    return out.reshape(n, f).to(out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax attention. q: (B,Tq,H,dh); k,v: (B,Tk,KV,*).

    Query head h reads kv head h // (H/KV). When Tq != Tk the query block is
    aligned to the end of the keys. Probabilities are rounded to v's dtype
    before the product with v, as in the reference.
    """
    b, tq, h, dh = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, tq, kv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32) * scale
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos + (tk - tq)     # align ends if tq != tk
    if window is not None:
        mask &= (qpos + (tk - tq) - kpos) < window
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, tq, h, v.shape[-1])

"""Mamba-1 mixer of the ``ssm`` family (counterpart of ``repro.models.mamba``).

x -> in_proj -> (u, z); u -> causal depthwise conv -> silu -> selective scan
-> y; out = out_proj(y * silu(z)), with dt = softplus(dt_proj(dt_lowrank) +
dt_bias) and (dt_lowrank, B, C) = x_proj(u).

Parameter names and layouts are the reference's (``in_proj (d, 2 di)``,
``conv_w (K, di)``, ``x_proj (di, dt_rank + 2 S)``, ``dt_proj (dt_rank, di)``,
``a_log (di, S)``, ...), so converted JAX parameters load as they are.

The full-sequence scan goes through ``kernels.ops.ssm_scan``: the CUDA kernel
on a card, the plain version on the CPU (the JAX models call their lax scan
instead); under grad its backward is the scan's backward kernel (K3b) on a
card, the plain reverse loop on the CPU. Decode is the one-step recurrence on the carried state, as plain
tensor ops (``kernels.ref.ssm_scan_ref`` over one step from the cached h).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import _param, dense_init_

Cache = Dict[str, torch.Tensor]


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. u: (B, T, di); w: (K, di); b: (di,).

    ``state`` (B, K-1, di) is the carried context (zeros when None). Returns
    (out, new_state), new_state being the last K-1 inputs, pre-activation,
    left-padded with the old state when T < K-1. The K shifted
    multiply-adds run in u's dtype, in the reference's order.
    """
    k = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    ext = torch.cat([state, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + ext[:, i:i + u.shape[1]] * w[i].to(u.dtype)
    return out + b.to(u.dtype), ext[:, ext.shape[1] - (k - 1):]


class MambaMixer(nn.Module):
    """The Mamba-1 block's mixer with full-sequence, prefill and decode
    entry points. Parameters are stored in ``dtype`` and cast to the
    activation dtype at every use, as in the reference."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
        dtr = cfg.dt_rank or max(1, math.ceil(d / 16))
        self.ssm_state, self.dt_rank = st, dtr
        self.in_proj = _param((d, 2 * di), device, dtype)
        self.conv_w = _param((cfg.ssm_conv, di), device, dtype)
        self.conv_b = _param((di,), device, dtype)
        self.x_proj = _param((di, dtr + 2 * st), device, dtype)
        self.dt_proj = _param((dtr, di), device, dtype)
        self.dt_bias = _param((di,), device, dtype)
        self.a_log = _param((di, st), device, dtype)
        self.d_skip = _param((di,), device, dtype)
        self.out_proj = _param((di, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's init (``mamba_params``), drawn from ``gen``."""
        k, di = self.conv_w.shape
        dense_init_(self.in_proj, gen)
        dense_init_(self.conv_w, gen, scale=1.0 / math.sqrt(k))
        self.conv_b.zero_()
        dense_init_(self.x_proj, gen)
        dense_init_(self.dt_proj, gen, scale=self.dt_rank ** -0.5)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt0 = torch.exp(torch.rand((di,), generator=gen, device=gen.device)
                        * (hi - lo) + lo).clamp(min=1e-4)
        self.dt_bias.copy_(torch.log(torch.expm1(dt0)))
        a = torch.arange(1, self.ssm_state + 1, dtype=torch.float32,
                         device=self.a_log.device)
        self.a_log.copy_(torch.log(a).expand(di, -1))
        self.d_skip.fill_(1.0)
        dense_init_(self.out_proj, gen)

    def _scan_inputs(self, x: torch.Tensor, conv_state: Optional[torch.Tensor]):
        """in_proj, conv, silu, x_proj and dt: returns (u, dt, B, C, z, the
        conv's new state)."""
        u, z = (x @ self.in_proj.to(x.dtype)).chunk(2, dim=-1)
        u, conv = causal_conv(u, self.conv_w, self.conv_b, conv_state)
        u = F.silu(u)
        proj = u @ self.x_proj.to(u.dtype)
        dt_lr, b_in, c_in = proj.split(
            [self.dt_rank, self.ssm_state, self.ssm_state], dim=-1)
        dt = F.softplus(dt_lr @ self.dt_proj.to(u.dtype)
                        + self.dt_bias.to(u.dtype))
        return u, dt, b_in.contiguous(), c_in.contiguous(), z, conv

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        y = y.to(z.dtype) * F.silu(z)
        return y @ self.out_proj.to(z.dtype)

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """x (B, T, d) -> (out (B, T, d), {"h": (B, di, S) f32,
        "conv": (B, K-1, di)}), the state after the last position."""
        u, dt, b_in, c_in, z, conv = self._scan_inputs(x, None)
        y, h = ops.ssm_scan(u, dt, b_in, c_in, self.a_log, self.d_skip)
        # the tail is a view of the padded input; copy it so that is freed
        conv = conv.clone(memory_format=torch.contiguous_format)
        return self._out(y, z), {"h": h, "conv": conv}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence mixer. x (B, T, d) -> (B, T, d)."""
        return self.prefill(x)[0]

    def decode(self, x: torch.Tensor, cache: Cache) -> torch.Tensor:
        """One token x (B, 1, d); updates ``cache`` in place."""
        u, dt, b_in, c_in, z, conv = self._scan_inputs(x, cache["conv"])
        y, h = ref.ssm_scan_ref(u, dt, b_in, c_in, self.a_log, self.d_skip,
                                h0=cache["h"])
        cache["conv"].copy_(conv)
        cache["h"].copy_(h)
        return self._out(y, z)

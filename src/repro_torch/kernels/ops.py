"""Dispatch between each CUDA kernel and its plain PyTorch version.

Counterpart of ``repro.kernels.ops``. ``impl``:
  * ``None`` (auto): the kernel for CUDA tensors, the plain version for CPU
    tensors — chosen by where the tensors lie, nothing else;
  * ``"kernel"``: the CUDA kernel; raises for tensors that are not on a card;
  * ``"ref"``: the plain version on any device (what the kernels are held to).
There is no fallback: a CUDA tensor goes to the kernel, which launches or
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dequant import dequant as dequant_kernel
from repro_torch.kernels.flash_attn import flash_attention as flash_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel


def _pick(t: torch.Tensor, impl: Optional[str]) -> str:
    impl = impl or ("kernel" if t.is_cuda else "ref")
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel', 'ref' or None, got {impl!r}")
    return impl


def dequant(q, scales, *, qblock: int = 256, out_dtype=torch.bfloat16,
            impl: Optional[str] = None) -> torch.Tensor:
    if _pick(q, impl) == "ref":
        return ref.dequant_ref(q, scales, block=qblock, out_dtype=out_dtype)
    return dequant_kernel(q, scales, qblock=qblock, out_dtype=out_dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, scale_in_q: bool = False,
              probs_bf16: bool = False,
              impl: Optional[str] = None) -> torch.Tensor:
    flags = dict(causal=causal, window=window, scale=scale,
                 scale_in_q=scale_in_q, probs_bf16=probs_bf16)
    if _pick(q, impl) == "ref":
        return ref.attention_ref(q, k, v, **flags)
    return flash_kernel(q, k, v, **flags)


def ssm_scan(u, dt, b_in, c_in, a_log, d_skip, *,
             impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from a zero state -> (y (B, T, D) f32, h_final (B, D, S) f32)."""
    if _pick(u, impl) == "ref":
        return ref.ssm_scan_ref(u, dt, b_in, c_in, a_log, d_skip)
    return ssm_kernel(u, dt, b_in, c_in, a_log, d_skip)

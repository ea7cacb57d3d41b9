"""Causal GQA flash attention (forward): the prefill attention kernel.

Wrapper of ``csrc/flash_attn_fwd.cu`` (counterpart of
``repro.kernels.flash_attn``). It launches the CUDA kernel on CUDA tensors
and refuses anything else; the plain version is ``kernels.ref.attention_ref``
and ``kernels.ops.attention`` picks between them by the tensors' device.
``flash_attention.launches`` counts kernel launches.

Contract (the TPU kernel's, minus its tiling constraint): q (B, T, H, dh),
k (B, T, KV, dh), v (B, T, KV, dv) -> (B, T, H, dv) in q's dtype; H % KV == 0;
``Tq == Tk``; f32 with dh, dv <= 128, or bf16 with dh == dv in
{16, 32, 64, 128}. Any T works: the kernel masks the ragged last tile itself.
bf16 runs on Hopper's wgmma with q, k, v staged by TMA, whose tensor maps
need 16-byte aligned base addresses and strides that are multiples of 16
bytes; the wrapper checks both. ``scale_in_q`` and ``probs_bf16`` are the
reference's attention flags, with ``kernels.ref.attention_ref``'s arithmetic.
``return_lse`` also returns each row's log-sum-exp (B, H, T) f32, which the
backward kernel (``kernels.flash_attn_bwd``) recomputes P from; it is
written only without the flags, and only then is the kernel instance that
stores it launched.

The kernel computes no gradient: under autograd, inputs that require one are
refused here, and ``kernels.ops.attention`` (an autograd Function with the
backward kernel) is the way to differentiate attention.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
BF16_HEAD_DIMS = (16, 32, 64, 128)
_IS_BF16 = {torch.bfloat16: 1, torch.float32: 0}
_ERR_ENCODE, _ERR_NO_ENCODE = 10000, 20000     # the C entry point's own codes


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, scale_in_q: bool = False,
                    probs_bf16: bool = False, return_lse: bool = False):
    """q: (B, T, H, dh); k, v: (B, T, KV, dh/dv), H % KV == 0 -> (B, T, H, dv),
    and with ``return_lse`` also lse (B, H, T) f32."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention computes no gradient: differentiate "
                         "through kernels.ops.attention")
    if return_lse and (scale_in_q or probs_bf16):
        raise ValueError("the LSE is written only without the attention flags")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _IS_BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share dtype bf16 or f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, T, heads, head_dim)")
    b, t, h, dh = q.shape
    kv, dv = k.shape[2], v.shape[-1]
    if k.shape[1] != t:
        raise ValueError(f"flash_attention needs Tq == Tk, got {t} and {k.shape[1]}")
    if tuple(k.shape) != (b, t, kv, dh) or tuple(v.shape[:3]) != (b, t, kv):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"H={h} must be a multiple of KV={kv}")
    if not (0 < dh <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must be in 1..{MAX_HEAD_DIM}, got {dh}, {dv}")
    if q.dtype == torch.bfloat16 and not (dh == dv and dh in BF16_HEAD_DIMS):
        raise ValueError(f"bf16 head dims must be equal and in {BF16_HEAD_DIMS}, "
                         f"got {dh}, {dv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(st * 2 % 16 for st in x.stride()[:-1])
            for x in (q, k, v)):
        raise ValueError("bf16 q, k, v need 16-byte aligned base addresses and "
                         "strides that are multiples of 16 bytes (TMA tensor maps)")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out     # nothing to launch
    counter = torch.zeros((1,), dtype=torch.int32, device=q.device)  # work items
    err = _lib().flash_attn_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, counter.data_ptr(),
        b, t, h, kv, dh, dv, scale, int(causal), window or 0, int(scale_in_q),
        int(probs_bf16), _IS_BF16[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _ERR_ENCODE:
        raise RuntimeError(
            "flash_attention: the driver has no cuTensorMapEncodeTiled"
            if err >= _ERR_NO_ENCODE else
            f"flash_attention: cuTensorMapEncodeTiled refused a map (CUresult "
            f"{err - _ERR_ENCODE})")
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0

"""Dispatch between each CUDA kernel and its plain PyTorch version.

Counterpart of ``repro.kernels.ops``. ``impl``:
  * ``None`` (auto): the kernel for CUDA tensors, the plain version for CPU
    tensors — chosen by where the tensors lie, nothing else;
  * ``"kernel"``: the CUDA kernel; raises for tensors that are not on a card;
  * ``"ref"``: the plain version on any device (what the kernels are held to).
There is no fallback: a CUDA tensor goes to the kernel, which launches or
raises.

``attention`` is differentiable: when autograd needs a gradient of q, k or v
it runs ``FlashAttention``, whose forward also keeps the row log-sum-exp and
whose backward is the backward kernel (or ``ref.attention_bwd_ref``, picked
the same way). Otherwise (``torch.no_grad``, ``torch.inference_mode``, or no
input that requires a gradient) it calls the forward kernel as serving
does, with no LSE and nothing saved. ``ssm_scan`` is differentiable the same
way: under grad it runs ``SelectiveScan``, whose forward is the scan kernel
(K3) and whose backward is the scan's backward kernel (K3b, or
``ref.ssm_scan_bwd_ref``); otherwise it calls K3 as serving does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dequant import dequant as dequant_kernel
from repro_torch.kernels.flash_attn import flash_attention as flash_kernel
from repro_torch.kernels.flash_attn_bwd import flash_attention_bwd as flash_bwd_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd as ssm_bwd_kernel


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


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward kernel (writing the LSE) and
    the backward kernel on a card, ``attention_ref`` and
    ``attention_bwd_ref`` on the CPU (``impl`` as in ``attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, impl):
        flags = dict(causal=causal, window=window, scale=scale)
        if impl == "ref":
            o, lse = ref.attention_ref(q, k, v, return_lse=True, **flags)
        else:
            o, lse = flash_kernel(q, k, v, return_lse=True, **flags)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flags, ctx.impl = flags, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = ref.attention_bwd_ref if ctx.impl == "ref" else flash_bwd_kernel
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.flags)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, scale_in_q: bool = False,
              probs_bf16: bool = False,
              impl: Optional[str] = None) -> torch.Tensor:
    impl = _pick(q, impl)
    if _needs_grad(q, k, v):
        if scale_in_q or probs_bf16:
            raise NotImplementedError(
                "the attention flags scale_in_q and probs_bf16 have no backward "
                "yet (ROADMAP Queue 1 item 3)")
        return FlashAttention.apply(q, k, v, causal, window, scale, impl)
    flags = dict(causal=causal, window=window, scale=scale,
                 scale_in_q=scale_in_q, probs_bf16=probs_bf16)
    if impl == "ref":
        return ref.attention_ref(q, k, v, **flags)
    return flash_kernel(q, k, v, **flags)


class SelectiveScan(torch.autograd.Function):
    """The selective scan with its gradient: K3 forward and K3b backward on a
    card, ``ssm_scan_ref`` and ``ssm_scan_bwd_ref`` on the CPU (``impl`` as
    in ``attention``). The forward saves its inputs and, on a card, K3's
    checkpoints of h (every 8th step), from which K3b recomputes the states
    in between. The cotangent of h_final seeds the reverse scan; autograd
    passes None for it when h_final is unused (the training loss)."""

    @staticmethod
    def forward(ctx, u, dt, b_in, c_in, a_log, d_skip, impl):
        ck = None
        if impl == "ref":
            y, h = ref.ssm_scan_ref(u, dt, b_in, c_in, a_log, d_skip)
        else:
            y, h, ck = ssm_kernel(u, dt, b_in, c_in, a_log, d_skip, checkpoints=True)
        ctx.save_for_backward(u, dt, b_in, c_in, a_log, d_skip, ck)
        ctx.impl = impl
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        *saved, ck = ctx.saved_tensors     # unpacked once (remat allows no more)
        u = saved[0]
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        dh = None if dh is None else dh.contiguous()
        if ctx.impl == "ref":
            grads = ref.ssm_scan_bwd_ref(*saved, dy.contiguous(), dh)
        else:
            grads = ssm_bwd_kernel(*saved, dy.contiguous(), dh, h_checkpoints=ck)
        return (*grads, None)


def ssm_scan(u, dt, b_in, c_in, a_log, d_skip, *,
             impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from a zero state -> (y (B, T, D) f32, h_final (B, D, S) f32)."""
    impl = _pick(u, impl)
    if _needs_grad(u, dt, b_in, c_in, a_log, d_skip):
        return SelectiveScan.apply(u, dt, b_in, c_in, a_log, d_skip, impl)
    if impl == "ref":
        return ref.ssm_scan_ref(u, dt, b_in, c_in, a_log, d_skip)
    return ssm_kernel(u, dt, b_in, c_in, a_log, d_skip)

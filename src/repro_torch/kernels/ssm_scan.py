"""Mamba-1 selective scan: the ssm prefill kernel.

Wrapper of ``csrc/ssm_scan.cu`` (counterpart of ``repro.kernels.ssm_scan``).
It launches the CUDA kernel on CUDA tensors and refuses anything else; the
plain version is ``kernels.ref.ssm_scan_ref`` and ``kernels.ops.ssm_scan``
picks between them by the tensors' device. ``ssm_scan.launches`` counts
kernel launches.

Contract (the TPU kernel's, minus its tiling constraint): u, dt (B, T, D) and
b_in, c_in (B, T, S) in one dtype, bf16 or f32; a_log (D, S) and d_skip (D,)
in one dtype, bf16 or f32; 1 <= S <= 16; zero initial state. Returns y
(B, T, D) f32 and h_final (B, D, S) f32. Any T and D work: the kernel masks
the ragged tails itself. Every tensor is contiguous and 16-byte aligned, the
contract the port's kernels share. The kernel has no backward: under
autograd, inputs that need a gradient are refused, not silently cut off.
With ``checkpoints=True`` it also returns h after every ``CKPT``-th step
that a step follows, (floor((T - 1) / CKPT), B, D, 16) f32 in state order
(zero past S): the states from which the backward kernel
(``kernels.ssm_scan_bwd``) recomputes those in between.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 16
CKPT = 8                    # steps between the checkpoints of h (csrc: CKH)
_IS_BF16 = {torch.bfloat16: 1, torch.float32: 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
             c_in: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor, *,
             checkpoints: bool = False) -> Tuple[torch.Tensor, ...]:
    """u, dt: (B, T, D); b_in, c_in: (B, T, S); a_log: (D, S); d_skip: (D,).

    Returns (y (B, T, D) f32, h_final (B, D, S) f32), and the checkpoints of
    h (see the module's contract) after them if ``checkpoints``.
    """
    args = (u, dt, b_in, c_in, a_log, d_skip)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        raise NotImplementedError(
            "the K3 wrapper is forward only; call kernels.ops.ssm_scan, whose "
            "autograd Function (SelectiveScan) carries the gradient")
    if not (u.is_cuda and all(x.device == u.device for x in args)):
        raise ValueError("ssm_scan kernel needs every input on one CUDA device "
                         f"(got {[str(x.device) for x in args]})")
    if (u.dtype not in _IS_BF16 or any(x.dtype != u.dtype for x in args[1:4])
            or a_log.dtype not in _IS_BF16 or d_skip.dtype != a_log.dtype):
        raise ValueError("u, dt, b_in, c_in must share dtype bf16 or f32 and "
                         "a_log, d_skip likewise, got "
                         f"{[str(x.dtype) for x in args]}")
    if u.dim() != 3 or b_in.dim() != 3:
        raise ValueError("u and b_in must be 3-D (B, T, D) and (B, T, S)")
    b, t, d = u.shape
    s = b_in.shape[-1]
    want = ((b, t, d), (b, t, d), (b, t, s), (b, t, s), (d, s), (d,))
    if any(tuple(x.shape) != w for x, w in zip(args, want)):
        raise ValueError(f"shapes {[tuple(x.shape) for x in args]} do not match "
                         f"u {(b, t, d)} with S={s}")
    if not 1 <= s <= MAX_STATE:
        raise ValueError(f"S must be in 1..{MAX_STATE}, got {s}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("ssm_scan inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in args):
        raise ValueError("ssm_scan inputs must be 16-byte aligned")
    y = torch.empty((b, t, d), dtype=torch.float32, device=u.device)
    h = torch.empty((b, d, s), dtype=torch.float32, device=u.device)
    ck = torch.empty((max(t - 1, 0) // CKPT, b, d, MAX_STATE), dtype=torch.float32,
                     device=u.device) if checkpoints else None
    out = (y, h) if ck is None else (y, h, ck)
    if u.numel() == 0:
        h.zero_()                        # nothing to launch: the zero state
        return out
    err = _lib().ssm_scan_launch(
        *(x.data_ptr() for x in args), y.data_ptr(), h.data_ptr(),
        ck.data_ptr() if ck is not None and ck.numel() else None, b, t, d, s,
        _IS_BF16[u.dtype], _IS_BF16[a_log.dtype],
        torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0

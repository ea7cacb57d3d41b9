"""Backward of the Mamba-1 selective scan (K3b) for ssm and hybrid training.

Wrapper of ``csrc/ssm_scan_bwd.cu``. It has no TPU twin: the JAX package
differentiates its lax scan (``repro.models.mamba.selective_scan``) with
``jax.grad``. It launches the CUDA kernels on CUDA tensors and refuses
anything else; the plain version is ``kernels.ref.ssm_scan_bwd_ref``, and
``kernels.ops.SelectiveScan`` picks between them by the tensors' device.
``ssm_scan_bwd.launches`` counts calls that launch (each call is the main
kernel and the small kernel that sums its partials).

Contract: K3's inputs (u, dt (B, T, D) and b_in, c_in (B, T, S) in one
dtype, bf16 or f32; a_log (D, S) and d_skip (D,) in one dtype, bf16 or f32;
1 <= S <= 16), dy (B, T, D) f32, the cotangent of K3's f32 y, and dh_final
(B, D, S) f32 or None (a zero cotangent of h_final). Every tensor is
contiguous and 16-byte aligned. Returns (du, ddt, dB, dC) in u's dtype and
(da_log, dD) in a_log's. The wrapper allocates the kernels' f32 scratch: h
at every 16th step (B*D*S floats a chunk) and the per-block partial sums.
Two calls on the same inputs give the same bits (no atomics).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 16
CHUNK = 16                  # steps between the checkpoints of h (csrc: K)
BLOCK_CHANNELS = 64         # channels a block sums dB and dC over (csrc: CB)
_IS_BF16 = {torch.bfloat16: 1, torch.float32: 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan_bwd")
    fn = lib.ssm_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ssm_scan_bwd(u: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                 c_in: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                 dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Returns (du, ddt, dB, dC, da_log, dD); see the module's contract."""
    args = (u, dt, b_in, c_in, a_log, d_skip, dy)
    every = args if dh_final is None else args + (dh_final,)
    if not (u.is_cuda and all(x.device == u.device for x in every)):
        raise ValueError("ssm_scan_bwd kernel needs every input on one CUDA "
                         f"device (got {[str(x.device) for x in every]})")
    if (u.dtype not in _IS_BF16 or any(x.dtype != u.dtype for x in args[1:4])
            or a_log.dtype not in _IS_BF16 or d_skip.dtype != a_log.dtype
            or dy.dtype != torch.float32
            or (dh_final is not None and dh_final.dtype != torch.float32)):
        raise ValueError("u, dt, b_in, c_in must share dtype bf16 or f32, "
                         "a_log, d_skip likewise, and dy, dh_final be f32; got "
                         f"{[str(x.dtype) for x in every]}")
    if u.dim() != 3 or b_in.dim() != 3:
        raise ValueError("u and b_in must be 3-D (B, T, D) and (B, T, S)")
    b, t, d = u.shape
    s = b_in.shape[-1]
    want = ((b, t, d), (b, t, d), (b, t, s), (b, t, s), (d, s), (d,), (b, t, d),
            (b, d, s))
    if any(tuple(x.shape) != w for x, w in zip(every, want)):
        raise ValueError(f"shapes {[tuple(x.shape) for x in every]} do not "
                         f"match u {(b, t, d)} with S={s}")
    if not 1 <= s <= MAX_STATE:
        raise ValueError(f"S must be in 1..{MAX_STATE}, got {s}")
    if not all(x.is_contiguous() for x in every):
        raise ValueError("ssm_scan_bwd inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in every):
        raise ValueError("ssm_scan_bwd inputs must be 16-byte aligned")
    dev = u.device
    outs = (torch.empty_like(u), torch.empty_like(dt), torch.empty_like(b_in),
            torch.empty_like(c_in), torch.empty_like(a_log),
            torch.empty_like(d_skip))
    if u.numel() == 0:                  # nothing to launch: no step, no channel
        for x in outs:
            x.zero_()
        return outs
    nblk = -(-d // BLOCK_CHANNELS)
    f32 = dict(dtype=torch.float32, device=dev)
    ck = torch.empty(max(1, (-(-t // CHUNK) - 1) * b * d * s), **f32)
    part_bc = torch.empty(2 * nblk * b * t * s, **f32)
    part_da = torch.empty(b * d * s, **f32)
    part_dd = torch.empty(b * d, **f32)
    err = _lib().ssm_scan_bwd_launch(
        *(x.data_ptr() for x in args),
        None if dh_final is None else dh_final.data_ptr(),
        *(x.data_ptr() for x in outs), ck.data_ptr(), part_bc.data_ptr(),
        part_da.data_ptr(), part_dd.data_ptr(), b, t, d, s, _IS_BF16[u.dtype],
        _IS_BF16[a_log.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssm_scan_bwd")
    ssm_scan_bwd.launches += 1
    return outs


ssm_scan_bwd.launches = 0

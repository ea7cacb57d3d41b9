"""Blockwise int8 -> bf16/f32 dequantization: the device tier's decode kernel.

Wrapper of ``csrc/dequant.cu`` (counterpart of ``repro.kernels.dequant``):
``out[n, f] = q[n, f] * scales[n, f // qblock]`` computed in f32. It launches
the CUDA kernel on CUDA tensors and refuses anything else; the plain version
is ``kernels.ref.dequant_ref`` and ``kernels.ops.dequant`` picks between them
by the tensors' device. ``dequant.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

QBLOCK = 256     # elements per quantization scale block

_OUT = {torch.bfloat16: 1, torch.float32: 0}
_SCALE = {torch.float16: 1, torch.float32: 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("dequant")
    fn = lib.dequant_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dequant(q: torch.Tensor, scales: torch.Tensor, *, qblock: int = QBLOCK,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """q: (N, F) int8, scales: (N, F//qblock) f16/f32 -> (N, F) out_dtype."""
    if not (q.is_cuda and scales.is_cuda) or q.device != scales.device:
        raise ValueError("dequant kernel needs q and scales on one CUDA device "
                         f"(got {q.device}, {scales.device})")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"q must be a 2-D int8 tensor, got {q.dtype} {tuple(q.shape)}")
    n, f = q.shape
    if qblock % 16 or f % qblock:
        raise ValueError(f"F={f} must be a multiple of qblock={qblock}, "
                         "itself a multiple of 16")
    if scales.dtype not in _SCALE or tuple(scales.shape) != (n, f // qblock):
        raise ValueError(f"scales must be f16/f32 of shape {(n, f // qblock)}, "
                         f"got {scales.dtype} {tuple(scales.shape)}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()) or q.data_ptr() % 16:
        raise ValueError("q and scales must be contiguous and q 16-byte aligned")
    out = torch.empty((n, f), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out                       # nothing to launch
    err = _lib().dequant_launch(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, f, qblock,
        _SCALE[scales.dtype], _OUT[out_dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "dequant")
    dequant.launches += 1
    return out


dequant.launches = 0

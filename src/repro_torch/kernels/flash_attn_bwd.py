"""Causal GQA flash attention (backward): the training attention kernel.

Wrapper of ``csrc/flash_attn_bwd.cu``. It has no TPU counterpart: the Pallas
kernel is forward only and JAX differentiates ``flash_attention_lax``. It
launches the CUDA kernels on CUDA tensors and refuses anything else; the
plain version is ``kernels.ref.attention_bwd_ref``, and
``kernels.ops.attention`` (an autograd Function around the forward kernel)
picks between them by the tensors' device. ``flash_attention_bwd.launches``
counts calls that launch the kernels (each call runs two, the D pre-pass and
the main kernel, for bf16; three for f32).

Contract (the forward's): q (B, T, H, dh), k (B, T, KV, dh), v (B, T, KV,
dv), H % KV == 0, ``Tq == Tk``; o and do (B, T, H, dv) in q's dtype; lse
(B, H, T) f32 from the forward; f32 with dh, dv <= 128, or bf16 with dh ==
dv in {16, 32, 64, 128}; causal or not, with an optional window, and no
attention flag (they have no backward). Returns (dq, dk, dv) in the inputs'
dtype, accumulated in f32, the same bits on every run. Every tensor is
contiguous and 16-byte aligned.

The bf16 kernel's schedule (work items of 128 keys and one slice of a GQA
group's heads, handed out by ascending key tile, each walking its 64-row
query tiles from the last down, and the chain of key tiles that add to each
dQ tile in a fixed order) is written here once more, as a twin of the
kernel's index arithmetic, for the CPU tests: ``item_query_tiles``,
``dq_chain``, ``slices``, ``items`` and ``item_steps``.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import BF16_HEAD_DIMS, MAX_HEAD_DIM

_IS_BF16 = {torch.bfloat16: 1, torch.float32: 0}
_ERR_ENCODE, _ERR_NO_ENCODE = 10000, 20000     # the C entry point's own codes
TILE_Q, TILE_K = 64, 128     # the bf16 kernel's query rows a step, keys an item


def n_tiles(t: int, rows: int) -> int:
    return -(-t // rows)


def item_query_tiles(kt: int, t: int, causal: bool, window: Optional[int]
                     ) -> Tuple[int, int]:
    """The query tiles lo..hi that key tile ``kt``'s items walk: those with
    a live (q, k) pair (kernel: ``item_qtiles``)."""
    k1 = min(kt * TILE_K + TILE_K, t) - 1
    hi = n_tiles(t, TILE_Q) - 1
    if window:
        hi = min(hi, (k1 + window - 1) // TILE_Q)
    return (kt * TILE_K // TILE_Q if causal else 0), hi


def dq_chain(qt: int, t: int, causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """The key tiles lo..hi that add to query tile ``qt``'s dQ, in that
    order: lo stores, hi converts to bf16 (kernel: ``dq_chain``)."""
    q0 = qt * TILE_Q
    q1 = min(q0 + TILE_Q, t) - 1
    lo = max(0, q0 - window + 1) // TILE_K if window else 0
    return lo, (q1 // TILE_K if causal else n_tiles(t, TILE_K) - 1)


def slices(g: int) -> List[range]:
    """The query heads of a GQA group (offsets) that one item walks: two
    slices when the group has more than one head (kernel: ``item_at``)."""
    return [range(g)] if g == 1 else [range((g + 1) // 2), range((g + 1) // 2, g)]


def items(b: int, t: int, kv: int, g: int) -> List[Tuple[int, int, int, int]]:
    """(key tile, batch row, kv head, slice) of each work item in the order
    the kernel's counter hands them out (kernel: ``item_at``)."""
    ns = len(slices(g))
    return [(kt, bi, kvh, sl) for kt in range(n_tiles(t, TILE_K)) for bi in range(b)
            for kvh in range(kv) for sl in range(ns)]


def item_steps(kt: int, kvh: int, sl: int, g: int, t: int, causal: bool,
               window: Optional[int]) -> List[Tuple[int, int]]:
    """(query tile, query head) of an item's steps in order."""
    lo, hi = item_query_tiles(kt, t, causal, window)
    return [(qt, kvh * g + i) for qt in range(hi, lo - 1, -1) for i in slices(g)[sl]]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    fn = lib.flash_attn_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention for the cotangent ``do``."""
    args = (q, k, v, o, lse, do)
    if not (q.is_cuda and all(x.device == q.device for x in args)):
        raise ValueError("flash_attention_bwd kernel needs every input on one "
                         f"CUDA device (got {[str(x.device) for x in args]})")
    if (q.dtype not in _IS_BF16 or any(x.dtype != q.dtype for x in (k, v, o, do))
            or lse.dtype != torch.float32):
        raise ValueError("q, k, v, o, do must share dtype bf16 or f32 and lse be "
                         f"f32, got {[str(x.dtype) for x in args]}")
    if any(x.dim() != 4 for x in (q, k, v, o, do)):
        raise ValueError("q, k, v, o, do must be 4-D (B, T, heads, head_dim)")
    b, t, h, dh = q.shape
    kv, dv = k.shape[2], v.shape[-1]
    if kv == 0 or h % kv:
        raise ValueError(f"H={h} must be a multiple of KV={kv}")
    want = ((b, t, kv, dh), (b, t, kv, dv), (b, t, h, dv), (b, h, t), (b, t, h, dv))
    if any(tuple(x.shape) != w for x, w in zip(args[1:], want)):
        raise ValueError(f"shapes {[tuple(x.shape) for x in args]} do not match q "
                         f"{tuple(q.shape)} (Tq == Tk, lse (B, H, T))")
    if not (0 < dh <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must be in 1..{MAX_HEAD_DIM}, got {dh}, {dv}")
    if q.dtype == torch.bfloat16 and not (dh == dv and dh in BF16_HEAD_DIMS):
        raise ValueError(f"bf16 head dims must be equal and in {BF16_HEAD_DIMS}, "
                         f"got {dh}, {dv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("flash_attention_bwd inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in args):
        raise ValueError("flash_attention_bwd inputs must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dq, dk, dv_ = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv_.zero_()          # nothing to launch
    if q.dtype == torch.bfloat16:     # the layout flash_attn_bwd_launch documents
        nq, nk, width = n_tiles(t, TILE_Q), n_tiles(t, TILE_K), 64 if dh <= 64 else 128
        work = torch.empty(b * h * nq * TILE_Q * (2 + width) + b * kv * nk * 512 * width,
                           dtype=torch.float32, device=q.device)
        counters = torch.zeros(1 + b * h * nq + 2 * b * kv * nk, dtype=torch.int32,
                               device=q.device)
    else:
        work, counters = torch.empty((b, h, t), dtype=torch.float32, device=q.device), None
    err = _lib().flash_attn_bwd_launch(
        *(x.data_ptr() for x in (q, k, v, o, lse, do, dq, dk, dv_, work)),
        counters.data_ptr() if counters is not None else None,
        b, t, h, kv, dh, dv, scale, int(causal), window or 0, _IS_BF16[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _ERR_ENCODE:
        raise RuntimeError(
            "flash_attention_bwd: the driver has no cuTensorMapEncodeTiled"
            if err >= _ERR_NO_ENCODE else
            f"flash_attention_bwd: cuTensorMapEncodeTiled refused a map (CUresult "
            f"{err - _ERR_ENCODE})")
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv_


flash_attention_bwd.launches = 0

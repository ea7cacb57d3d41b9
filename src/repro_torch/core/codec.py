"""Fixed-rate block quantization (host side) — a copy of ``repro.core.codec``.

Records are stored as per-block absmax int8 (or packed int4) with one f16
scale per ``BLOCK`` elements. Encoding runs on the host at data-preparation
time; ``block_dequantize_host`` is the NumPy oracle the device dequant kernel
(``repro_torch.kernels.dequant``) is held to.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

BLOCK = 256   # elements per scale block


def block_quantize(x: np.ndarray, *, block: int = BLOCK, bits: int = 8
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize float array -> (int8 payload, float16 per-block scales).

    ``x``: (N, F) float records, F divisible by ``block``.
    Returns payload (N, F) int8 in [-127,127] (or packed int4 (N, F//2)) and
    scales (N, F//block) float16.
    """
    if bits not in (4, 8):
        raise ValueError("bits must be 4 or 8")
    n, f = x.shape
    if f % block:
        raise ValueError(f"feature dim {f} must divide block {block}")
    xb = x.reshape(n, f // block, block).astype(np.float32)
    absmax = np.abs(xb).max(axis=2, keepdims=True)
    qmax = 127.0 if bits == 8 else 7.0
    # round the scale through f16 first so quantization and (f16-scaled)
    # dequantization use the identical scale -> error stays <= scale/2
    scale = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float16)
    scale = np.maximum(scale, np.float16(6e-8)).astype(np.float32)
    q = np.clip(np.rint(xb / scale), -qmax, qmax).astype(np.int8)
    q = q.reshape(n, f)
    if bits == 4:
        lo = q[:, 0::2] & 0x0F
        hi = (q[:, 1::2] & 0x0F) << 4
        q = (lo | hi).astype(np.int8)
    return q, scale.reshape(n, f // block).astype(np.float16)


def block_dequantize_host(q: np.ndarray, scales: np.ndarray, *,
                          block: int = BLOCK, bits: int = 8) -> np.ndarray:
    """NumPy oracle for the device dequant kernel."""
    n = q.shape[0]
    if bits == 4:
        lo = (q.astype(np.int8) << 4).astype(np.int8) >> 4   # sign-extend
        hi = q.astype(np.int8) >> 4
        full = np.empty((n, q.shape[1] * 2), dtype=np.int8)
        full[:, 0::2] = lo
        full[:, 1::2] = hi
        q = full
    f = q.shape[1]
    xb = q.reshape(n, f // block, block).astype(np.float32)
    return (xb * scales.astype(np.float32)[..., None]).reshape(n, f)

"""PyTorch/CUDA port of the FanStore device tier and its LM consumers (the
dense, ssm and hybrid families, served; the dense family, trained).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``core``, ``data``, ``kernels``, ``models``, ``serve``,
``train``, ``launch``) and imports nothing from it. The three Pallas
kernels of the reference, and the attention backward that training needs,
are hand-written CUDA C++ for Hopper here (``csrc/``), built with ``nvcc``
at first use and loaded with ``ctypes``.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``. A CUDA request on a machine without a card raises; nothing
falls back silently. On CPU tensors the kernel wrappers' plain PyTorch
versions run instead (that is how the CPU tests compare against JAX).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device | None" = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    no CUDA card is visible (there is no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is visible; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev

"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

  dequant     the fetch path's decode (block dequant, memory-bound)
  flash_attn  causal GQA attention for the prefill and training paths
              (forward, and its row log-sum-exp for the backward)
  flash_attn_bwd  its backward (dq, dk, dv) for training; no TPU twin
  ssm_scan    the Mamba-1 selective scan for the ssm and hybrid prefill and
              training paths
  ssm_scan_bwd  its backward (du, ddt, dB, dC, da_log, dD) for training; no
              TPU twin

Each kernel is a CUDA C++ source in ``repro_torch/csrc`` with a plain C
entry point, built by ``_build`` with nvcc at first use and called through
``ctypes``; ``ref`` holds the plain PyTorch versions and ``ops`` dispatches.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]

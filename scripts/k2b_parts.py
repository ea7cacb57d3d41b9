#!/usr/bin/env python3
"""Where K2b's time goes, on one NVIDIA card.

  python3 scripts/k2b_parts.py          (from the root of a checkout)

Builds copies of ``src/repro_torch/csrc/flash_attn_bwd.cu`` with one part of
the bf16 kernel's work taken out (into ``build/k2b_parts/``, which
``.gitignore`` lists), and times each copy, and the kernel as it is, at
chatglm3-6b's training shape (B=4, T=2048, H=32, KV=2, dh=128, causal) and
hymba-1.5b's (B=4, H=25, KV=5, dh=64, window 1024), in two rounds in
opposite orders, beside SDPA's backward. A copy with a part taken out
computes wrong gradients: its time says what that part costs, nothing
else. The parts:
  no_softmax   P^T without the exp and the mask (S^T scaled and shifted);
  no_staging   the dQ tile is not copied into shared memory;
  no_bulk      the delivery warp issues no bulk store or reduce-add;
  no_last_wait the last contributor of a dQ tile does not wait for the
               tile's count;
  mma_only     all four taken out.
Prints one line per copy and round, each time the least of 5 windows of 20
calls (CUDA events), and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attn_bwd as k2b  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention  # noqa: E402

SOFTMAX = ("      const float pr = fast_exp2(sc[i] * p.sl2 - (e % 2 ? l2.y : l2.x));\n"
           "      sc[i] = edge && !live(q0 + 8 * j + col0 + e % 2, key + 8 * (e / 2), "
           "p.T_len, p.causal,\n                            p.window) ? 0.f : pr;",
           "      sc[i] = sc[i] * p.sl2 - (e % 2 ? l2.y : l2.x);")
STAGING = ("    give_rows(sm.dq[buf] + c * (BQ * D / 2), dq, tid);\n", "")
BULK = ("    if (place == 0) bulk_store(dst, sm.dq[buf], BQ * D * 4);\n"
        "    else bulk_reduce_add(dst, sm.dq[buf], BQ * D * 4);\n", "")
LAST_WAIT = ("      if (tid == 0) count_wait(p.dq_count + tile, place);\n", "")
PARTS = {"kernel": [], "no_softmax": [SOFTMAX], "no_staging": [STAGING], "no_bulk": [BULK],
         "no_last_wait": [LAST_WAIT], "mma_only": [SOFTMAX, STAGING, BULK, LAST_WAIT]}
SHAPES = {"chatglm3-6b": (4, 2048, 32, 2, 128, None), "hymba-1.5b": (4, 2048, 25, 5, 64, 1024)}


def build(out: Path) -> dict:
    """Write and compile every copy in parallel; {name: shared library}."""
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    procs = {}
    for name, edits in PARTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attn_bwd.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attn_bwd.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return {name: out / name / "lib.so" for name in PARTS}


def time_ms(fn, reps: int = 20, windows: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(windows):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("k2b_parts: no CUDA card is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(ROOT / "build" / "k2b_parts")
    dev = torch.device("cuda")
    inputs = {}
    for shape, (b, t, h, kv, dh, win) in SHAPES.items():
        gen = torch.Generator(dev).manual_seed(7)
        q, k, v, do = (torch.randn((b, t, n, dh), generator=gen, device=dev).to(torch.bfloat16)
                       for n in (h, kv, kv, h))
        o, lse = flash_attention(q, k, v, window=win, return_lse=True)
        inputs[shape] = (q, k, v, o, lse, do, win)
    for rnd, names in enumerate((list(PARTS), list(PARTS)[::-1])):
        for name in names:
            lib = ctypes.CDLL(str(libs[name]))
            fn = lib.flash_attn_bwd_launch
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
                ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            k2b._lib = lambda lib=lib: lib       # the wrapper launches this copy
            ms = {shape: time_ms(lambda x=x: k2b.flash_attention_bwd(*x[:6], window=x[6]))
                  for shape, x in inputs.items()}
            print(f"round {rnd} {name}: " + ", ".join(f"{s} {m:.4f} ms" for s, m in ms.items()),
                  flush=True)
    q, k, v, o, lse, do, _ = inputs["chatglm3-6b"]
    g = q.shape[2] // k.shape[2]
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2).contiguous()
    sdpa = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True))
    print(f"SDPA's backward at chatglm3-6b's shape: {sdpa:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

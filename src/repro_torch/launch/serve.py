"""Batched serving driver: prefill a prompt batch, decode N tokens.

Counterpart of ``repro.launch.serve`` with the same flags plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Weights are random,
drawn from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --prompt-len 8
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, get_smoke
from repro_torch.models import Model, build_model
from repro_torch.serve.serve_step import generate


def run(cfg: ModelConfig, tokens: torch.Tensor, *, steps: int,
        sample: str = "greedy", seed: int = 0, device="cuda"
        ) -> Tuple[torch.Tensor, Dict[str, float], Model]:
    """Build ``cfg`` with random weights from ``seed`` on ``device`` and
    generate ``steps`` tokens for the (B, T) prompt ``tokens``.

    Returns (tokens (B, steps) int32, timings with ``prefill_s`` and
    ``decode_s``, the model).
    """
    dev = resolve_device(device)
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(seed))
    timings: Dict[str, float] = {}
    out = generate(model, tokens.to(dev), steps=steps, sample=sample,
                   generator=torch.Generator(dev).manual_seed(seed + 1),
                   timings=timings)
    return out, timings, model


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temp"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke if args.preset == "smoke" else get_config)(args.arch)
    cfg = cfg.scaled(remat=False)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    out, t, _ = run(cfg, torch.from_numpy(toks.astype(np.int32)),
                    steps=args.steps, sample=args.sample, seed=args.seed,
                    device=dev)
    total = t["prefill_s"] + t["decode_s"]
    print(f"{args.arch} on {dev}: generated {tuple(out.shape)} in {total:.2f}s "
          f"(prefill {t['prefill_s'] * 1e3:.1f} ms, "
          f"{args.batch * args.steps / total:.1f} tok/s)")
    print("first sequence:", out[0].tolist()[:16])
    return out


if __name__ == "__main__":
    main()

"""End-to-end training entry point: the device-tier token store + model + AdamW
+ checkpoints, on one card.

Counterpart of ``repro.launch.train`` with the flags that need no host
FanStore engine, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path) and ``--num-layers`` (a depth cut: one 80 GB card holds f32
parameters, gradients and both AdamW moments, 16 B a parameter, of about 4.5
B parameters). The reference reads its batches through the host data plane
(a FanStore cluster and its prefetch loader, ROADMAP Queue 1 item 5, with
``--nodes``, ``--workers``, ``--backend``, ``--prefetch-schedule``,
``--epochs``, ``--ckpt-fanstore`` and ``--metrics-jsonl``); here they come
through the device tier the reference names as its optional fetch: the
reference's ``token_dataset`` placed as records in a ``DeviceStore``, each
step's ``GlobalUniformSampler`` indices gathered by ``core.fetch`` and
turned into tokens by ``tokens_from_payload``. The ``dense``, ``ssm`` and
``hybrid`` families train (``Model.loss``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --preset full --num-layers 12 --global-batch 4 --seq-len 2048 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --preset full --num-layers 24 --global-batch 4 --seq-len 2048 --steps 4 \\
      --lr 3e-4         # at 1e-3 it diverges in its third step
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, get_smoke
from repro_torch.core import DeviceStore, DeviceStoreConfig, tokens_from_payload
from repro_torch.data import GlobalUniformSampler, token_dataset
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_state, make_train_step


def run(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
        num_samples: int, lr: float = 1e-3, microbatches: int = 1,
        grad_sync: str = "auto", ckpt_dir: Optional[str] = None,
        ckpt_every: int = 20, resume: bool = False, seed: int = 0,
        device="cuda", log: Callable[[str], None] = print,
        on_step: Optional[Callable] = None) -> Dict:
    """Train ``cfg`` from random weights drawn from ``seed`` for ``steps``
    steps (counting those a resumed checkpoint already took).

    ``on_step(step, record, state)`` runs after each step. Returns
    ``{"model", "state", "history", "step", "batch"}``: ``history`` holds one
    record per step (``loss``, ``grad_norm``, ``lr``, ``step`` and
    ``step_s``, host-clock seconds for the fetch and the step, ending in a
    device synchronize), ``step`` the train-step function and ``batch`` the
    last batch.
    """
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    ocfg = OptimizerConfig(lr=lr, warmup_steps=max(2, steps // 20),
                           total_steps=steps)
    store = DeviceStore(DeviceStoreConfig(num_samples, seq_len * 4), device=dev)
    records = store.place_tokens(token_dataset(num_samples, seq_len,
                                               cfg.vocab_size, seed=seed))
    sampler = GlobalUniformSampler(num_samples, global_batch, seed=seed)
    state = init_state(model, torch.Generator(dev).manual_seed(seed), ocfg,
                       grad_sync=grad_sync)
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and mgr is not None and mgr.latest_step() is not None:
        state, manifest = restore_checkpoint(ckpt_dir, state)
        start = manifest["step"]
        sampler.state.step = manifest["extra"].get("sampler_step", 0)
        sampler.state.epoch = manifest["extra"].get("sampler_epoch", 0)
        log(f"resumed from step {start}")
    step_fn = make_train_step(model, ocfg, grad_sync=grad_sync,
                              microbatches=microbatches)

    def extra() -> Dict:
        return {"sampler_step": sampler.state.step,
                "sampler_epoch": sampler.state.epoch}

    history, batch, t_run = [], None, time.perf_counter()
    for n in range(start + 1, steps + 1):
        t0 = time.perf_counter()
        idx = torch.from_numpy(sampler.next_batch()).to(dev)
        payload, overflow = store.fetch(records, idx)
        if bool(overflow):
            raise RuntimeError("token fetch overflowed its capacity")
        batch = {"tokens": tokens_from_payload(payload, seq_len)}
        state, metrics = step_fn(state, batch)
        rec = {k: float(v) for k, v in metrics.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec.update(step=n, step_s=time.perf_counter() - t0)
        history.append(rec)
        if on_step is not None:
            on_step(n, rec, state)
        if n % 10 == 0 or n == steps:
            items = (n - start) * global_batch / (time.perf_counter() - t_run)
            log(f"step {n:5d} loss={rec['loss']:.4f} lr={rec['lr']:.2e} "
                f"throughput={items:.1f} items/s")
        if mgr is not None and n % ckpt_every == 0:
            mgr.save(n, state, extra=extra())
    if mgr is not None:
        mgr.save(max(start, steps), state, blocking=True, extra=extra())
    return {"model": model, "state": state, "history": history,
            "step": step_fn, "batch": batch}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the preset's)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--num-samples", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-sync", default="auto", choices=["auto"],
                    help="int8 is ROADMAP Queue 1 item 6 (M8)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke if args.preset == "smoke" else get_config)(args.arch)
    if args.num_layers:
        cfg = cfg.scaled(num_layers=args.num_layers)
    out = run(cfg, steps=args.steps, global_batch=args.global_batch,
              seq_len=args.seq_len, num_samples=args.num_samples, lr=args.lr,
              microbatches=args.microbatches, grad_sync=args.grad_sync,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              resume=args.resume, seed=args.seed, device=dev)
    print(f"done: {args.arch} on {dev}, {cfg.num_layers} layers, "
          f"{len(out['history'])} steps")
    return out


if __name__ == "__main__":
    main()

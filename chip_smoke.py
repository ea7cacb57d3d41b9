#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py            (from the root of a checkout; needs one card)
  python3 chip_smoke.py --serve-ab PARENT [--rounds N]
      (serving phase only: PARENT's port and this one's in turns, below)

Phases, each of which raises on a failed check:
  1. environment: torch version, the card's name and power limit; build the
     five CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each, in
     parallel) and print ptxas' registers and spills per kernel instance
     (flash attention: one per head dim, setting of the two attention flags
     and LSE output; its backward: one per head dim and kernel), and fail
     if a kernel of either backward (K2b, K3b) spills;
  2. references at a small size: the chatglm3, falcon-mamba and hymba smoke
     models in f32 on the card (through the kernels) against the same
     weights on the CPU (plain path); then training each of the three smoke
     models in f32 with remat: the loss and every gradient on the card (K2
     and K2b, K3 and K3b) against the CPU's, the launch counts, and one
     AdamW step's parameters;
  3. the main paths, each with every kernel launch counter set to 0 just
     before it and read just after:
     a. device tier: a block-quantized ImageNet-size record store
        (40 000 x 151 704 B, ~6.1 GB) and a token store (262 144 x 2 048
        tokens, 2 GiB, ids below the smallest vocab of the three served
        models, so one prompt serves all three), both made on the card from
        a seed; a fetch of 256
        records decoded by the dequant kernel to bf16 and f32; a fetch of 4
        token records that becomes the prompt; the overflow flag at
        capacity_factor 0.5;
     b. serving chatglm3-6b at full width and depth with random bf16 weights
        (``repro_torch.launch.serve.run``): a 4 x 2048 prompt, 32 greedy
        decode steps; then (c) its logits checked and (d) a profile of warm
        prefill and decode;
     e. with chatglm3-6b freed and the stores still resident: serving
        falcon-mamba-7b the same way, at full width and depth (64 layers,
        d_model 4096, d_inner 8192), one selective-scan launch per layer of
        the prefill; then (f) its logits checked and (g) its profile;
     h. with falcon-mamba-7b freed: serving hymba-1.5b the same way, at full
        width and depth (32 layers, d_model 1600, 25 heads with 5 KV heads,
        window 1024 but in layers 0, 15 and 31, d_inner 3200), one flash
        attention and one selective-scan launch per layer of the prefill;
        then (i) its logits checked and (j) its profile, with both kernels'
        shares of device busy; no backward kernel launches while serving;
     k. with hymba-1.5b and the stores freed: training chatglm3-6b at full
        width and 12 of its 28 layers (f32 parameters, gradients and AdamW
        moments, bf16 compute, remat) through ``repro_torch.launch.train.run``:
        4 steps of a 4 x 2048 global batch fetched from its token store,
        24 K2 and 12 K2b launches a step, the loss and every parameter
        finite after each step and the loss falling; step time, tokens/s,
        the model-FLOP share of the bf16 peak, peak memory, a profile of a
        fifth, warm step (each kernel's time a call and share of busy), and
        the device time of a sixth one's forward, backward and AdamW
        update;
     l. the same for hymba-1.5b at full width and depth (32 layers): 64 K2,
        32 K2b, 64 K3 and 32 K3b launches a step;
     m. the same for falcon-mamba-7b at full width and 24 of its 64 layers:
        48 K3 and 24 K3b launches a step;
  4. each kernel against its plain version at its main path's shapes, and
     its time beside the plain version's, a library call's where one exists
     and the card's bound for the same work (for K2 also its TFLOP/s and
     share of the bound); K2 also against its plain version at
     hymba-1.5b's attention shape (dh 64, GQA group 5, window 1024), and at
     both shapes with each attention flag and with both (bf16, the plain
     version given the same flags), each timed beside the flag-free time; K3 on
     init-like and trained-like inputs in bf16 and f32, its share of the
     bound, the special-function-unit floor at the SM clock read under load,
     its time at hymba-1.5b's shape and with one channel fewer than the
     path's (D not a multiple of 8: element-wise staging), and what
     cuobjdump shows of its time loop (registers, spills, instructions and
     MUFU.EX2 per update); K3b against the plain backward at
     falcon-mamba-7b's training shape (init-like and trained-like inputs)
     and hymba-1.5b's, bf16 inputs, f32 dy and a nonzero dh_final, from
     K3's checkpoints of h as training calls it, the same bits on two runs,
     its time beside its bound and the special-function-unit floor at both
     shapes and beside K3's with and without writing the checkpoints, its
     launch plan's waves at the blocks an SM the card's occupancy calculator
     gives, and what cuobjdump shows of its walk loop (instructions,
     MUFU.EX2, shuffles and shared-memory accesses per update); K2b against the plain backward at chatglm3-6b's training shape
     and hymba-1.5b's, its time beside its bound, SDPA's
     backward and K2's with and without the LSE output, and the device
     time of its D pre-pass and main kernel apart; K2's LSE against
     the plain one taken in f32, and K2 then K2b against the plain forward
     then the plain backward in f32.
The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` name/power
line and ``{"ok": true, "device": ...}``. Without a card, or without the rest
of the repository, it exits non-zero and prints no result.

``--serve-ab PARENT`` compares the serving times of two checkouts on one
card: PARENT (another checkout of the repository, for example a parent
commit unpacked with ``git archive``) and this one. Both ports are imported
into one process, so they share its CUDA context, libraries and allocator,
and serve in turns (parent, this, this, parent) ``--rounds`` times, after
one unrecorded turn each. A turn serves the three models as in phase 3
(through ``launch.serve.run``: a prefill and 32 decode steps, then a warm
prefill) and times a pure-Python loop, which shows how fast the host was
(decode is host-bound). It prints each turn and each tree's medians.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): device memory bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

SEED = 0
N_HOST = 32                        # records quantized on the host with the codec
F_IMG = 224 * 224 * 3              # 150 528 = 588 * 256 features per image
N_IMG, G_IMG = 40_000, 256         # store A records, global batch
N_TOK, L_TOK, G_TOK = 262_144, 2_048, 4   # store B records, tokens, prompts
DECODE_STEPS = 32
SERVED = ("chatglm3-6b", "falcon-mamba-7b", "hymba-1.5b")
# training, one model after another (tag, arch, layers, peak lr): chatglm3-6b
# at full width with its depth cut to what one card holds, hymba-1.5b at full
# width and depth, falcon-mamba-7b at full width and 24 of its 64 layers. At
# the launcher's default lr of 1e-3 (warmed up over 2 steps) falcon-mamba-7b
# diverges at its third step with K3b and with the plain backward alike
# (PERF.md), so it trains at 3e-4, the reference optimizer's default
TRAIN_RUNS = (("3k", "chatglm3-6b", 12, 1e-3), ("3l", "hymba-1.5b", 32, 1e-3),
              ("3m", "falcon-mamba-7b", 24, 3e-4))
TRAIN_B, TRAIN_STEPS = 4, 4
TRAIN_SAMPLES = 8_192              # each token store: 8192 x 2048 tokens, 64 MiB
# the kernels each family's training step launches, and how many a layer
# (the forward, its remat recompute and the backward)
TRAIN_KERNELS = {"dense": {"flash_attention": 2, "flash_attention_bwd": 1},
                 "ssm": {"ssm_scan": 2, "ssm_scan_bwd": 1},
                 "hybrid": {"flash_attention": 2, "flash_attention_bwd": 1,
                            "ssm_scan": 2, "ssm_scan_bwd": 1}}
# a wrapper's kernel as torch.profiler names it
PROFILED_AS = {"flash_attention": "flash_fwd", "ssm_scan": "ssm_scan_kernel",
               "flash_attention_bwd": "flash_bwd", "ssm_scan_bwd": "ssm_scan_bwd"}

def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def time_ms(fn, reps: int, windows: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls (so the host's launch cost hides behind the queue),
    divided by ``reps``; the median over ``windows`` such windows."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float, mufu_ms: float = 0.0):
    """The least time (ms) for the work: its bytes at the memory rate, its
    arithmetic at ``peak_flops`` (an FMA counts 2) and, apart, the
    special-function unit's floor for its exps, whichever is largest."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(flops / peak_flops * 1e3, mufu_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(report: str):
    """(kernel symbol, line) for each register or spill line of a
    ``ptxas -v`` report."""
    fn = "?"
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            fn = m[1]
        elif "registers" in line or "spill" in line:
            yield fn, line.strip()


def demangled(symbols) -> dict:
    """{symbol: name<template arguments>} by the toolkit's cu++filt (flash
    attention: <head dim, scale_in_q, probs_bf16>); symbols stay as they are
    where the toolkit has no cu++filt."""
    from repro_torch.kernels import _build

    symbols = sorted(set(symbols))
    tool = Path(_build.nvcc_path()).parent / "cu++filt"
    if not tool.exists():
        return {s: s for s in symbols}
    out = subprocess.run([str(tool)], input="\n".join(symbols), capture_output=True,
                         text=True, timeout=60, check=True).stdout.splitlines()
    names = {}
    for sym, d in zip(symbols, out):
        d = d[:d.rfind("(")] if d.endswith(")") else d          # the parameters
        d = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|\((?:int|bool)\)",
                   "", d)
        names[sym] = d
    return names


def reference_small(dev, arch: str) -> None:
    """A smoke model in f32: card (kernels) vs CPU (plain path)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve.serve_step import generate

    cfg = get_smoke(arch).scaled(remat=False, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    lc, _ = card.prefill(toks.to(dev), 108)
    lp, _ = cpu.prefill(toks, 108)
    err = (lc.cpu() - lp).abs().max().item()
    check(err <= 1e-4, f"small prefill logits card vs cpu max err {err} <= 1e-4")
    same = torch.equal(generate(card, toks, steps=8).cpu(),
                       generate(cpu, toks, steps=8))
    check(same, "small greedy tokens card == cpu")
    log(f"[2] small reference: {arch} smoke f32 prefill logits card vs cpu "
        f"max_abs_err={err:.3g} (tol 1e-4); greedy tokens identical")


def reference_train_small(dev, arch: str, kernels: dict) -> None:
    """A smoke model in f32, remat on: loss and every gradient on the card
    (the family's kernels and their backward kernels) against the CPU (plain
    path) within 1e-4, then one AdamW step's parameters within 1e-5. eps
    1e-4 keeps the update off the gradients' rounding noise (the key bias's
    gradient is zero in the dims RoPE leaves alone, and Adam would scale its
    noise up to lr)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = get_smoke(arch).scaled(dtype="float32", loss_chunk=64)
    check(cfg.remat, f"{arch} smoke config trains with remat")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, 100)).astype(np.int32))
    on_path = TRAIN_KERNELS[cfg.family]
    before = {n: kernels[n].launches for n in on_path}
    losses = []
    for model, t in ((card, toks.to(dev)), (cpu, toks)):
        loss, _ = model.loss(t)
        loss.backward()
        losses.append(loss.item())
    counts = {n: kernels[n].launches - before[n] for n in on_path}
    check(counts == {n: k * cfg.num_layers for n, k in on_path.items()},
          f"small training {arch}: launches {counts} == {on_path} x {cfg.num_layers} layers")
    cpu_p = dict(cpu.named_parameters())
    loss_err = abs(losses[0] - losses[1])
    grad_err = max((p.grad.cpu() - cpu_p[n].grad).abs().max().item()
                   for n, p in card.named_parameters())
    check(loss_err <= 1e-4 and grad_err <= 1e-4,
          f"small training {arch} loss err {loss_err}, grad err {grad_err} <= 1e-4")
    ocfg = OptimizerConfig(lr=1e-3, eps=1e-4, warmup_steps=2, total_steps=4)
    for model, t in ((card, toks.to(dev)), (cpu, toks)):
        params = dict(model.named_parameters())
        make_train_step(model, ocfg)(TrainState(params, adamw_init(params)),
                                     {"tokens": t})
    step_err = max((p.detach().cpu() - cpu_p[n].detach()).abs().max().item()
                   for n, p in card.named_parameters())
    check(step_err <= 1e-5, f"small training {arch} AdamW step params err "
          f"{step_err} <= 1e-5")
    log(f"[2] small training: {arch} smoke f32, remat, 4 x 100 tokens: card "
        f"(launches {counts}) vs cpu loss err {loss_err:.3g}, max grad err "
        f"{grad_err:.3g} (tol 1e-4); one AdamW step's params max err "
        f"{step_err:.3g} (tol 1e-5)")


def image_store(dev, gen):
    """Store A: 40 000 block-quantized image records made on the card; the
    first N_HOST are host-quantized from N(0, 1) with the codec."""
    from repro_torch.core import block_quantize

    nb = F_IMG // 256
    recs = torch.empty((N_IMG, F_IMG + 2 * nb), dtype=torch.uint8, device=dev)
    for r0 in range(0, N_IMG, 2_000):
        r1 = min(N_IMG, r0 + 2_000)
        recs[r0:r1, :F_IMG] = torch.randint(
            -127, 128, (r1 - r0, F_IMG), generator=gen, device=dev,
            dtype=torch.int8).view(torch.uint8)
        scales = torch.rand((r1 - r0, nb), generator=gen, device=dev) * 0.05 + 1e-3
        recs[r0:r1, F_IMG:] = scales.to(torch.float16).view(torch.uint8)
    x = np.random.default_rng(SEED).standard_normal((N_HOST, F_IMG)).astype(np.float32)
    q, s = block_quantize(x)
    host = np.concatenate([q.view(np.uint8), s.view(np.uint8)], axis=1)
    recs[:N_HOST] = torch.from_numpy(host).to(dev)
    return recs, x, q, s


def device_tier(dev, out: dict):
    from repro_torch.configs import get_config
    from repro_torch.core import (DeviceStore, DeviceStoreConfig,
                                  block_dequantize_host, decode_records,
                                  tokens_from_payload)
    from repro_torch.kernels import ref

    gen = torch.Generator(dev).manual_seed(SEED)
    t0 = time.perf_counter()
    recs, x_host, q_host, s_host = image_store(dev, gen)
    store_a = DeviceStore(DeviceStoreConfig(N_IMG, recs.shape[1], 2.0), device=dev)
    arr_a = store_a.place(recs)
    vocab = min(get_config(arch).vocab_size for arch in SERVED)
    tokens = torch.randint(0, vocab, (N_TOK, L_TOK), generator=gen, device=dev,
                           dtype=torch.int32)
    store_b = DeviceStore(DeviceStoreConfig(N_TOK, L_TOK * 4, 2.0), device=dev)
    arr_b = store_b.place_tokens(tokens)
    torch.cuda.synchronize()
    log(f"[3a] stores on the card: A {store_a.device_bytes / 1e9:.3f} GB "
        f"({N_IMG} x {recs.shape[1]} B), B {store_b.device_bytes / 2**30:.3f} GiB "
        f"({N_TOK} x {L_TOK} tokens), made in {time.perf_counter() - t0:.2f} s")

    idx = torch.randperm(N_IMG, generator=gen, device=dev)[:G_IMG]
    idx[:N_HOST] = torch.arange(N_HOST, device=dev)   # the host-quantized ones
    fetch_decode_ms = []                # first call, then warm
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, overflow = store_a.fetch(arr_a, idx)
        x16 = decode_records(batch, F_IMG)
        x32 = decode_records(batch, F_IMG, out_dtype=torch.float32)
        torch.cuda.synchronize()
        fetch_decode_ms.append((time.perf_counter() - t0) * 1e3)
    check(not overflow.item(), "no overflow at capacity_factor 2.0")
    check(torch.equal(batch, arr_a[idx]), "fetched records == store rows")
    q, s = (batch[:, :F_IMG].contiguous().view(torch.int8),
            batch[:, F_IMG:].contiguous().view(torch.float16))
    check(torch.equal(x16, ref.dequant_ref(q, s)),
          "dequant kernel bf16 bit-exact vs plain")
    check(torch.equal(x32, ref.dequant_ref(q, s, out_dtype=torch.float32)),
          "dequant kernel f32 bit-exact vs plain")
    host = block_dequantize_host(q_host, s_host)
    check(np.array_equal(x32[:N_HOST].cpu().numpy(), host),
          f"dequant kernel f32 == block_dequantize_host on {N_HOST} host records")
    err = np.abs(host - x_host).max()
    out["fetch_decode_ms"] = fetch_decode_ms
    log(f"[3a] fetch {G_IMG} image records + decode bf16 and f32 (host clock, "
        f"first call then warm): {', '.join(f'{t:.3f}' for t in fetch_decode_ms)} ms; "
        f"bit-exact vs plain; f32 == host codec oracle; quantization max err "
        f"{err:.4f}")

    pidx = torch.randperm(N_TOK, generator=gen, device=dev)[:G_TOK]
    b_tok, o_tok = store_b.fetch(arr_b, pidx)
    prompt = tokens_from_payload(b_tok, L_TOK)
    check(not o_tok.item() and torch.equal(prompt, tokens[pidx]),
          "token fetch returns the stored prompts")
    tight = DeviceStore(DeviceStoreConfig(N_TOK, L_TOK * 4, 0.5), device=dev)
    b_half, o_half = tight.fetch(arr_b, pidx)
    check(bool(o_half.item()) and not b_half[2:].any()
          and torch.equal(b_half[:2], b_tok[:2]),
          "capacity_factor 0.5 trips overflow and leaves dropped rows zero")
    log(f"[3a] prompt batch {tuple(prompt.shape)} from store B; "
        f"capacity_factor 0.5 -> overflow={bool(o_half.item())}, dropped rows zero")
    out["dequant_inputs"] = (q, s)
    out["stores"] = (arr_a, arr_b)       # resident while the model serves
    return prompt


def serve_full(dev, arch: str, tag: str, prompt):
    """Serve ``arch`` at full width and depth with bf16 weights from SEED;
    returns (the result's numbers, the model)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch).scaled(remat=False, param_dtype="bfloat16")
    steps = DECODE_STEPS + 1          # the prefill's token + 32 decode steps
    t0 = time.perf_counter()
    toks, t, model = serve.run(cfg, prompt, steps=steps, seed=SEED, device=dev)
    total_s = time.perf_counter() - t0
    b = prompt.shape[0]
    check(tuple(toks.shape) == (b, steps) and toks.dtype == torch.int32,
          "generated tokens shape/dtype")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "tokens in vocab")
    res = dict(prefill_ms=t["prefill_s"] * 1e3,
               decode_ms_per_step=t["decode_s"] * 1e3 / DECODE_STEPS,
               decode_tok_s=b * DECODE_STEPS / t["decode_s"],
               e2e_tok_s=b * steps / (t["prefill_s"] + t["decode_s"]),
               params=model.param_count(), layers=cfg.num_layers)
    log(f"[{tag}] {arch} full width+depth ({cfg.num_layers} layers, "
        f"{res['params'] / 1e9:.3f} B params in bf16), prompt {tuple(prompt.shape)}: "
        f"prefill {res['prefill_ms']:.2f} ms, decode {res['decode_ms_per_step']:.3f} "
        f"ms/step ({res['decode_tok_s']:.1f} tok/s over {DECODE_STEPS} steps x {b}), "
        f"end-to-end {res['e2e_tok_s']:.1f} tok/s; run() incl. init {total_s:.2f} s")
    log(f"[{tag}] first sequence: {toks[0, :12].tolist()}")
    return res, model


def full_width_logits(tag: str, model, prompt) -> None:
    """Logits of the full model are finite and the greedy prefill token agrees
    with a teacher-forced run of the same prompt."""
    with torch.inference_mode():
        logits, _ = model.prefill(prompt[:, :512], 512)
        full = model.logits_full(prompt[:, :512])
    check(bool(torch.isfinite(logits).all()), "full-width prefill logits finite")
    err = (logits.float() - full[:, -1].float()).abs().max().item()
    scale = full[:, -1].float().abs().max().item()
    check(err <= 1e-2 * max(1.0, scale), f"prefill vs logits_full err {err}")
    log(f"[{tag}] full-width logits finite; prefill vs logits_full last position "
        f"max_abs_err={err:.3g} (scale {scale:.3g})")


def device_profile(fn):
    """Run ``fn`` under torch.profiler, tracing the card's activity only
    (recording the host's ops as well slows a call of many small ops enough
    to leave gaps between its kernels that the unprofiled call does not
    have); return (device busy share of the window spanned by its kernels,
    device busy ms, device ms by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        return None, 0.0, {}
    busy = sum(end - start for start, end, _ in spans)
    window = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    by_name: dict = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    return busy / window, busy / 1e3, {n: us / 1e3 for n, us in by_name.items()}


def warm_prefill_ms(model, prompt) -> float:
    """Host-clock ms of one prefill of ``prompt`` by a model that has served."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prompt, prompt.shape[1] + 8)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_serving(tag: str, model, prompt, kernels) -> dict:
    """Warm prefill time, then device busy share, top kernels and the share
    of the device time spent in each kernel whose name holds one of
    ``kernels`` of one full prefill and of 8 decode steps (outside the timed
    main path)."""
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(prompt, prompt.shape[1] + 8)

    def decode():
        nxt = torch.argmax(state["logits"], dim=-1)[:, None]
        for i in range(8):
            logits, _ = model.decode_step(nxt, state["caches"], prompt.shape[1] + i)
            nxt = torch.argmax(logits, dim=-1)[:, None]

    res = {"warm_prefill_ms": warm_prefill_ms(model, prompt)}
    log(f"[{tag}] warm prefill {tuple(prompt.shape)}: "
        f"{res['warm_prefill_ms']:.2f} ms host clock")
    with torch.inference_mode():
        for name, fn in (("prefill", prefill), ("decode x8", decode)):
            share, busy_ms, by_name = device_profile(fn)
            if share is None:
                log(f"[{tag}] {name}: profiler recorded no device time (not measured)")
                continue
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            k_ms = {k: sum(ms for n, ms in by_name.items() if k in n)
                    for k in kernels}
            res[name] = dict(busy_share=share, busy_ms=busy_ms, kernel_ms=k_ms)
            shares = "; ".join(f"{k} {ms:.3f} ms = {ms / busy_ms:.3f} of busy"
                               for k, ms in k_ms.items())
            log(f"[{tag}] {name}: device busy {busy_ms:.3f} ms, {share:.3f} of the "
                f"kernel window (torch.profiler); {shares}; top kernels "
                f"(name, ms): {[(n[:60], round(ms, 3)) for n, ms in top]}")
    return res


def attention_pairs(cfg, t: int) -> int:
    """(query, key) pairs one sequence of ``t`` tokens scores across the
    model's attention layers, heads counted (causal, windowed where the
    layer is)."""
    from repro_torch.models.transformer import layer_window

    if cfg.attention_free:
        return 0
    total = 0
    for i in range(cfg.num_layers):
        w = layer_window(cfg, i) or t
        w = min(w, t)
        total += w * (w + 1) // 2 + (t - w) * w
    return total * cfg.num_heads


def train_full(dev, kernels: dict, tag: str, arch: str, layers: int,
               lr: float) -> dict:
    """``arch`` at full width and ``layers`` layers (f32 parameters,
    gradients and AdamW moments, bf16 compute, remat) trained TRAIN_STEPS
    steps of a TRAIN_B x 2048 batch at peak lr ``lr`` through
    ``launch.train.run``, the
    family's kernel launches checked each step; then a warm step under the
    profiler and one more timed by phase."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    full = get_config(arch)
    cfg = full.scaled(num_layers=layers)
    on_path = TRAIN_KERNELS[cfg.family]
    per_layer = sum(p.numel() for p in build_model(
        full.scaled(num_layers=1), device="meta").layers[0].parameters())
    embeds = (1 if cfg.tie_embeddings else 2) * cfg.vocab_size * cfg.d_model
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          "training config: remat, bf16 compute, f32 parameters")
    log(f"[{tag}] {arch} training at full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, KV {cfg.num_kv_heads}, d_ff {cfg.d_ff}, d_inner "
        f"{cfg.d_inner if cfg.family != 'dense' else '-'}, vocab {cfg.vocab_size}), "
        f"{cfg.num_layers} of {full.num_layers} layers, peak lr {lr:g}: f32 parameters, "
        f"gradients and "
        f"both AdamW moments take 16 B a parameter, {per_layer / 1e6:.1f} M a layer "
        f"+ {embeds / 1e6:.1f} M embedding: {cfg.num_layers} layers "
        f"{16 * (cfg.num_layers * per_layer + embeds) / 1e9:.1f} GB, all "
        f"{full.num_layers} {16 * (full.num_layers * per_layer + embeds) / 1e9:.1f} GB"
        f" of the card's 80")
    seen = {n: 0 for n in on_path}
    per_step = []

    def on_step(n, rec, state):
        now = {k: kernels[k].launches for k in on_path}
        per_step.append({k: now[k] - seen[k] for k in on_path})
        seen.update(now)
        finite = math.isfinite(rec["loss"]) and all(
            bool(torch.isfinite(p).all()) for p in state.params.values())
        check(finite, f"step {n}: loss and every parameter finite")
        log(f"[{tag}] step {n}: loss {rec['loss']:.4f} (ln {cfg.vocab_size} = "
            f"{math.log(cfg.vocab_size):.2f}), grad_norm {rec['grad_norm']:.4f}, "
            f"lr {rec['lr']:.3e}, {rec['step_s'] * 1e3:.1f} ms host clock")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_B, seq_len=L_TOK,
                    num_samples=TRAIN_SAMPLES, lr=lr, seed=SEED, device=dev,
                    log=lambda m: log(f"[{tag}] {m}"), on_step=on_step)
    run_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}     # the main path's
    want = {k: per * cfg.num_layers for k, per in on_path.items()}
    for n, got in enumerate(per_step, 1):
        check(got == want, f"step {n}: launches {got} == {want} (forward + remat "
              f"recompute, and one backward, a layer)")
    hist = out["history"]
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"the loss fell over the {len(hist)} steps")
    log(f"[{tag}] losses {[round(r['loss'], 4) for r in hist]}")
    warm = [r["step_s"] for r in hist[1:]]
    tokens = TRAIN_B * L_TOK
    params = out["model"].param_count()
    # the input lookup does no product; a tied embedding is the output product
    n_mm = params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    attn = 3 * TRAIN_B * attention_pairs(cfg, L_TOK) * 4 * cfg.head_dim
    model_flops = 6 * n_mm * tokens + attn
    res = dict(arch=arch, layers=cfg.num_layers, lr=lr, params=params, steps=hist,
               cold_step_ms=hist[0]["step_s"] * 1e3,
               warm_step_ms=[t * 1e3 for t in warm],
               tokens_per_s=tokens / statistics.median(warm),
               model_flops=model_flops,
               mfu=model_flops / statistics.median(warm) / PEAK_BF16_FLOPS,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_per_step=per_step, run_s=run_s, counts=counts)
    log(f"[{tag}] {cfg.num_layers} layers, {params / 1e9:.3f} B params; cold step "
        f"{res['cold_step_ms']:.1f} ms, warm steps "
        f"{', '.join(f'{t:.1f}' for t in res['warm_step_ms'])} ms (host clock, fetch "
        f"+ step + synchronize); {res['tokens_per_s']:.0f} tokens/s; model FLOPs "
        f"6 N tokens + attention 3 x 4 dh a (q, k) pair (N = {n_mm / 1e9:.3f} B "
        f"parameters in products; the scan, remat recompute not counted) = "
        f"{model_flops:.4g} a step, {res['mfu']:.3f} of {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16 at the median warm step; peak device memory "
        f"{res['peak_mem_gb']:.2f} GB; launches per step {per_step}; "
        f"run() incl. init and token store {run_s:.1f} s")

    def step():
        out["state"], _ = out["step"](out["state"], out["batch"])

    share, busy_ms, by_name = device_profile(step)
    if share is None:
        log(f"[{tag}] profile: profiler recorded no device time (not measured)")
    else:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        k_ms = {}
        for k in on_path:
            key = PROFILED_AS[k]
            k_ms[key] = sum(ms for n, ms in by_name.items() if key in n)
        calls = {PROFILED_AS[k]: want[k] for k in on_path}
        res["profile"] = dict(busy_share=share, busy_ms=busy_ms, kernel_ms=k_ms,
                              kernel_ms_a_call={k: ms / calls[k] for k, ms in k_ms.items()})
        log(f"[{tag}] profile of one warm step: device busy {busy_ms:.2f} ms, "
            f"{share:.3f} of the kernel window (torch.profiler); "
            + "; ".join(f"{k} {ms:.2f} ms = {ms / busy_ms:.3f} of busy, {calls[k]} calls, "
                        f"{ms / calls[k]:.4f} ms a call" for k, ms in k_ms.items())
            + f"; top kernels (name, ms): {[(n[:60], round(ms, 2)) for n, ms in top]}")
    res["phases_ms"] = step_phases(out)
    log(f"[{tag}] one more warm step by CUDA events (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in res["phases_ms"].items()))
    del out
    return res


def step_phases(out) -> dict:
    """Device time of the phases of one training step: the forward (loss),
    the backward (with each layer's remat recompute) and the AdamW update."""
    from repro_torch.train.optimizer import OptimizerConfig, adamw_update

    model, params = out["model"], out["state"].params
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in params.values():
        p.grad = None
    ev[0].record()
    loss, _ = model.loss(out["batch"]["tokens"])
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = {n: p.grad for n, p in params.items()}
    adamw_update(OptimizerConfig(lr=1e-3), params, grads, out["state"].opt)
    ev[3].record()
    ev[3].synchronize()
    for p in params.values():
        p.grad = None
    return {"forward": ev[0].elapsed_time(ev[1]),
            "backward with recompute": ev[1].elapsed_time(ev[2]),
            "adamw": ev[2].elapsed_time(ev[3])}


K3_SHAPE = (4, 2048, 8192, 16)          # falcon-mamba-7b prefill: B, T, D, S
K3_HYMBA = (4, 2048, 3200, 16)          # hymba-1.5b's mamba mixer
K3_ODD = (4, 2048, 8191, 16)            # the path's, D not a multiple of 8


def k3_inputs(dev, gen, shape, trained: bool):
    """Selective-scan inputs in f32 drawn as the model's init draws them (dt
    in [1e-3, 0.1], A = -(1..S), D = 1), or trained-like: a_log = log(1..S) +
    0.1 * noise per (d, s), and a random D."""
    b, t, d, s = shape
    u = torch.randn((b, t, d), generator=gen, device=dev)
    dt = torch.exp(torch.rand((b, t, d), generator=gen, device=dev) * 4.6 - 6.9)
    b_in, c_in = (torch.randn((b, t, s), generator=gen, device=dev)
                  for _ in range(2))
    a_log = torch.log(torch.arange(1, s + 1, device=dev, dtype=torch.float32)
                      ).expand(d, s).contiguous()
    d_skip = torch.ones((d,), device=dev)
    if trained:
        a_log = a_log + 0.1 * torch.randn((d, s), generator=gen, device=dev)
        d_skip = torch.randn((d,), generator=gen, device=dev)
    return [u, dt, b_in, c_in, a_log, d_skip]


def sm_clock_under(fn, seconds: float = 1.5) -> float:
    """Median SM clock (MHz, nvidia-smi) while ``fn`` runs back to back."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60)
            try:
                samples.append(float(out.stdout.split()[0]))
            except (IndexError, ValueError):
                pass
            time.sleep(0.1)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    check(bool(samples), "nvidia-smi read the SM clock")
    return statistics.median(samples)


def sass_loops(name: str, symbol: str, flags: str):
    """What cuobjdump shows of the bf16 instance of kernel ``symbol`` in
    library ``name`` whose mangled template flags read ``flags`` (``Lb1E``:
    vector staging): ({registers, local_bytes}, its loops (the instructions
    between a backward branch and its target), longest first). Empty where
    the library holds no such function."""
    from repro_torch.kernels import _build

    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    lib = str(_build.library_path(name))

    def dump(flag: str) -> str:
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    def ours(fn: str) -> bool:
        return symbol in fn and f"bfloat16{flags}" in fn

    out = {}
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+)"
                         r" LOCAL:(\d+)", dump("-res-usage")):
        if ours(m[1]):
            out.update(registers=int(m[2]), local_bytes=int(m[5]))
    body = next((f for f in dump("-sass").split("Function : ")[1:]
                 if ours(f.split()[0])), "")
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    spans = sorted(((int(m[1], 16), a) for a, op in ins
                    if (m := re.search(r"BRA (0x[0-9a-f]+)", op)) and int(m[1], 16) < a),
                   key=lambda p: p[0] - p[1])
    return out, [[op for a, op in ins if lo <= a <= hi] for lo, hi in spans]


def k3_sass() -> dict:
    """What cuobjdump shows of K3's bf16 serving instance with 16-byte
    staging (D a multiple of 8, as on the path; no checkpoints of h):
    registers and local memory (spills) per
    thread; in its time loop (the longest backward branch) the instructions
    and MUFU.EX2 per state update, counting 16 updates per y store (STG); and
    whether the chunk-ahead loads all come before the loop's first y store.
    Empty where the library holds no such function: a reading, not a check."""
    out, loops = sass_loops("ssm_scan", "ssm_scan_kernel", "Lb1ELb0E")
    if not loops:
        return out
    loop = loops[0]
    stg = [i for i, op in enumerate(loop) if "STG" in op]
    if not stg:
        return out
    updates = 16 * len(stg)
    return dict(**out, loop_instructions=len(loop),
                instructions_per_update=len(loop) / updates,
                mufu_ex2_per_update=sum("MUFU.EX2" in op for op in loop) / updates,
                loads_before_first_store=all(i < stg[0] for i, op in
                                             enumerate(loop) if "LDG" in op))


def k3b_sass() -> dict:
    """What cuobjdump shows of K3b's bf16 instance with vector staging: its
    registers and local memory, and per state update in its walk loop (one
    chunk of 16 steps with the chunk's recompute, 4 updates a lane a step):
    instructions, MUFU.EX2, shuffles, shared loads and stores, and the
    shared and shuffle accesses in all. A reading, not a check."""
    out, loops = sass_loops("ssm_scan_bwd", "ssm_scan_bwd_kernel", "Lb1E")
    walk = next((lp for lp in loops if any("SHFL" in op for op in lp)), None)
    if walk is None:
        return out
    kinds = {"instructions": "", "mufu_ex2": "MUFU.EX2", "shfl": "SHFL",
             "lds": "LDS", "sts": "STS"}
    for k, op in kinds.items():
        out[f"{k}_per_update"] = sum(op in x for x in walk) / (16 * 4)
    out["shared_and_shuffle_per_update"] = sum(out[f"{k}_per_update"]
                                               for k in ("shfl", "lds", "sts"))
    return out


def k3b_run(ssm_scan, ssm_scan_bwd, ref, dev, gen, shape, kind: str) -> dict:
    """K3b, from K3's checkpoints of h as training calls it, against the
    plain backward (``ssm_scan_bwd_ref``) on bf16 inputs drawn by
    ``k3_inputs``, a random f32 dy and a nonzero dh_final. The
    tolerance: du, ddt, dB and dC (bf16) within rtol 1e-2, one bf16 ulp (both
    sides round the same f32 value once, and f32 sums in another order can
    fall on either side of a rounding boundary); da_log and dD (f32) within
    rtol 1e-4; each with an atol of 1e-4 of the tensor's largest magnitude
    (f32 sums of up to 8192 terms in another order, and 2^x by ex2.approx
    against exp). Two runs give the same bits."""
    b, t, d, s = shape
    args = [x.to(torch.bfloat16) if i < 4 else x for i, x in
            enumerate(k3_inputs(dev, gen, shape, trained=kind == "trained-like"))]
    dy = torch.randn((b, t, d), generator=gen, device=dev)
    dh = torch.randn((b, d, s), generator=gen, device=dev)
    ck = ssm_scan(*args, checkpoints=True)[2]
    got = ssm_scan_bwd(*args, dy, dh, h_checkpoints=ck)
    want = ref.ssm_scan_bwd_ref(*args, dy, dh)
    errs = []
    for name, g, w in zip(("du", "ddt", "dB", "dC", "da_log", "dD"), got, want):
        check(g.dtype == w.dtype, f"K3b {name} dtype {g.dtype} == {w.dtype}")
        scale = max(1.0, w.float().abs().max().item())
        rtol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=1e-4 * scale)
        errs.append((g.float() - w.float()).abs().max().item())
    del want
    again = ssm_scan_bwd(*args, dy, dh, h_checkpoints=ck)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"K3b at {list(shape)} {kind}: two runs give the same bits")
    log(f"[4] ssm_scan_bwd at B,T,D,S={list(shape)} {kind}, bf16 in, f32 dy and "
        f"dh_final, from K3's checkpoints: max_abs_err (du, ddt, dB, dC, da_log, "
        f"dD) {[float(f'{e:.3g}') for e in errs]} (tol: bf16 rtol 1e-2, f32 rtol "
        f"1e-4, atol 1e-4 x max); two runs bit-equal")
    return dict(max_abs_err=max(errs), args=(args, dy, dh, ck))


def flag_runs(flash_attention, ref, q, k, v, window) -> dict:
    """K2 with each attention flag and with both against the plain version
    given the same flags (bf16, tolerance 2e-2); each one's time, and the
    flag-free time measured in turn with them."""
    runs = {}
    for name, flags in (("none", {}), ("scale_in_q", dict(scale_in_q=True)),
                        ("probs_bf16", dict(probs_bf16=True)),
                        ("both", dict(scale_in_q=True, probs_bf16=True))):
        got = flash_attention(q, k, v, window=window, **flags)
        want = ref.attention_ref(q, k, v, window=window, **flags)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        runs[name] = dict(
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            ms=time_ms(lambda: flash_attention(q, k, v, window=window, **flags), 10))
        del got, want
    return runs


def bwd_runs(flash_attention, flash_attention_bwd, ref, q, k, v, window) -> dict:
    """K2 with its LSE output and K2b against the plain versions at one
    shape (bf16 inputs). K2's LSE against the plain one taken in f32 from
    the widened q and k (the kernel's scores are f32 sums of exact products:
    rtol 1e-5, atol 1e-4) and from bf16 scores as the plain bf16 forward
    takes them (2e-2); K2b's gradients against the plain backward given the
    kernel's o and lse (2e-2); and K2 then K2b against the plain forward
    then the plain backward in f32 on the widened inputs, which holds the
    kernels' o, lse and gradients to the exact arithmetic together: each
    gradient's normwise relative error <= 1e-2. That check is normwise
    because P and dS are rounded to bf16, as the reference rounds them, and
    a key's gradient sums up to T x H/KV such terms, so single elements of
    even the plain bf16 path stray past 2e-2 of f32 where the sum cancels;
    a wrong LSE scales every P of its row and moves the norm."""
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator(q.device).manual_seed(SEED + 13),
                     device=q.device).to(q.dtype)
    wide = [x.float() for x in (q, k, v)]
    o32, lse32 = ref.attention_ref(*wide, window=window, return_lse=True)
    torch.testing.assert_close(lse, lse32, rtol=1e-5, atol=1e-4)
    exact = ref.attention_bwd_ref(*wide, o32, lse32, do.float(), window=window)
    lse32_err = (lse - lse32).abs().max().item()
    del wide, o32, lse32
    o_ref, lse_ref = ref.attention_ref(q, k, v, window=window, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2e-2, atol=2e-2)
    lse_err = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    got = flash_attention_bwd(q, k, v, o, lse, do, window=window)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)
    e2e = [((g.float() - x).norm() / x.norm()).item() for g, x in zip(got, exact)]
    check(max(e2e) <= 1e-2, f"K2 then K2b vs the plain f32 forward and backward: "
          f"normwise relative errors (dq, dk, dv) {e2e} <= 1e-2")
    again = flash_attention_bwd(q, k, v, o, lse, do, window=window)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K2b: two runs give the same gradients")
    res = dict(max_abs_err=max((g.float() - w.float()).abs().max().item()
                               for g, w in zip(got, want)),
               e2e_rel_err=e2e, e2e_max_abs_err=max((g.float() - x).abs().max().item()
                                                    for g, x in zip(got, exact)),
               lse_max_abs_err=lse_err, lse_f32_max_abs_err=lse32_err,
               args=(o, lse, do))
    del got, want, exact, again
    return res


def kernel_rows(dev, out: dict, by_path: dict):
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant import dequant
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn_bwd import flash_attention_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.kernels import ssm_scan_bwd as k3b_plan
    from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd

    def launches(name: str) -> dict:
        return dict(launches=sum(c[name] for c in by_path.values()),
                    launches_by_path={p: c[name] for p, c in by_path.items()
                                      if c[name]})

    rows = []
    # K1 dequant at the fetched batch's shape (256, 150528) -> bf16
    q, s = out["dequant_inputs"]
    n, f = q.shape
    got = dequant(q, s)
    check(torch.equal(got, ref.dequant_ref(q, s)), "dequant bit-exact (phase 4)")
    nbytes = q.numel() + s.numel() * 2 + got.numel() * 2
    b_ms, b_by = bound(nbytes, q.numel(), PEAK_F32_FLOPS)
    rows.append(dict(
        name="dequant", route="cuda", source="src/repro_torch/csrc/dequant.cu",
        replaces="src/repro/kernels/dequant.py:36", **launches("dequant"),
        max_abs_err=0.0, ms=time_ms(lambda: dequant(q, s), 50),
        plain_ms=time_ms(lambda: ref.dequant_ref(q, s), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K2 flash attention at the prefill's shape, bf16, causal
    B, T, H, KV, DH = 4, 2048, 32, 2, 128
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    qa = torch.randn((B, T, H, DH), generator=gen, device=dev).to(torch.bfloat16)
    ka = torch.randn((B, T, KV, DH), generator=gen, device=dev).to(torch.bfloat16)
    va = torch.randn((B, T, KV, DH), generator=gen, device=dev).to(torch.bfloat16)
    got = flash_attention(qa, ka, va)
    want = ref.attention_ref(qa, ka, va)
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    pairs = B * H * T * (T + 1) // 2                 # causal (q, k) pairs
    flops = pairs * (2 * DH + 2 * DH)
    nbytes = 2 * (qa.numel() + ka.numel() + va.numel() + got.numel())
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    g = H // KV
    qs_, ks_, vs_ = (qa.transpose(1, 2).contiguous(),
                     ka.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
                     va.repeat_interleave(g, dim=2).transpose(1, 2).contiguous())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qs_, ks_, vs_, is_causal=True).transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()
    k2_ms = time_ms(lambda: flash_attention(qa, ka, va), 10)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attn_fwd.cu",
        replaces="src/repro/kernels/flash_attn.py:86",
        **launches("flash_attention"), max_abs_err=err, ms=k2_ms,
        plain_ms=time_ms(lambda: ref.attention_ref(qa, ka, va), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(qs_, ks_, vs_, is_causal=True), 10),
        tflops=flops / k2_ms / 1e9, bound_share=b_ms / k2_ms))
    del got, want, lib
    # with the attention flags, at chatglm3-6b's shape and at hymba-1.5b's
    # (GQA group 5, dh 64, window 1024 as in 29 of its 32 layers)
    hb, hh, hkv, hdh, hwin = 4, 25, 5, 64, 1024
    qh, kh, vh = (torch.randn((hb, T, n, hdh), generator=gen, device=dev
                              ).to(torch.bfloat16) for n in (hh, hkv, hkv))
    flag_ms = {"chatglm3-6b": flag_runs(flash_attention, ref, qa, ka, va, None),
               "hymba-1.5b": flag_runs(flash_attention, ref, qh, kh, vh, hwin)}
    rows[1]["flags"] = flag_ms
    hymba_err = flag_ms["hymba-1.5b"]["none"]["max_abs_err"]
    hymba_ms = flag_ms["hymba-1.5b"]["none"]["ms"]

    # K2b at chatglm3-6b's training shape (the same q, k, v) and hymba-1.5b's
    bw = {"chatglm3-6b": bwd_runs(flash_attention, flash_attention_bwd, ref, qa, ka, va, None),
          "hymba-1.5b": bwd_runs(flash_attention, flash_attention_bwd, ref, qh, kh, vh, hwin)}
    o, lse, do = bw["chatglm3-6b"].pop("args")
    _, _, do_h = hymba_args = bw["hymba-1.5b"].pop("args")
    bw_flops = 2.5 * flops                  # five products where the forward has two
    bw_bytes = 2 * (qa.numel() + ka.numel() + va.numel() + 2 * o.numel()) + 4 * lse.numel() \
        + 2 * (qa.numel() + ka.numel() + va.numel())
    b_ms, b_by = bound(bw_bytes, bw_flops, PEAK_BF16_FLOPS)
    qs, ks, vs = (x.detach().requires_grad_() for x in (qs_, ks_, vs_))
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos,
                                                     retain_graph=True), 10)
    k2b_ms = time_ms(lambda: flash_attention_bwd(qa, ka, va, o, lse, do), 5)
    # its two launches apart: the D pre-pass and the main kernel
    _, _, parts = device_profile(lambda: [flash_attention_bwd(qa, ka, va, o, lse, do)
                                          for _ in range(5)])
    k2b_parts = {k: sum(ms for n, ms in parts.items() if k in n) / 5
                 for k in ("flash_bwd_prep", "flash_bwd_wgmma")}
    k2_ms_a = time_ms(lambda: flash_attention(qa, ka, va), 10)        # without, with,
    k2_lse_a = time_ms(lambda: flash_attention(qa, ka, va, return_lse=True), 10)
    k2_lse_b = time_ms(lambda: flash_attention(qa, ka, va, return_lse=True), 10)
    k2_ms_b = time_ms(lambda: flash_attention(qa, ka, va), 10)        # with, without
    hymba_bwd_ms = time_ms(lambda: flash_attention_bwd(qh, kh, vh, *hymba_args[:2], do_h,
                                                       window=hwin), 5)
    rows.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attn_bwd.cu",
        replaces="src/repro/models/layers.py:129",
        note="no TPU kernel: the backward JAX derives from flash_attention_lax",
        **launches("flash_attention_bwd"),
        max_abs_err=bw["chatglm3-6b"]["max_abs_err"], ms=k2b_ms,
        plain_ms=time_ms(lambda: ref.attention_bwd_ref(qa, ka, va, o, lse, do), 1,
                         windows=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd_ms,
        tflops=bw_flops / k2b_ms / 1e9, bound_share=b_ms / k2b_ms,
        hymba_ms=hymba_bwd_ms, by_shape=bw, device_ms_by_kernel=k2b_parts,
        k2_ms=[k2_ms_a, k2_ms_b], k2_lse_ms=[k2_lse_a, k2_lse_b]))
    del qs, ks, vs, qs_, ks_, vs_, lib_out, dos, o, lse, do, hymba_args, do_h
    del qa, ka, va, qh, kh, vh

    # K3 selective scan at falcon-mamba-7b's prefill shape, bf16 as on the
    # path, held to the plain version on init-like inputs (A = -(1..S)) and
    # trained-like ones (a_log = log(1..S) + noise per (d, s)), each in bf16
    # and f32; then timed there and at hymba-1.5b's shape (the next slice's)
    b3, t3, d3, s3 = K3_SHAPE
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    errs = {}
    for kind in ("init-like", "trained-like"):
        args32 = k3_inputs(dev, gen, K3_SHAPE, trained=kind == "trained-like")
        for name, args in (("f32", args32),
                           ("bf16", [x.to(torch.bfloat16) for x in args32])):
            got, want = ssm_scan(*args), ref.ssm_scan_ref(*args)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
            errs[f"{kind} {name}"] = max((g - w).abs().max().item()
                                         for g, w in zip(got, want))
            del got, want
        del args32
    args16 = [x.to(torch.bfloat16) for x in k3_inputs(dev, gen, K3_SHAPE, False)]
    nbytes = (sum(x.numel() * x.element_size() for x in args16)
              + 4 * (b3 * t3 * d3 + b3 * d3 * s3))
    k3_ms = time_ms(lambda: ssm_scan(*args16), 10)
    mhz = sm_clock_under(lambda: ssm_scan(*args16))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # one exp an update, on the special-function unit: 16 a clock per SM
    mufu_ms = b3 * t3 * d3 * s3 / (16 * sms * mhz * 1e6) * 1e3
    # f32 arithmetic, an FMA counted 2, the exp left to the MUFU floor: per
    # (b, t, d, s) dt*a, (dt*u)*B, the FMA into h and the FMA into y (6); per
    # (b, t, d) dt*u and the FMA of D*u into y (3)
    ops_count = 6 * b3 * t3 * d3 * s3 + 3 * b3 * t3 * d3
    b_ms, b_by = bound(nbytes, ops_count, PEAK_F32_FLOPS, mufu_ms)
    hy = [x.to(torch.bfloat16) for x in k3_inputs(dev, gen, K3_HYMBA, False)]
    hy_err = max((g - w).abs().max().item()
                 for g, w in zip(ssm_scan(*hy), ref.ssm_scan_ref(*hy)))
    check(hy_err <= 1e-4, f"ssm_scan at hymba's shape max err {hy_err} <= 1e-4")
    hy_ms = time_ms(lambda: ssm_scan(*hy), 10)
    del hy
    od = [x.to(torch.bfloat16) for x in k3_inputs(dev, gen, K3_ODD, False)]
    od_err = max((g - w).abs().max().item()
                 for g, w in zip(ssm_scan(*od), ref.ssm_scan_ref(*od)))
    check(od_err <= 1e-4, f"ssm_scan at D = {K3_ODD[2]} max err {od_err} <= 1e-4")
    od_ms = time_ms(lambda: ssm_scan(*od), 10)
    k3_ms2 = time_ms(lambda: ssm_scan(*args16), 10)
    del od
    rows.append(dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:64", **launches("ssm_scan"),
        max_abs_err=max(errs.values()), ms=k3_ms,
        plain_ms=time_ms(lambda: ref.ssm_scan_ref(*args16), 1, windows=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, bound_share=b_ms / k3_ms,
        bytes_ms=nbytes / PEAK_BYTES_S * 1e3, f32_ops_ms=ops_count / PEAK_F32_FLOPS * 1e3,
        mufu_floor_ms=mufu_ms, sm_clock_mhz=mhz, hymba_ms=hy_ms,
        odd_d_ms=od_ms, ms_after_odd_d=k3_ms2, sass=k3_sass()))
    del args16

    # K3b, the scan's backward, at falcon-mamba-7b's training shape (init-like
    # and trained-like inputs) and hymba-1.5b's, bf16 inputs, f32 dy and a
    # nonzero dh_final, against the plain reverse loop
    k3b = {}
    for shape, kind in ((K3_SHAPE, "init-like"), (K3_SHAPE, "trained-like"),
                        (K3_HYMBA, "init-like")):
        k3b[(shape, kind)] = k3b_run(ssm_scan, ssm_scan_bwd, ref, dev, gen, shape, kind)
    args, dy, dh, ck = k3b.pop((K3_SHAPE, "init-like"))["args"]

    def k3b_bound(shape):
        """(bytes, f32 operations, MUFU floor ms, bound) of K3b at ``shape``
        (bf16 u, dt, B, C and f32 a_log, d_skip read and their gradients
        written, f32 dy and dh_final read). The operations are the least f32
        arithmetic the gradient needs, an FMA counted 2, the exp (one an
        update) left to the MUFU floor. Per (b, t, d, s), 18: the state
        dt*a, (dt*u)*B, p = ā*h_{t-1} and h = p + (dt*u)*B (4); the adjoint
        g = dy*C + ā_{t+1}*g_{t+1} (3); FMAs of dy*h into dC, g*(dt*u) into
        dB and g*B into Σ_s gB (6); q = g*p, then FMAs of a*q into ddt and
        dt*q into da_log (5). Per (b, t, d), 8: dt*u (1), du = dt*Σ_s gB +
        D*dy (3), ddt += u*Σ_s gB (2), dD += dy*u (2)."""
        b_, t_, d_, s_ = shape
        nb = (2 * 2 * (2 * b_ * t_ * d_ + 2 * b_ * t_ * s_)
              + 2 * 4 * (d_ * s_ + d_) + 4 * (b_ * t_ * d_ + b_ * d_ * s_))
        ops = 18 * b_ * t_ * d_ * s_ + 8 * b_ * t_ * d_
        mufu = b_ * t_ * d_ * s_ / (16 * sms * mhz * 1e6) * 1e3
        return nb, ops, mufu, bound(nb, ops, PEAK_F32_FLOPS, mufu)

    nbytes, ops_count, _, (b_ms, b_by) = k3b_bound(K3_SHAPE)
    # K3b as training calls it, from K3's checkpoints, and K3 timed without
    # and with writing them: under remat K3 runs twice a layer and writes
    # them both times, so a layer's scan backward costs K3b plus twice the
    # difference
    k3b_ms = time_ms(lambda: ssm_scan_bwd(*args, dy, dh, h_checkpoints=ck), 5)
    k3_ck_ms = [time_ms(lambda: ssm_scan(*args, checkpoints=c), 10) for c in (False, True)]
    hy_args, hy_dy, hy_dh, hy_ck = k3b[(K3_HYMBA, "init-like")].pop("args")
    k3b_hy_ms = time_ms(lambda: ssm_scan_bwd(*hy_args, hy_dy, hy_dh,
                                             h_checkpoints=hy_ck), 5)
    hy_k3_ck_ms = [time_ms(lambda: ssm_scan(*hy_args, checkpoints=c), 10)
                   for c in (False, True)]
    del hy_args, hy_dy, hy_dh, hy_ck, ck
    layer_ms = {tag: k3b + 2 * (k3[1] - k3[0]) for tag, k3b, k3 in
                (("falcon", k3b_ms, k3_ck_ms), ("hymba", k3b_hy_ms, hy_k3_ck_ms))}
    _, _, hy_mufu_ms, (hy_b_ms, hy_b_by) = k3b_bound(K3_HYMBA)
    # the launch plan: blocks, and the waves they take at the blocks an SM
    # that the card's occupancy calculator gives for the path's instance
    per_sm = k3b_plan.blocks_per_sm(in_bf16=True, vec=True)
    plans = {tag: k3b_plan.plan(*shape) for tag, shape in
             (("falcon", K3_SHAPE), ("hymba", K3_HYMBA))}
    waves = {tag: dict(blocks=pl.blocks, blocks_per_sm=per_sm,
                       warps_per_sm=per_sm * k3b_plan.WARPS,
                       waves=pl.waves(sms, per_sm), planned_waves=pl.waves(sms))
             for tag, pl in plans.items()}
    k3b_errs = {f"{'falcon' if sh == K3_SHAPE else 'hymba'} {kind}": r["max_abs_err"]
                for (sh, kind), r in k3b.items()}
    rows.append(dict(
        name="ssm_scan_bwd", route="cuda", source="src/repro_torch/csrc/ssm_scan_bwd.cu",
        replaces="src/repro/models/mamba.py:85",
        note="no TPU kernel: the backward JAX derives from selective_scan",
        **launches("ssm_scan_bwd"), max_abs_err=k3b_errs["falcon trained-like"],
        ms=k3b_ms,
        plain_ms=time_ms(lambda: ref.ssm_scan_bwd_ref(*args, dy, dh), 1, windows=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, bound_share=b_ms / k3b_ms,
        bytes_ms=nbytes / PEAK_BYTES_S * 1e3, f32_ops_ms=ops_count / PEAK_F32_FLOPS * 1e3,
        mufu_floor_ms=mufu_ms, hymba_ms=k3b_hy_ms,
        k3_ms_without_and_with_checkpoints=k3_ck_ms,
        hymba_k3_ms_without_and_with_checkpoints=hy_k3_ck_ms,
        with_k3_checkpoint_writes_ms=layer_ms,
        hymba_bound_ms=hy_b_ms, hymba_bound_by=hy_b_by,
        hymba_bound_share=hy_b_ms / k3b_hy_ms, hymba_mufu_floor_ms=hy_mufu_ms,
        max_abs_errs=k3b_errs, waves=waves, sass=k3b_sass()))
    del args, dy, dh
    by = {r["name"]: r for r in rows}
    shapes = {"dequant": f"q {[n, f]} int8 -> bf16",
              "flash_attention": f"B,T,H,KV,dh={[B, T, H, KV, DH]} bf16 causal, "
                                 f"tol rtol=atol=2e-2; SDPA vs plain max_abs_err "
                                 f"{lib_err:.3g}; {by['flash_attention']['tflops']:.1f} TFLOP/s, "
                                 f"{by['flash_attention']['bound_share']:.3f} of the bound; at "
                                 f"hymba's B,T,H,KV,dh,window="
                                 f"{[hb, T, hh, hkv, hdh, hwin]} max_abs_err "
                                 f"{hymba_err:.3g} (tol 2e-2), {hymba_ms:.4f} ms",
              "ssm_scan": f"B,T,D,S={list(K3_SHAPE)} bf16 in, f32 out, tol "
                          f"rtol=atol=1e-4; max_abs_err "
                          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; "
                          f"{by['ssm_scan']['bound_share']:.3f} of the bound (bytes "
                          f"{by['ssm_scan']['bytes_ms']:.4f} ms, f32 arithmetic "
                          f"{by['ssm_scan']['f32_ops_ms']:.4f} ms, MUFU floor "
                          f"{mufu_ms:.4f} ms at {mhz:.0f} MHz under load); at "
                          f"hymba's B,T,D,S={list(K3_HYMBA)} {hy_ms:.4f} ms "
                          f"(max_abs_err {hy_err:.3g}); at D={K3_ODD[2]} "
                          f"(element-wise staging) {od_ms:.4f} ms (max_abs_err "
                          f"{od_err:.3g}), then at D={d3} again {k3_ms2:.4f} ms; "
                          f"SASS {by['ssm_scan']['sass']}",
              "ssm_scan_bwd": f"B,T,D,S={list(K3_SHAPE)} bf16 in, f32 dy and dh_final "
                              f"(falcon-mamba-7b's training shape), from K3's "
                              f"checkpoints, deterministic; "
                              f"{by['ssm_scan_bwd']['bound_share']:.3f} of the bound "
                              f"(bytes {by['ssm_scan_bwd']['bytes_ms']:.4f} ms, f32 "
                              f"arithmetic {by['ssm_scan_bwd']['f32_ops_ms']:.4f} ms, "
                              f"MUFU floor of one exp an update, as this design "
                              f"takes them, {mufu_ms:.4f} ms); max_abs_err "
                              f"{k3b_errs}; K3 without / with writing the "
                              f"checkpoints {k3_ck_ms[0]:.4f} / {k3_ck_ms[1]:.4f} ms; "
                              f"at hymba's B,T,D,S={list(K3_HYMBA)} {k3b_hy_ms:.4f} ms, "
                              f"bound {hy_b_ms:.4f} ms ({hy_b_by}), "
                              f"{by['ssm_scan_bwd']['hymba_bound_share']:.3f} of it, MUFU "
                              f"floor {hy_mufu_ms:.4f} ms, K3 without / with "
                              f"{hy_k3_ck_ms[0]:.4f} / {hy_k3_ck_ms[1]:.4f} ms; a "
                              f"layer's K3b plus K3's two checkpoint writes under "
                              f"remat {layer_ms}; blocks and waves {waves}; SASS "
                              f"{by['ssm_scan_bwd']['sass']}",
              "flash_attention_bwd": f"B,T,H,KV,dh={[B, T, H, KV, DH]} bf16 causal (chatglm3-6b's "
                                     f"training shape), tol rtol=atol=2e-2, deterministic; "
                                     f"{by['flash_attention_bwd']['tflops']:.1f} TFLOP/s, "
                                     f"{by['flash_attention_bwd']['bound_share']:.3f} of the bound (2.5 x the "
                                     f"forward's {flops:.4g} FLOP); device ms a call by "
                                     f"kernel (profiler) "
                                     f"{ {k: round(v, 4) for k, v in k2b_parts.items()} }; "
                                     f"library = SDPA's backward "
                                     f"alone, kv heads repeated; K2 without / with LSE "
                                     f"{k2_ms_a:.4f} / {k2_lse_a:.4f}, {k2_lse_b:.4f} / "
                                     f"{k2_ms_b:.4f} ms; K2 then K2b vs the plain forward "
                                     f"then backward in f32: normwise relative error (dq, dk, dv) "
                                     f"{[round(e, 5) for e in bw['chatglm3-6b']['e2e_rel_err']]} "
                                     f"(tol 1e-2), max_abs_err "
                                     f"{bw['chatglm3-6b']['e2e_max_abs_err']:.3g}; "
                                     f"LSE max_abs_err vs f32 scores "
                                     f"{bw['chatglm3-6b']['lse_f32_max_abs_err']:.3g} (tol "
                                     f"rtol 1e-5, atol 1e-4), vs bf16 scores "
                                     f"{bw['chatglm3-6b']['lse_max_abs_err']:.3g}; at hymba's "
                                     f"B,T,H,KV,dh,window={[hb, T, hh, hkv, hdh, hwin]} "
                                     f"{hymba_bwd_ms:.4f} ms, max_abs_err "
                                     f"{bw['hymba-1.5b']['max_abs_err']:.3g}, K2 then K2b vs f32 "
                                     f"{[round(e, 5) for e in bw['hymba-1.5b']['e2e_rel_err']]} "
                                     f"normwise, max_abs_err "
                                     f"{bw['hymba-1.5b']['e2e_max_abs_err']:.3g}, LSE vs f32 "
                                     f"{bw['hymba-1.5b']['lse_f32_max_abs_err']:.3g}, vs bf16 "
                                     f"{bw['hymba-1.5b']['lse_max_abs_err']:.3g}"}
    for r in rows:
        log(f"[4] {r['name']} {shapes[r['name']]}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3g}, launches on the main paths {r['launches']} "
            f"{r['launches_by_path']}")
    for shape, runs in flag_ms.items():
        log(f"[4] flash_attention with the attention flags at {shape}'s shape "
            f"(bf16, vs the plain version with the same flags, tol rtol=atol="
            f"2e-2; ms, max_abs_err): " + ", ".join(
                f"{f} {r['ms']:.4f} {r['max_abs_err']:.3g}" for f, r in runs.items()))
    return rows


def zero_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def host_loop_ms() -> float:
    """Host-clock ms of a fixed pure-Python loop: how fast the host ran."""
    t0, x = time.perf_counter(), 0
    for i in range(2_000_000):
        x += i
    return (time.perf_counter() - t0) * 1e3


def import_port(root: Path):
    """Import the port of the checkout at ``root`` afresh (its kernels built
    into its own ``build/``); returns its ``launch.serve`` and the served
    configs. What was built from a port imported before keeps using that
    port's modules."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    src = str(root / "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.launch import serve
        _build.build(["flash_attn_fwd", "ssm_scan"])
        cfgs = {a: get_config(a).scaled(remat=False, param_dtype="bfloat16")
                for a in SERVED}
    finally:
        sys.path.remove(src)
    return serve, cfgs


def serve_turn(dev, port, prompt) -> dict:
    """One turn of ``--serve-ab``: each served model built with ``port``
    from SEED, a cold prefill and 32 decode steps (``serve.run``, as in
    phase 3), then a warm prefill."""
    serve, cfgs = port
    res = {"host_loop_ms": host_loop_ms()}
    for arch, cfg in cfgs.items():
        _, t, model = serve.run(cfg, prompt, steps=DECODE_STEPS + 1, seed=SEED,
                                device=dev)
        res[arch] = dict(prefill_ms=t["prefill_s"] * 1e3,
                         warm_prefill_ms=warm_prefill_ms(model, prompt),
                         decode_ms_per_step=t["decode_s"] * 1e3 / DECODE_STEPS)
        del model
        torch.cuda.empty_cache()
    return res


def serve_ab(parent: Path, rounds: int) -> int:
    """``--serve-ab PARENT``: PARENT's port and this one's, both imported in
    this process, serve in turns (parent, this, this, parent) ``rounds``
    times after one unrecorded turn each."""
    check((parent / "src" / "repro_torch").is_dir(),
          f"{parent} holds a checkout of the port")
    dev = torch.device("cuda")
    ports = {"parent": import_port(parent.resolve()), "this": import_port(ROOT)}
    vocab = min(cfg.vocab_size for cfg in ports["this"][1].values())
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, vocab, (G_TOK, L_TOK)).astype(np.int32)).to(dev)
    for name in ports:                          # first use of each, not recorded
        serve_turn(dev, ports[name], prompt)
    runs: dict = {"parent": [], "this": []}
    for r in range(rounds):
        for name in ("parent", "this", "this", "parent"):
            res = serve_turn(dev, ports[name], prompt)
            runs[name].append(res)
            log(f"[ab] round {r + 1} {name}: host loop {res['host_loop_ms']:.1f} ms; "
                + "; ".join(f"{a} prefill {res[a]['prefill_ms']:.2f}, warm "
                            f"{res[a]['warm_prefill_ms']:.2f}, decode "
                            f"{res[a]['decode_ms_per_step']:.3f} ms/step"
                            for a in SERVED))
    keys = ["host_loop_ms"] + [f"{a} {m}" for a in SERVED for m in
                               ("prefill_ms", "warm_prefill_ms", "decode_ms_per_step")]

    def value(res: dict, key: str) -> float:
        arch, _, metric = key.rpartition(" ")
        return res[arch][metric] if arch else res[metric]

    summary = {k: {name: [value(res, k) for res in rs] for name, rs in runs.items()}
               for k in keys}
    for k, by_tree in summary.items():
        log(f"[ab] {k}: " + "; ".join(
            f"{name} median {statistics.median(v):.3f} (min {min(v):.3f}, max "
            f"{max(v):.3f})" for name, v in by_tree.items()))
    print(json.dumps({"serve_ab": summary}), flush=True)
    print(smi_line(), flush=True)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one NVIDIA card.")
    ap.add_argument("--serve-ab", type=Path, metavar="PARENT",
                    help="compare PARENT's serving times with this checkout's")
    ap.add_argument("--rounds", type=int, default=3,
                    help="turns of parent, this, this, parent (--serve-ab)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run",
              file=sys.stderr)
        return 2
    if args.serve_ab:
        return serve_ab(args.serve_ab, args.rounds)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant import dequant
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn_bwd import flash_attention_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd

    kernels = (dequant, flash_attention, flash_attention_bwd, ssm_scan, ssm_scan_bwd)
    by_name = {k.__name__: k for k in kernels}
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    reports = _build.build(["dequant", "flash_attn_fwd", "flash_attn_bwd", "ssm_scan",
                            "ssm_scan_bwd"])
    log(f"[1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    lines = [(name, fn, line) for name, rep in reports.items()
             for fn, line in ptxas_lines(rep)]
    names = demangled(fn for _, fn, _ in lines)
    for name, fn, line in lines:
        log(f"[1]   {name} {names[fn]}: {line}")
    spills = [f"{names[fn]}: {line}" for name, fn, line in lines
              if name in ("flash_attn_bwd", "ssm_scan_bwd") and "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(not spills, f"no K2b or K3b kernel spills registers: {spills}")

    for arch in SERVED:
        reference_small(dev, arch)
    for _, arch, _, _ in TRAIN_RUNS:
        reference_train_small(dev, arch, by_name)

    # the main paths, each with the counts set to 0 just before it and read
    # just after: the device tier, then each model serving the prompt it
    # fetched (stores resident), one model at a time, then training each
    out: dict = {}
    by_path: dict = {}
    zero_counts(kernels)
    prompt = device_tier(dev, out)
    by_path["device tier"] = {k.__name__: k.launches for k in kernels}
    check(by_path["device tier"]["dequant"] >= 1,
          "dequant kernel launched on the main path")
    serving = {}
    for arch, tags, on_path in (
            ("chatglm3-6b", "bcd", ("flash_attention",)),
            ("falcon-mamba-7b", "efg", ("ssm_scan",)),
            ("hymba-1.5b", "hij", ("flash_attention", "ssm_scan"))):
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        res, model = serve_full(dev, arch, f"3{tags[0]}", prompt)
        counts = by_path[arch] = {k.__name__: k.launches for k in kernels}
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[3{tags[0]}] {arch} launches {counts}; peak device memory "
            f"{res['peak_mem_gb']:.2f} GB (stores resident)")
        for name in on_path:
            check(counts[name] == res["layers"], f"{name} kernel launched once "
                  f"per layer of {arch}'s one prefill ({res['layers']})")
        check(counts["flash_attention_bwd"] == 0 == counts["ssm_scan_bwd"],
              "serving launches no backward")
        full_width_logits(f"3{tags[1]}", model, prompt)
        res["profile"] = profile_serving(f"3{tags[2]}", model, prompt,
                                         [PROFILED_AS[n] for n in on_path])
        serving[arch] = res
        del model
        torch.cuda.empty_cache()
    del out["stores"]
    torch.cuda.empty_cache()

    training = {}
    for tag, arch, layers, lr in TRAIN_RUNS:
        zero_counts(kernels)
        training[arch] = train_full(dev, by_name, tag, arch, layers, lr)
        by_path["training " + arch] = training[arch].pop("counts")
        torch.cuda.empty_cache()

    rows = kernel_rows(dev, out, by_path)
    log("[5] " + json.dumps({"serve": serving, "train": training,
                             "fetch_decode_ms": out["fetch_decode_ms"]}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

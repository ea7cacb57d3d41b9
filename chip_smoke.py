#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py            (from the root of a checkout; needs one card)

Phases, each of which raises on a failed check:
  1. environment: torch version, the card's name and power limit; build the
     three CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each, in
     parallel) and print ptxas' registers and spills per kernel instance
     (flash attention: one per head dim and setting of the two attention
     flags);
  2. references at a small size: the chatglm3, falcon-mamba and hymba smoke
     models in f32 on the card (through the kernels) against the same
     weights on the CPU (plain path);
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
        shares of device busy;
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
     MUFU.EX2 per update).
The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` name/power
line and ``{"ok": true, "device": ...}``. Without a card, or without the rest
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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
sys.path.insert(0, str(ROOT / "src"))

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
# a wrapper's kernel as torch.profiler names it
PROFILED_AS = {"flash_attention": "flash_fwd", "ssm_scan": "ssm_scan_kernel"}


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


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / peak_flops * 1e3
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

    res = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        res["warm_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"[{tag}] warm prefill {tuple(prompt.shape)}: "
            f"{res['warm_prefill_ms']:.2f} ms host clock")
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


def k3_sass() -> dict:
    """What cuobjdump shows of K3's bf16 instance with 16-byte staging (D a
    multiple of 8, as on the path): registers and local memory (spills) per
    thread; in its time loop (the longest backward branch) the instructions
    and MUFU.EX2 per state update, counting 16 updates per y store (STG); and
    whether the chunk-ahead loads all come before the loop's first y store.
    Empty where the library holds no such function: a reading, not a check."""
    from repro_torch.kernels import _build

    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    lib = str(_build.library_path("ssm_scan"))

    def dump(flag: str) -> str:
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout

    def ours(fn: str) -> bool:       # ssm_scan_kernel<__nv_bfloat16, true>
        return "ssm_scan_kernel" in fn and "bfloat16" in fn and "Lb1E" in fn

    out = {}
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+)"
                         r" LOCAL:(\d+)", dump("-res-usage")):
        if ours(m[1]):
            out.update(registers=int(m[2]), local_bytes=int(m[5]))
    body = next((f for f in dump("-sass").split("Function : ")[1:]
                 if ours(f.split()[0])), "")
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = [(int(m[1], 16), a) for a, op in ins
             if (m := re.search(r"BRA (0x[0-9a-f]+)", op)) and int(m[1], 16) < a]
    if not loops:
        return out
    lo, hi = max(loops, key=lambda p: p[1] - p[0])
    loop = [op for a, op in ins if lo <= a <= hi]
    stg = [i for i, op in enumerate(loop) if "STG" in op]
    if not stg:
        return out
    updates = 16 * len(stg)
    return dict(**out, loop_instructions=len(loop),
                instructions_per_update=len(loop) / updates,
                mufu_ex2_per_update=sum("MUFU.EX2" in op for op in loop) / updates,
                loads_before_first_store=all(i < stg[0] for i, op in
                                             enumerate(loop) if "LDG" in op))


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


def kernel_rows(dev, out: dict, by_path: dict):
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant import dequant
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan

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
    qs, ks, vs = (qa.transpose(1, 2).contiguous(),
                  ka.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
                  va.repeat_interleave(g, dim=2).transpose(1, 2).contiguous())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qs, ks, vs, is_causal=True).transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()
    k2_ms = time_ms(lambda: flash_attention(qa, ka, va), 10)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attn_fwd.cu",
        replaces="src/repro/kernels/flash_attn.py:86",
        **launches("flash_attention"), max_abs_err=err, ms=k2_ms,
        plain_ms=time_ms(lambda: ref.attention_ref(qa, ka, va), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), 10),
        tflops=flops / k2_ms / 1e9, bound_share=b_ms / k2_ms))
    del qs, ks, vs, got, want, lib
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
    # per (b, t, d, s): dt*A', exp, FMA into h, (dt*u)*B, FMA into y;
    # per (b, t, d): dt*u, D*u and its add
    ops_count = 7 * b3 * t3 * d3 * s3 + 3 * b3 * t3 * d3
    b_ms, b_by = bound(nbytes, ops_count, PEAK_F32_FLOPS)
    k3_ms = time_ms(lambda: ssm_scan(*args16), 10)
    mhz = sm_clock_under(lambda: ssm_scan(*args16))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # every exp on the special-function unit: 16 a clock per SM
    mufu_ms = b3 * t3 * d3 * s3 / (16 * sms * mhz * 1e6) * 1e3
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
        mufu_floor_ms=mufu_ms, sm_clock_mhz=mhz, hymba_ms=hy_ms,
        odd_d_ms=od_ms, ms_after_odd_d=k3_ms2, sass=k3_sass()))
    del args16
    shapes = {"dequant": f"q {[n, f]} int8 -> bf16",
              "flash_attention": f"B,T,H,KV,dh={[B, T, H, KV, DH]} bf16 causal, "
                                 f"tol rtol=atol=2e-2; SDPA vs plain max_abs_err "
                                 f"{lib_err:.3g}; {rows[1]['tflops']:.1f} TFLOP/s, "
                                 f"{rows[1]['bound_share']:.3f} of the bound; at "
                                 f"hymba's B,T,H,KV,dh,window="
                                 f"{[hb, T, hh, hkv, hdh, hwin]} max_abs_err "
                                 f"{hymba_err:.3g} (tol 2e-2), {hymba_ms:.4f} ms",
              "ssm_scan": f"B,T,D,S={list(K3_SHAPE)} bf16 in, f32 out, tol "
                          f"rtol=atol=1e-4; max_abs_err "
                          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; "
                          f"{rows[2]['bound_share']:.3f} of the bound; MUFU floor "
                          f"{mufu_ms:.4f} ms at {mhz:.0f} MHz under load; at "
                          f"hymba's B,T,D,S={list(K3_HYMBA)} {hy_ms:.4f} ms "
                          f"(max_abs_err {hy_err:.3g}); at D={K3_ODD[2]} "
                          f"(element-wise staging) {od_ms:.4f} ms (max_abs_err "
                          f"{od_err:.3g}), then at D={d3} again {k3_ms2:.4f} ms; "
                          f"SASS {rows[2]['sass']}"}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant import dequant
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan

    kernels = (dequant, flash_attention, ssm_scan)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    reports = _build.build(["dequant", "flash_attn_fwd", "ssm_scan"])
    log(f"[1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    lines = [(name, fn, line) for name, rep in reports.items()
             for fn, line in ptxas_lines(rep)]
    names = demangled(fn for _, fn, _ in lines)
    for name, fn, line in lines:
        log(f"[1]   {name} {names[fn]}: {line}")

    for arch in SERVED:
        reference_small(dev, arch)

    # the main paths, each with the counts set to 0 just before it and read
    # just after: the device tier, then each model serving the prompt it
    # fetched (stores resident), one model at a time
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
        full_width_logits(f"3{tags[1]}", model, prompt)
        res["profile"] = profile_serving(f"3{tags[2]}", model, prompt,
                                         [PROFILED_AS[n] for n in on_path])
        serving[arch] = res
        del model
        torch.cuda.empty_cache()
    del out["stores"]
    torch.cuda.empty_cache()

    rows = kernel_rows(dev, out, by_path)
    log("[5] " + json.dumps({"serve": serving,
                             "fetch_decode_ms": out["fetch_decode_ms"]}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

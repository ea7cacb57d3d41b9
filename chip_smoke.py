#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py            (from the root of a checkout; needs one card)

Phases, each of which raises on a failed check:
  1. environment: torch version, the card's name and power limit; build both
     CUDA kernels from ``src/repro_torch/csrc`` (nvcc, in parallel);
  2. reference at a small size: the chatglm3 smoke model in f32 on the card
     (through the kernels) against the same weights on the CPU (plain path);
  3. the main path, with every kernel launch counter set to 0 first:
     a. device tier: a block-quantized ImageNet-size record store
        (40 000 x 151 704 B, ~6.1 GB) and a token store (262 144 x 2 048
        tokens, 2 GiB), both made on the card from a seed; a fetch of 256
        records decoded by the dequant kernel to bf16 and f32; a fetch of 4
        token records that becomes the prompt; the overflow flag at
        capacity_factor 0.5;
     b. serving chatglm3-6b at full width and depth with random bf16 weights
        (``repro_torch.launch.serve.run``): a 4 x 2048 prompt, 32 greedy
        decode steps;
  4. each kernel against its plain version at the main path's shapes, and
     its time beside the plain version's, a library call's where one exists
     and the card's bound for the same work.
The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` name/power
line and ``{"ok": true, "device": ...}``. Without a card, or without the rest
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def reference_small(dev) -> None:
    """chatglm3 smoke model in f32: card (kernels) vs CPU (plain path)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve.serve_step import generate

    cfg = get_smoke("chatglm3-6b").scaled(remat=False, dtype="float32")
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
    log(f"[2] small reference: chatglm3 smoke f32 prefill logits card vs cpu "
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
    vocab = get_config("chatglm3-6b").vocab_size
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


def serve_full(dev, prompt, out: dict):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("chatglm3-6b").scaled(remat=False, param_dtype="bfloat16")
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
    out["serve"] = res
    out["model"] = model
    log(f"[3b] chatglm3-6b full width+depth ({cfg.num_layers} layers, "
        f"{res['params'] / 1e9:.3f} B params in bf16), prompt {tuple(prompt.shape)}: "
        f"prefill {res['prefill_ms']:.2f} ms, decode {res['decode_ms_per_step']:.3f} "
        f"ms/step ({res['decode_tok_s']:.1f} tok/s over {DECODE_STEPS} steps x {b}), "
        f"end-to-end {res['e2e_tok_s']:.1f} tok/s; run() incl. init {total_s:.2f} s")
    log(f"[3b] first sequence: {toks[0, :12].tolist()}")


def full_width_logits(dev, model, prompt) -> None:
    """Logits of the full model are finite and the greedy prefill token agrees
    with a teacher-forced run of the same prompt."""
    with torch.inference_mode():
        logits, _ = model.prefill(prompt[:, :512], 512)
        full = model.logits_full(prompt[:, :512])
    check(bool(torch.isfinite(logits).all()), "full-width prefill logits finite")
    err = (logits.float() - full[:, -1].float()).abs().max().item()
    scale = full[:, -1].float().abs().max().item()
    check(err <= 1e-2 * max(1.0, scale), f"prefill vs logits_full err {err}")
    log(f"[3c] full-width logits finite; prefill vs logits_full last position "
        f"max_abs_err={err:.3g} (scale {scale:.3g})")


def device_profile(fn):
    """Run ``fn`` under torch.profiler; return (device busy share of the
    window spanned by its kernels, device busy ms, top kernels by device
    time in ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        return None, 0.0, []
    busy = sum(end - start for start, end, _ in spans)
    window = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    by_name: dict = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy / window, busy / 1e3,
            [(n[:60], round(us / 1e3, 3)) for n, us in top])


def profile_serving(model, prompt) -> None:
    """Warm prefill time, then device busy share and top kernels of one full
    prefill and of 8 decode steps (outside the timed main path)."""
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(prompt, prompt.shape[1] + 8)

    def decode():
        nxt = torch.argmax(state["logits"], dim=-1)[:, None]
        for i in range(8):
            logits, _ = model.decode_step(nxt, state["caches"], prompt.shape[1] + i)
            nxt = torch.argmax(logits, dim=-1)[:, None]

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        log(f"[3d] warm prefill {tuple(prompt.shape)}: "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms host clock")
        for name, fn in (("prefill", prefill), ("decode x8", decode)):
            share, busy_ms, top = device_profile(fn)
            if share is None:
                log(f"[3d] {name}: profiler recorded no device time (not measured)")
            else:
                log(f"[3d] {name}: device busy {busy_ms:.3f} ms, {share:.3f} of the "
                    f"kernel window (torch.profiler); top kernels (name, ms): {top}")


def kernel_rows(dev, out: dict, launches: dict):
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant import dequant
    from repro_torch.kernels.flash_attn import flash_attention

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
        replaces="src/repro/kernels/dequant.py:36", launches=launches["dequant"],
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
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attn_fwd.cu",
        replaces="src/repro/kernels/flash_attn.py:86",
        launches=launches["flash_attention"], max_abs_err=err,
        ms=time_ms(lambda: flash_attention(qa, ka, va), 10),
        plain_ms=time_ms(lambda: ref.attention_ref(qa, ka, va), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), 10)))
    shapes = {"dequant": f"q {[n, f]} int8 -> bf16",
              "flash_attention": f"B,T,H,KV,dh={[B, T, H, KV, DH]} bf16 causal, "
                                 f"tol rtol=atol=2e-2; SDPA vs plain max_abs_err "
                                 f"{lib_err:.3g}"}
    for r in rows:
        log(f"[4] {r['name']} {shapes[r['name']]}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3g}, launches on the main path {r['launches']}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant import dequant
    from repro_torch.kernels.flash_attn import flash_attention

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    reports = _build.build(["dequant", "flash_attn_fwd"])
    log(f"[1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   {name}: {line.strip()}")

    reference_small(dev)

    out: dict = {}
    torch.cuda.reset_peak_memory_stats()
    dequant.launches = 0
    flash_attention.launches = 0
    prompt = device_tier(dev, out)
    serve_full(dev, prompt, out)
    launches = {"dequant": dequant.launches,
                "flash_attention": flash_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = out["serve"]["layers"]
    log(f"[3] main path launches {launches}; peak device memory {peak_gb:.2f} GB")
    check(launches["dequant"] >= 1, "dequant kernel launched on the main path")
    check(launches["flash_attention"] == layers,
          f"flash kernel launched once per layer of the one prefill ({layers})")

    full_width_logits(dev, out["model"], prompt)
    profile_serving(out.pop("model"), prompt)
    del out["stores"]
    torch.cuda.empty_cache()
    rows = kernel_rows(dev, out, launches)
    log("[5] " + json.dumps({"serve": out["serve"], "peak_mem_gb": peak_gb,
                             "fetch_decode_ms": out["fetch_decode_ms"]}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

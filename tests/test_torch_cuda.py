"""CUDA kernels and the CUDA path of the port against their plain PyTorch
versions. These need a card and skip without one; this file imports no JAX,
so it runs on a machine that has only PyTorch:

  python -m pytest -q tests/test_torch_cuda.py

Tolerances: dequant is bit-exact (one f32 multiply and one round to nearest
even on both sides); f32 flash attention within 1e-5 (f32 FMAs against
cuBLAS f32 products, summed in another order); bf16 flash attention (wgmma
tensor cores) within 2e-2 (P rounded to bf16 before P.V on both sides, but
the kernel rounds the running-max-relative P and the plain version the
normalised one). With the attention flags: ``scale_in_q`` is the same
arithmetic on both sides, and so is ``probs_bf16`` where the row's keys are
one tile of the f32 path (64); past one tile the kernel rounds the exp's
argument to bf16 against its running max and the plain version against the
row's global max, so f32 outputs agree within the bf16 tolerance. The selective scan within rtol = atol = 1e-4 in both
dtypes: bf16 inputs are widened to f32 exactly on both sides before any
arithmetic, so only f32 rounding differs (2^x by ex2.approx, within ~2e-7
relative, with log2(e) folded into A, against exp; sums in another order). The models on the card in f32 match
their CPU runs within 1e-4 and greedy tokens match. The attention backward
kernel against ``attention_bwd_ref``: f32 within 1e-5 (FMAs summed in
another order, exp by expf), bf16 within 2e-2 (P and dS rounded to bf16 on
both sides before the tensor-core products, but the plain version takes S
from bf16-rounded scores and the kernel from f32 accumulators, and 2^x by
exp2f against exp); its LSE output within the forward's tolerance. A
smoke model's loss and every gradient on the card in f32 match the CPU's
within 1e-4. The selective scan's backward kernel against
``ssm_scan_bwd_ref``: every gradient within rtol 1e-4 in f32 and 1e-2 in
bf16 (the bf16 outputs are rounded once from f32 on both sides, so they
differ by one bf16 ulp, 2^-7 relative, at most), each with an atol of 1e-4
of the tensor's largest magnitude (f32 sums over the states, the channels
and the steps taken in another order, and 2^x by ex2.approx against exp).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import DeviceStore, DeviceStoreConfig, decode_records
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant import dequant as dequant_kernel
from repro_torch.kernels.flash_attn import flash_attention as flash_kernel
from repro_torch.kernels.flash_attn_bwd import flash_attention_bwd as flash_bwd_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
from repro_torch.kernels import ssm_scan_bwd as ssm_bwd_mod
from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd as ssm_bwd_kernel
from repro_torch.models import build_model
from repro_torch.serve.serve_step import generate

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,f,qblock", [(8, 256, 256), (33, 1024, 256),
                                        (32, 512, 128), (256, 150528, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.float16, torch.float32])
def test_dequant_kernel_bit_exact(cuda, n, f, qblock, out_dtype, scale_dtype):
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randint(-127, 128, (n, f), generator=gen, device=cuda,
                      dtype=torch.int8)
    s = (torch.rand((n, f // qblock), generator=gen, device=cuda) * 0.1
         ).to(scale_dtype)
    before = dequant_kernel.launches
    got = ops.dequant(q, s, qblock=qblock, out_dtype=out_dtype)
    assert dequant_kernel.launches == before + 1
    want = ref.dequant_ref(q, s, block=qblock, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


ATTN_SHAPES = [
    # b, t, h, kv, dh, dv, window
    (2, 128, 4, 2, 32, 32, None),
    (1, 256, 4, 4, 64, 64, 64),
    (1, 128, 2, 1, 32, 32, 32),         # tight window
    (1, 64, 4, 4, 128, 128, None),
    (2, 200, 32, 2, 128, 128, None),    # ragged T, chatglm3's group of 16
    (1, 300, 8, 2, 64, 64, 100),        # ragged T with a window
    (1, 1, 4, 2, 16, 16, None),         # one position
]
# bf16 runs on the tensor cores, which take dh == dv in {16, 32, 64, 128}
F32_ONLY_SHAPES = [(2, 128, 8, 2, 48, 24, None)]      # dv != dh
BF16_RING_SHAPES = [                    # across the wgmma kernel's 128-key ring
    (1, 1000, 8, 2, 128, 128, None),    # 8 tiles, ragged tail
    (1, 2053, 4, 2, 128, 128, None),    # 17 tiles, a 5-row last tile
    (1, 1500, 25, 5, 64, 64, 1024),     # hymba-1.5b: GQA group 5, window 1024
    (2, 700, 4, 2, 128, 128, 100),      # window not a multiple of the tile
]


@pytest.mark.parametrize("dtype,b,t,h,kv,dh,dv,win",
                         [(dt, *s) for dt in (torch.float32, torch.bfloat16)
                          for s in ATTN_SHAPES]
                         + [(torch.float32, *s) for s in F32_ONLY_SHAPES]
                         + [(torch.bfloat16, *s) for s in BF16_RING_SHAPES])
def test_flash_attention_kernel_vs_plain(cuda, b, t, h, kv, dh, dv, win, dtype):
    gen = torch.Generator(cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rnd(b, t, h, dh), rnd(b, t, kv, dh), rnd(b, t, kv, dv)
    before = flash_kernel.launches
    got = ops.attention(q, k, v, causal=True, window=win)
    assert flash_kernel.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, t, h, dv)
    want = ref.attention_ref(q, k, v, causal=True, window=win)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))


FLAG_SHAPES = [
    # b, t, h, kv, dh, window
    (1, 64, 4, 2, 32, None),            # one key tile of the f32 path
    (2, 200, 32, 2, 128, None),         # chatglm3-6b's heads, ragged T
    (1, 1500, 25, 5, 64, 1024),         # hymba-1.5b's heads and window
]


@pytest.mark.parametrize("flags", [dict(scale_in_q=True), dict(probs_bf16=True),
                                   dict(scale_in_q=True, probs_bf16=True)],
                         ids=lambda f: "+".join(f))
@pytest.mark.parametrize("b,t,h,kv,dh,win", FLAG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_flags_vs_plain(cuda, dtype, b, t, h, kv, dh,
                                               win, flags):
    gen = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn((b, t, n, dh), generator=gen, device=cuda).to(dtype)
               for n in (h, kv, kv))
    before = flash_kernel.launches
    got = ops.attention(q, k, v, window=win, **flags)
    assert flash_kernel.launches == before + 1
    want = ref.attention_ref(q, k, v, window=win, **flags)
    exact = dtype == torch.float32 and (t <= 64 or not flags.get("probs_bf16"))
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if exact else BF16))


@pytest.mark.parametrize("dtype,dh,t", [(torch.float32, 32, 100),
                                        (torch.bfloat16, 64, 100),
                                        (torch.bfloat16, 128, 1000)])
def test_flash_attention_kernel_non_causal(cuda, dtype, dh, t):
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn((1, t, 4, dh), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    got = ops.attention(q, k, v, causal=False)
    want = ref.attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))


def test_flash_attention_kernel_refuses_bad_input(cuda):
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    with pytest.raises(ValueError, match="Tq == Tk"):
        ops.attention(q, q[:, :4, :2], q[:, :4, :2])
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros((1, 8, 2, 192), device=cuda)
        ops.attention(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        ops.attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bf16 head dims"):
        x = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
        ops.attention(x, x, x[..., :24].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(8 * 4 * 16 + 1, device=cuda, dtype=torch.bfloat16)
        x = flat[1:].view(1, 8, 4, 16)          # contiguous, 2 bytes off
        ops.attention(x, x, x)
    # TMA: k alone 8 bytes off its 16-byte alignment, at the path's dh
    q = torch.zeros((1, 8, 4, 128), device=cuda, dtype=torch.bfloat16)
    flat = torch.zeros(8 * 2 * 128 + 8, device=cuda, dtype=torch.bfloat16)
    before = flash_kernel.launches
    with pytest.raises(ValueError, match="16-byte aligned base addresses"):
        k = flat[4:-4].view(1, 8, 2, 128)
        ops.attention(q, k, k)
    assert flash_kernel.launches == before
    k = flat[8:].view(1, 8, 2, 128)             # 16 bytes off: aligned
    assert ops.attention(q, k, k).shape == q.shape


SSM = dict(rtol=1e-4, atol=1e-4)
SSM_SHAPES = [
    # b, t, d, s
    (2, 64, 64, 16),
    (1, 100, 200, 8),       # ragged T (not a multiple of 32) and D (of 64)
    (2, 33, 3200, 16),      # hymba's d_inner, which no 512-wide tile divides
    (1, 1, 8, 16),          # one step
    (3, 70, 96, 5),         # S below 16: the states past S stay 0
    (1, 2053, 200, 16),     # T past a whole number of 16-step chunks
    (2, 37, 3200, 5),       # hymba's d_inner; T below one chunk
    (1, 70, 8200, 1),       # D past a whole number of 128-channel blocks
    (2, 50, 77, 16),        # D not a multiple of 8: element-wise staging
]


def _ssm_args(dev, b, t, d, s, dtype, param_dtype, seed=0, dt_max=None):
    gen = torch.Generator(dev).manual_seed(seed)
    u = torch.randn((b, t, d), generator=gen, device=dev)
    dt = torch.exp(torch.rand((b, t, d), generator=gen, device=dev) * 4.6 - 6.9)
    if dt_max is not None:                  # dt uniform in [0, dt_max)
        dt = torch.rand((b, t, d), generator=gen, device=dev) * dt_max
    b_in, c_in = (torch.randn((b, t, s), generator=gen, device=dev)
                  for _ in range(2))
    a_log = torch.log(torch.arange(1, s + 1, device=dev, dtype=torch.float32)
                      ).expand(d, s) + 0.1 * torch.randn((d, s), generator=gen,
                                                          device=dev)
    d_skip = torch.randn((d,), generator=gen, device=dev)
    return ([x.to(dtype) for x in (u, dt, b_in, c_in)]
            + [x.to(param_dtype) for x in (a_log, d_skip)])


@pytest.mark.parametrize("b,t,d,s", SSM_SHAPES)
@pytest.mark.parametrize("dtype,param_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_ssm_scan_kernel_vs_plain(cuda, b, t, d, s, dtype, param_dtype):
    args = _ssm_args(cuda, b, t, d, s, dtype, param_dtype)
    before = ssm_kernel.launches
    y, h = ops.ssm_scan(*args)
    assert ssm_kernel.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (b, t, d) and tuple(h.shape) == (b, d, s)
    wy, wh = ref.ssm_scan_ref(*args)
    torch.testing.assert_close(y, wy, **SSM)
    torch.testing.assert_close(h, wh, **SSM)


@pytest.mark.parametrize("b,t,d,s", [(2, 300, 200, 16), (1, 100, 77, 5)])
@pytest.mark.parametrize("dtype,param_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_ssm_scan_kernel_exp_underflow(cuda, b, t, d, s, dtype, param_dtype):
    # dt up to 10 puts dt * A * log2(e) below -126 for most states, where
    # ex2.approx.ftz must give 0 as exp does; state 0 (A = -200) crosses
    # -127 for dt above ~0.44, the others at their own dt
    args = _ssm_args(cuda, b, t, d, s, dtype, param_dtype, dt_max=10.0)
    args[4][:, 0] = math.log(200.0)
    y, h = ops.ssm_scan(*args)
    wy, wh = ref.ssm_scan_ref(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, wy, **SSM)
    torch.testing.assert_close(h, wh, **SSM)


def test_ssm_scan_kernel_refuses_bad_input(cuda):
    args = _ssm_args(cuda, 1, 8, 16, 16, torch.bfloat16, torch.float32)
    u, dt, b_in, c_in, a_log, d_skip = args
    before = ssm_kernel.launches
    with pytest.raises(ValueError, match="dtype"):
        ops.ssm_scan(u.float(), dt, b_in, c_in, a_log, d_skip)
    with pytest.raises(ValueError, match="shapes"):
        ops.ssm_scan(u, dt, b_in, c_in, a_log[:8].contiguous(), d_skip)
    with pytest.raises(ValueError, match="S must be"):
        wide = torch.zeros((1, 8, 17), device=cuda, dtype=torch.bfloat16)
        ops.ssm_scan(u, dt, wide, wide, torch.zeros((16, 17), device=cuda),
                     d_skip)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssm_scan(u, dt.transpose(1, 2).contiguous().transpose(1, 2)[:, :8],
                     b_in, c_in, a_log, d_skip)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(8 * 16 + 1, device=cuda, dtype=torch.bfloat16)
        ops.ssm_scan(flat[1:].view(1, 8, 16), dt, b_in, c_in, a_log, d_skip)
    assert ssm_kernel.launches == before


SSM_BWD_SHAPES = [
    # b, t, d, s
    (2, 64, 64, 16),
    (1, 100, 200, 5),       # ragged T (not a multiple of 16) and D (of 64); S < 16
    (2, 33, 3200, 16),      # hymba's d_inner
    (1, 1, 8, 16),          # one step
    (1, 517, 70, 1),        # many chunks, S = 1
    (2, 50, 77, 16),        # D not a multiple of 8
    (2, 40, 96, 3),         # S not a multiple of the 4 states a lane holds
    (1, 70, 130, 7),        # likewise, with a ragged D
    (1, 20, 8192, 16),      # falcon-mamba-7b's D at a short T
    (2, 45, 64, 16),        # a ragged T over three chunks
]


def _ck(args):
    """K3's checkpoints of h for ``args``, as it writes them under grad."""
    return ssm_kernel(*args, checkpoints=True)[2]


def _close_bwd(got, want, dtype):
    names = ("du", "ddt", "dB", "dC", "da_log", "dD")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = max(1.0, w.float().abs().max().item())
        rtol = 1e-4 if g.dtype == torch.float32 else 1e-2
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=1e-4 * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("b,t,d,s", SSM_BWD_SHAPES)
@pytest.mark.parametrize("dtype,param_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("seed_h", [False, True], ids=["dh0", "dh"])
def test_ssm_scan_bwd_kernel_vs_plain(cuda, b, t, d, s, dtype, param_dtype, seed_h):
    args = _ssm_args(cuda, b, t, d, s, dtype, param_dtype)
    gen = torch.Generator(cuda).manual_seed(1)
    dy = torch.randn((b, t, d), generator=gen, device=cuda)
    dh = torch.randn((b, d, s), generator=gen, device=cuda) if seed_h else None
    ck = _ck(args)
    before = ssm_bwd_kernel.launches
    got = ssm_bwd_kernel(*args, dy, dh, h_checkpoints=ck)
    assert ssm_bwd_kernel.launches == before + 1
    _close_bwd(got, ref.ssm_scan_bwd_ref(*args, dy, dh), dtype)
    again = ssm_bwd_kernel(*args, dy, dh, h_checkpoints=ck)
    assert all(torch.equal(x, y) for x, y in zip(got, again))     # the same bits


@pytest.mark.parametrize("b,t,d,s", [(2, 300, 200, 16), (1, 100, 77, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_bwd_kernel_exp_underflow(cuda, b, t, d, s, dtype):
    # trained-like dt (up to 10): ā = exp(dt a) underflows to 0 for most
    # states, where the recurrence cannot be inverted
    args = _ssm_args(cuda, b, t, d, s, dtype, torch.float32, dt_max=10.0)
    args[4][:, 0] = math.log(200.0)
    gen = torch.Generator(cuda).manual_seed(2)
    dy = torch.randn((b, t, d), generator=gen, device=cuda)
    dh = torch.randn((b, d, s), generator=gen, device=cuda)
    got = ssm_bwd_kernel(*args, dy, dh, h_checkpoints=_ck(args))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _close_bwd(got, ref.ssm_scan_bwd_ref(*args, dy, dh), dtype)


def test_ssm_scan_bwd_kernel_refuses_bad_input(cuda):
    args = _ssm_args(cuda, 1, 8, 16, 16, torch.bfloat16, torch.float32)
    dy = torch.zeros((1, 8, 16), device=cuda)
    ck = dict(h_checkpoints=_ck(args))
    before = ssm_bwd_kernel.launches
    with pytest.raises(ValueError, match="dtype"):
        ssm_bwd_kernel(*args, dy.to(torch.bfloat16), **ck)
    with pytest.raises(ValueError, match="dtype"):
        ssm_bwd_kernel(args[0].float(), *args[1:], dy, **ck)
    with pytest.raises(ValueError, match="dtype"):
        ssm_bwd_kernel(*args, dy, h_checkpoints=ck["h_checkpoints"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        ssm_bwd_kernel(*args, dy[:, :4].contiguous(), **ck)
    with pytest.raises(ValueError, match="shapes"):
        ssm_bwd_kernel(*args, dy, torch.zeros((1, 16, 8), device=cuda), **ck)
    with pytest.raises(ValueError, match="S must be"):
        wide = torch.zeros((1, 8, 17), device=cuda, dtype=torch.bfloat16)
        ssm_bwd_kernel(*args[:2], wide, wide, torch.zeros((16, 17), device=cuda),
                       args[5], dy, **ck)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_bwd_kernel(*args, dy.transpose(1, 2).contiguous().transpose(1, 2), **ck)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(8 * 16 + 1, device=cuda)
        ssm_bwd_kernel(*args, flat[1:].view(1, 8, 16), **ck)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_bwd_kernel(*args, dy.cpu(), **ck)
    with pytest.raises(TypeError, match="h_checkpoints"):
        ssm_bwd_kernel(*args, dy)
    assert ssm_bwd_kernel.launches == before


@pytest.mark.parametrize("b,t,d,s", SSM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_bwd_from_forward_checkpoints(cuda, b, t, d, s, dtype):
    # K3's checkpoints of h (under grad) are h after every 8th step, and K3
    # with them gives y, h_final as without them (K3b from them is held to
    # the plain backward above); K3b refuses checkpoints of another shape
    args = _ssm_args(cuda, b, t, d, s, dtype, torch.float32)
    gen = torch.Generator(cuda).manual_seed(4)
    dy = torch.randn((b, t, d), generator=gen, device=cuda)
    dh = torch.randn((b, d, s), generator=gen, device=cuda)
    y, h, ck = ssm_kernel(*args, checkpoints=True)
    assert ck.shape == ((t - 1) // 8, b, d, 16)
    assert all(torch.equal(x, z) for x, z in zip((y, h), ssm_kernel(*args)))
    want = None
    for m in range(ck.shape[0]):            # h after step 8 m + 7, zero past S
        _, want = ref.ssm_scan_ref(*[x[:, 8 * m:8 * m + 8] if i < 4 else x
                                     for i, x in enumerate(args)], h0=want)
        torch.testing.assert_close(ck[m, ..., :s], want, rtol=1e-4, atol=1e-4)
        assert not ck[m, ..., s:].any()
    with pytest.raises(ValueError, match="shapes"):
        ssm_bwd_kernel(*args, dy, dh, h_checkpoints=torch.zeros(
            (ck.shape[0] + 1,) + ck.shape[1:], device=cuda))


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("vec", [True, False], ids=["vec", "elementwise"])
def test_ssm_scan_bwd_blocks_per_sm_as_planned(cuda, bf16, vec):
    # the waves the launch plan gives (PERF.md) assume this many blocks an SM
    assert ssm_bwd_mod.blocks_per_sm(bf16, vec) == ssm_bwd_mod.BLOCKS_PER_SM


def test_ssm_scan_bwd_kernel_refuses_another_plan(cuda, monkeypatch):
    args = _ssm_args(cuda, 1, 8, 16, 16, torch.bfloat16, torch.float32)
    dy = torch.zeros((1, 8, 16), device=cuda)
    right = ssm_bwd_mod.plan(1, 8, 16, 16)
    before = ssm_bwd_kernel.launches
    for wrong in (dict(grid=(right.grid[0] + 1, 1)), dict(threads=right.threads // 2),
                  dict(smem_bytes=right.smem_bytes - 16)):
        monkeypatch.setattr(ssm_bwd_mod, "plan", lambda *a, w=wrong: right.__class__(
            **{**right.__dict__, **w}))
        with pytest.raises(RuntimeError, match="cudaError"):
            ssm_bwd_kernel(*args, dy, h_checkpoints=_ck(args))
    assert ssm_bwd_kernel.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_autograd_on_card_matches_cpu(cuda, dtype):
    args = _ssm_args(cuda, 2, 70, 96, 16, dtype, torch.float32)
    gen = torch.Generator(cuda).manual_seed(3)
    dy = torch.randn((2, 70, 96), generator=gen, device=cuda)
    dh = torch.randn((2, 96, 16), generator=gen, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [x.detach().to(dev).requires_grad_() for x in args]
        before = (ssm_kernel.launches, ssm_bwd_kernel.launches)
        y, h = ops.ssm_scan(*xs)
        ((y * dy.to(dev)).sum() + (h * dh.to(dev)).sum()).backward()
        if dev.type == "cuda":       # K3 forward and K3b backward, once each
            assert (ssm_kernel.launches - before[0],
                    ssm_bwd_kernel.launches - before[1]) == (1, 1)
        grads.append([x.grad.cpu() for x in xs])
    _close_bwd(*grads, dtype)


def test_kernels_skip_empty_inputs(cuda):
    before = (dequant_kernel.launches, flash_kernel.launches, ssm_kernel.launches)
    got = ops.dequant(torch.zeros((0, 256), dtype=torch.int8, device=cuda),
                      torch.zeros((0, 1), dtype=torch.float16, device=cuda))
    assert tuple(got.shape) == (0, 256)
    x = torch.zeros((2, 0, 4, 16), dtype=torch.bfloat16, device=cuda)
    assert tuple(ops.attention(x, x, x).shape) == (2, 0, 4, 16)
    args = _ssm_args(cuda, 2, 0, 32, 16, torch.bfloat16, torch.bfloat16)
    y, h = ops.ssm_scan(*args)
    assert tuple(y.shape) == (2, 0, 32) and torch.equal(h, torch.zeros_like(h))
    assert (dequant_kernel.launches, flash_kernel.launches,
            ssm_kernel.launches) == before


def test_device_tier_on_card_matches_cpu(cuda):
    n, f = 64, 1024
    gen = torch.Generator().manual_seed(0)
    recs = torch.randint(0, 256, (n, f + 2 * (f // 256)), generator=gen,
                         dtype=torch.uint8)
    recs[:, f:] = (torch.rand((n, f // 256), generator=gen) + 0.5
                   ).half().view(torch.uint8)
    idx = torch.randperm(n, generator=gen)[:16]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        st = DeviceStore(DeviceStoreConfig(n, recs.shape[1], 0.5), device=dev)
        b, o = st.fetch(st.place(recs), idx.to(dev))
        out[dev.type] = (b.cpu(), o.cpu(), decode_records(b, f).cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert out["cuda"][1].item()                    # cap 8 < 16 requests


PREFILL_KERNELS = {"dense": (flash_kernel,), "ssm": (ssm_kernel,),
                   "hybrid": (flash_kernel, ssm_kernel)}


@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b", "hymba-1.5b"])
def test_model_on_card_matches_cpu(cuda, arch):
    cfg = get_smoke(arch).scaled(remat=False, dtype="float32")
    kernels = PREFILL_KERNELS[cfg.family]
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    before = [k.launches for k in kernels]
    lc, _ = card.prefill(toks.to(cuda), 110)
    assert [k.launches for k in kernels] == [n + cfg.num_layers for n in before]
    lp, _ = cpu.prefill(toks, 110)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-4, atol=1e-4)
    assert torch.equal(generate(card, toks, steps=6).cpu(),
                       generate(cpu, toks, steps=6))


BWD_SHAPES = [
    # b, t, h, kv, dh, window, causal
    (1, 64, 4, 4, 16, None, True),      # GQA group 1
    (2, 80, 4, 2, 32, 24, True),        # group 2, ragged T, window
    (1, 300, 10, 2, 64, 100, True),     # group 5, window
    (1, 200, 32, 2, 128, None, True),   # chatglm3-6b's heads: group 16, ragged T
    (1, 1500, 25, 5, 64, 1024, True),   # hymba-1.5b: group 5, window 1024
    (2, 129, 16, 1, 128, 50, True),     # group 16, a 1-row last tile
    (1, 100, 4, 2, 32, None, False),    # not causal
    (1, 100, 4, 2, 32, 30, False),      # not causal, window
    (1, 2048, 32, 2, 128, None, True),  # chatglm3-6b's heads at full T: the longest dQ chains
    (2, 333, 8, 2, 64, 40, True),       # ragged T, a window shorter than one key item
    (2, 37, 8, 2, 128, None, True),     # T under one item
    (4, 2048, 8, 4, 64, None, True),    # B=4: many more items than SMs
]


@pytest.mark.parametrize("b,t,h,kv,dh,win,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_vs_plain(cuda, dtype, b, t, h, kv, dh, win, causal):
    gen = torch.Generator(cuda).manual_seed(3)
    q, k, v, do = (torch.randn((b, t, n, dh), generator=gen, device=cuda).to(dtype)
                   for n in (h, kv, kv, h))
    o, lse = flash_kernel(q, k, v, causal=causal, window=win, return_lse=True)
    o_ref, lse_ref = ref.attention_ref(q, k, v, causal=causal, window=win,
                                       return_lse=True)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(lse, lse_ref, **tol)
    torch.testing.assert_close(o.float(), o_ref.float(), **tol)
    before = flash_bwd_kernel.launches
    got = flash_bwd_kernel(q, k, v, o, lse, do, causal=causal, window=win)
    assert flash_bwd_kernel.launches == before + 1
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=win)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)
    again = flash_bwd_kernel(q, k, v, o, lse, do, causal=causal, window=win)
    assert all(torch.equal(x, y) for x, y in zip(got, again))      # no atomics


def test_flash_attention_bwd_kernel_f32_dv_ne_dh(cuda):
    gen = torch.Generator(cuda).manual_seed(4)
    q, k = (torch.randn((2, 90, n, 48), generator=gen, device=cuda) for n in (8, 2))
    v = torch.randn((2, 90, 2, 24), generator=gen, device=cuda)
    o, lse = flash_kernel(q, k, v, return_lse=True)
    do = torch.randn_like(o)
    got = flash_bwd_kernel(q, k, v, o, lse, do)
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, w, **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_on_card_matches_cpu(cuda, dtype):
    gen = torch.Generator().manual_seed(5)
    x = [torch.randn((2, 150, n, 64), generator=gen).to(dtype) for n in (8, 2, 2, 8)]
    grads = {}
    before = (flash_kernel.launches, flash_bwd_kernel.launches)
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (t.to(dev).requires_grad_() for t in x[:3])
        ops.attention(q, k, v, window=40).backward(x[3].to(dev))
        grads[dev.type] = [t.grad.cpu().float() for t in (q, k, v)]
    assert (flash_kernel.launches, flash_bwd_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    for g, w in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g, w, **(F32 if dtype == torch.float32 else BF16))


def test_flash_attention_bwd_kernel_refuses_bad_input(cuda):
    x = torch.zeros((1, 8, 2, 16), device=cuda)
    lse = torch.zeros((1, 2, 8), device=cuda)
    before = flash_bwd_kernel.launches
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_kernel(x, x, x, x, lse[:, :1], x)
    with pytest.raises(ValueError, match="dtype"):
        flash_bwd_kernel(x, x, x, x, lse.half(), x)
    with pytest.raises(ValueError, match="bf16 head dims"):
        y = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
        flash_bwd_kernel(y, y, y, y, lse, y)
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd_kernel(x, x, x, x, lse, x.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="no gradient"):
        flash_kernel(x.clone().requires_grad_(), x, x)
    with pytest.raises(ValueError, match="attention flags"):
        flash_kernel(x, x, x, probs_bf16=True, return_lse=True)
    assert flash_bwd_kernel.launches == before


def test_serving_saves_nothing_and_launches_no_backward(cuda):
    cfg = get_smoke("chatglm3-6b").scaled(remat=False)
    model = build_model(cfg, device=cuda).init(torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda, dtype=torch.int32)
    before = (flash_kernel.launches, flash_bwd_kernel.launches)
    out = generate(model, toks, steps=4)
    assert out.grad_fn is None
    assert flash_kernel.launches == before[0] + cfg.num_layers
    assert flash_bwd_kernel.launches == before[1]
    q, k = (torch.randn((1, 64, n, 32), device=cuda, dtype=torch.bfloat16,
                        requires_grad=True) for n in (4, 2))
    with torch.inference_mode():
        assert ops.attention(q, k, k).grad_fn is None


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_and_hybrid_loss_on_card_matches_cpu(cuda, arch):
    cfg = get_smoke(arch).scaled(dtype="float32", loss_chunk=64)
    assert cfg.remat
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    before = (ssm_kernel.launches, ssm_bwd_kernel.launches)
    lc, _ = card.loss(toks.to(cuda))
    lc.backward()
    # the forward, its recompute under remat, and one backward per layer
    assert (ssm_kernel.launches - before[0], ssm_bwd_kernel.launches - before[1]) \
        == (2 * cfg.num_layers, cfg.num_layers)
    lp, _ = cpu.loss(toks)
    lp.backward()
    torch.testing.assert_close(lc.detach().cpu(), lp.detach(), rtol=1e-4, atol=1e-4)
    want = dict(cpu.named_parameters())
    for n, p in card.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), want[n].grad, rtol=1e-4, atol=1e-4,
                                   msg=n)


def test_ssm_serving_launches_no_backward(cuda):
    cfg = get_smoke("hymba-1.5b").scaled(remat=False)
    model = build_model(cfg, device=cuda).init(torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda, dtype=torch.int32)
    before = (ssm_kernel.launches, ssm_bwd_kernel.launches)
    out = generate(model, toks, steps=4)
    assert out.grad_fn is None
    assert ssm_kernel.launches == before[0] + cfg.num_layers
    assert ssm_bwd_kernel.launches == before[1]


def test_model_loss_on_card_matches_cpu(cuda):
    cfg = get_smoke("chatglm3-6b").scaled(dtype="float32", loss_chunk=64)
    assert cfg.remat
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    before = (flash_kernel.launches, flash_bwd_kernel.launches)
    lc, _ = card.loss(toks.to(cuda))
    lc.backward()
    # the forward, its recompute under remat, and one backward per layer
    assert (flash_kernel.launches - before[0], flash_bwd_kernel.launches - before[1]) \
        == (2 * cfg.num_layers, cfg.num_layers)
    lp, _ = cpu.loss(toks)
    lp.backward()
    torch.testing.assert_close(lc.detach().cpu(), lp.detach(), rtol=1e-4, atol=1e-4)
    want = dict(cpu.named_parameters())
    for n, p in card.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), want[n].grad, rtol=1e-4, atol=1e-4,
                                   msg=n)

"""Kernels of the port: the plain versions against the JAX reference (plain
jnp and the Pallas kernels in interpret mode) on the CPU. The CUDA kernels
against these plain versions are in ``test_torch_cuda.py``.

Tolerances: dequant is exact (one f32 multiply, one round to nearest even on
both sides); f32 attention agrees within 1e-5 (same math, sums in another
order); bf16 attention within 2e-2 (bf16 inputs rounded alike, products
summed in another order). With ``probs_bf16`` the plain version takes the
row's global max, which is ``flash_attention_lax``'s running max when all
keys are one key block, so those cases run the reference with one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codec import block_dequantize_host as jax_host_dequant
from repro.core.codec import block_quantize as jax_block_quantize
from repro.kernels import ops as jax_ops
from repro.kernels.dequant import dequant as pallas_dequant
from repro.kernels import ref as jax_ref
from repro.models.layers import flash_attention_lax
from repro_torch.core.codec import block_dequantize_host, block_quantize
from repro_torch.kernels import ops, ref

F32 = dict(rtol=1e-5, atol=1e-5)


def _bits(a) -> np.ndarray:
    """bf16 array (JAX or torch) -> its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# ---------------------------------------------------------------------------
# dequant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,f,qblock,bn,bf", [
    (8, 256, 256, 8, 256),
    (64, 1024, 256, 32, 512),
    (32, 512, 128, 16, 256),
    (128, 2048, 256, 128, 2048),
])
def test_dequant_plain_vs_reference(rng, n, f, qblock, bn, bf):
    x = rng.standard_normal((n, f)).astype(np.float32) * 3
    q, s = block_quantize(x, block=qblock)
    jq, js = jax_block_quantize(x, block=qblock)
    np.testing.assert_array_equal(q, jq)          # the codec copy is exact
    np.testing.assert_array_equal(s, js)
    tq, ts = torch.from_numpy(q), torch.from_numpy(s)
    got = ops.dequant(tq, ts, qblock=qblock, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), jax_host_dequant(q, s, block=qblock))
    np.testing.assert_array_equal(got.numpy(), block_dequantize_host(q, s, block=qblock))
    pallas = pallas_dequant(jnp.asarray(q), jnp.asarray(s), block_n=bn,
                            block_f=bf, qblock=qblock, out_dtype=jnp.float32,
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("scale_dtype", [np.float16, np.float32])
def test_dequant_bf16_bit_exact_vs_reference(rng, scale_dtype):
    x = rng.standard_normal((16, 512)).astype(np.float32)
    q, s = block_quantize(x)
    s = s.astype(scale_dtype)
    got = ops.dequant(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    want = jax_ref.dequant_ref(jnp.asarray(q), jnp.asarray(s))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pallas = jax_ops.dequant(jnp.asarray(q), jnp.asarray(s), impl="interpret")
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_SHAPES = [
    # b, t, h, kv, dh, dv, window, pallas block
    (2, 128, 4, 2, 32, 32, None, 64),
    (1, 256, 4, 4, 64, 64, 64, 64),
    (2, 128, 8, 2, 48, 24, None, 64),     # MLA-style dv != dh
    (1, 128, 2, 1, 32, 32, 32, 32),       # tight window
    (1, 64, 4, 4, 128, 128, None, 64),
    (1, 64, 32, 2, 16, 16, None, 64),     # chatglm3's group of 16
]


def _qkv(rng, b, t, h, kv, dh, dv, tk=None):
    tk = tk or t
    return (rng.standard_normal((b, t, h, dh)).astype(np.float32),
            rng.standard_normal((b, tk, kv, dh)).astype(np.float32),
            rng.standard_normal((b, tk, kv, dv)).astype(np.float32))


@pytest.mark.parametrize("b,t,h,kv,dh,dv,win,blk", ATTN_SHAPES)
def test_attention_plain_vs_reference_and_pallas(rng, b, t, h, kv, dh, dv, win, blk):
    q, k, v = _qkv(rng, b, t, h, kv, dh, dv)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=win).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.attention_ref(jq, jk, jv, window=win)), **F32)
    pallas = jax_ops.attention(jq, jk, jv, window=win, impl="interpret",
                               block_q=blk, block_k=blk)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)


FLAG_SETS = [dict(), dict(scale_in_q=True), dict(probs_bf16=True),
             dict(scale_in_q=True, probs_bf16=True)]


def _lax(q, k, v, *, window=None, **flags):
    """flash_attention_lax on numpy or bf16 inputs; a single key block
    when ``probs_bf16`` is set (see the module docstring)."""
    block_k = q.shape[1] if flags.get("probs_bf16") else 32
    return flash_attention_lax(q, k, v, causal=True, window=window,
                               block_q=32, block_k=block_k, **flags)


@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=lambda f: "+".join(f) or "plain")
@pytest.mark.parametrize("win", [None, 40])
def test_attention_plain_vs_flash_attention_lax(rng, win, flags):
    q, k, v = _qkv(rng, 2, 96, 4, 2, 32, 32)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), window=win,
                            **flags)
    want = _lax(*map(jnp.asarray, (q, k, v)), window=win, **flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("flag", ["scale_in_q", "probs_bf16"])
def test_attention_flag_takes_effect(rng, flag):
    # probs_bf16 moves f32 outputs by ~1e-3; scale_in_q only rounds q * scale
    # to q's dtype, which shows in bf16 (dh 32: the scale is no power of 2)
    q, k, v = _qkv(rng, 2, 96, 4, 2, 32, 32)
    if flag == "scale_in_q":
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    else:
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ref.attention_ref(tq, tk, tv, **{flag: True}).float().numpy()
    with_flag = np.asarray(_lax(jq, jk, jv, **{flag: True}), np.float32)
    without = np.asarray(_lax(jq, jk, jv), np.float32)
    tol = F32 if flag == "probs_bf16" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, with_flag, **tol)
    assert np.abs(got - with_flag).mean() < np.abs(got - without).mean()


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_tq_ne_tk_end_aligned(rng, causal):
    q, k, v = _qkv(rng, 1, 8, 4, 2, 16, 16, tk=24)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=12)
    want = jax_ref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_attention_plain_bf16_vs_reference(rng):
    q, k, v = _qkv(rng, 1, 128, 4, 2, 32, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = ops.attention(tq, tk, tv).float().numpy()
    want = np.asarray(jax_ref.attention_ref(jq, jk, jv), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)

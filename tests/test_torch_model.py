"""Dense, ssm and hybrid LMs: the PyTorch port against the JAX reference from
identical weights.

For each ported smoke config (float32 activations), the JAX ``Model.init``
pytree is converted with ``params_from_jax`` and both packages run the same
numpy tokens. Logits and caches must agree within 1e-4 (f32, sums taken in
another order); greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import build_model as jax_build_model
from repro.serve.serve_step import generate as jax_generate
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.serve_step import generate

TOL = dict(rtol=1e-4, atol=1e-4)
B, T, DECODE = 2, 12, 8

CASES = {arch: {} for arch in ARCH_IDS}
# a sliding-window layer exercises the ring cache; with a window of 8 it
# wraps during prefill and again during the 8 decode steps
CASES["chatglm3-6b/swa"] = dict(window=8, global_layers=(0,))
CASES["hymba-1.5b/swa"] = dict(window=8, global_layers=(0, 3))
# both attention flags (the JAX dry-run's setting); T <= 512 is one key
# block of flash_attention_lax, where the plain version's arithmetic is its
FLAGS = dict(attn_scale_in_q=True, attn_probs_bf16=True)
CASES["chatglm3-6b/flags"] = FLAGS
CASES["hymba-1.5b/flags"] = FLAGS
CACHE_KEYS = {"ssm": {"h", "conv"}, "hybrid": {"k", "v", "h", "conv"}}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    name = request.param
    arch = name.split("/")[0]
    over = dict(remat=False, dtype="float32", **CASES[name])
    jcfg = jax_get_smoke(arch).scaled(**over)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    cfg = get_smoke(arch).scaled(**over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T + DECODE)).astype(np.int32)
    return jmodel, params, model, toks


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _segment_caches(jcaches, jmodel):
    """JAX caches (per segment, stacked on a layer axis) -> per-layer list."""
    out = []
    for seg, c in zip(jmodel.segments, jcaches):
        for i in range(seg.n_layers):
            out.append({key: np.asarray(v[i]) for key, v in c.items()})
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke(arch)) == \
        dataclasses.asdict(jax_get_smoke(arch))


def test_logits_full(pair):
    jmodel, params, model, toks = pair
    want = jax.jit(jmodel.logits_full)(params, {"tokens": jnp.asarray(toks)})
    got = model.logits_full(torch.from_numpy(toks))
    _close(got, want)


def test_prefill_logits_and_caches(pair):
    jmodel, params, model, toks = pair
    max_len = T + DECODE
    jl, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len))(
        params, {"tokens": jnp.asarray(toks[:, :T])})
    tl, tc = model.prefill(torch.from_numpy(toks[:, :T]), max_len)
    _close(tl, jl)
    jc = _segment_caches(jc, jmodel)
    assert len(tc) == len(jc)
    keys = CACHE_KEYS.get(model.cfg.family, {"k", "v"})
    for a, b in zip(tc, jc):
        assert set(a) == set(b) == keys
        for key in a:
            assert tuple(a[key].shape) == b[key].shape
            _close(a[key], b[key])


def test_decode_steps(pair):
    jmodel, params, model, toks = pair
    max_len = T + DECODE
    _, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len))(
        params, {"tokens": jnp.asarray(toks[:, :T])})
    _, tc = model.prefill(torch.from_numpy(toks[:, :T]), max_len)
    dec = jax.jit(jmodel.decode_step)
    for s in range(DECODE):
        nt = toks[:, T + s:T + s + 1]
        jl, jc = dec(params, jnp.asarray(nt), jc, jnp.int32(T + s))
        tl, tc = model.decode_step(torch.from_numpy(nt), tc, T + s)
        _close(tl, jl)
    for a, b in zip(tc, _segment_caches(jc, jmodel)):
        for key in a:
            _close(a[key], b[key])


def test_generate_tokens_identical(pair):
    jmodel, params, model, toks = pair
    want = jax_generate(jmodel, params, {"tokens": jnp.asarray(toks[:, :T])},
                        steps=6)
    got = generate(model, torch.from_numpy(toks[:, :T]), steps=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ATTN_FLAGS = ["attn_scale_in_q", "attn_probs_bf16"]


@pytest.mark.parametrize("flag", ATTN_FLAGS)
def test_ssm_model_ignores_attention_flag(flag):
    # the reference's ssm model reads neither flag, so neither changes it
    cfg = get_smoke("falcon-mamba-7b").scaled(remat=False, dtype="float32")
    plain = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    flagged = build_model(cfg.scaled(**{flag: True}), device="cpu")
    flagged.load_state_dict(plain.state_dict())
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    assert torch.equal(flagged.logits_full(toks), plain.logits_full(toks))

"""Device tier of the port (one card, D = 1) against the JAX DeviceStore on a
one-device mesh: place / fetch / tokens_from_payload, capacity overflow with
zero rows for dropped slots, and the fetch -> dequant pipeline. Fetch moves
bytes, so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DeviceStore as JaxDeviceStore
from repro.core import DeviceStoreConfig as JaxDeviceStoreConfig
from repro.core import tokens_from_payload as jax_tokens_from_payload
from repro.core.codec import block_dequantize_host as jax_host_dequant
from repro_torch.core import (DeviceStore, DeviceStoreConfig, block_quantize,
                              decode_records, tokens_from_payload)
from repro_torch.core.fetch import required_capacity

S, L = 64, 8


def _jax_fetch(records, idx, cf):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    st = JaxDeviceStore(mesh, JaxDeviceStoreConfig(
        num_samples=records.shape[0], sample_bytes=records.shape[1],
        capacity_factor=cf))
    with mesh:
        arr = st.place(records)
        b, o = jax.jit(st.fetch)(arr, jax.device_put(idx, st.idx_sharding))
    return np.asarray(b), np.asarray(o)


def _store(cf, num_samples=S, sample_bytes=L * 4):
    return DeviceStore(DeviceStoreConfig(num_samples=num_samples,
                                         sample_bytes=sample_bytes,
                                         capacity_factor=cf), device="cpu")


def _tokens():
    return np.arange(S * L, dtype=np.int32).reshape(S, L)


@pytest.mark.parametrize("cf", [1.0, 2.0, 4.0])
def test_fetch_tokens_matches_reference(cf):
    tokens = _tokens()
    idx = np.random.default_rng(0).permutation(S)[:16].astype(np.int32)
    st = _store(cf)
    arr = st.place_tokens(tokens)
    assert arr.dtype == torch.uint8 and tuple(arr.shape) == (S, L * 4)
    b, o = st.fetch(arr, torch.from_numpy(idx))
    jb, jo = _jax_fetch(tokens.view(np.uint8).reshape(S, -1), idx, cf)
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(o.numpy(), jo)
    assert not o.item()
    got = tokens_from_payload(b, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tokens[idx])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_tokens_from_payload(jnp.asarray(jb), L)))


@pytest.mark.parametrize("cf,skew", [(0.5, False), (0.5, True), (2.0, True)])
def test_overflow_drops_to_zero_rows_like_reference(cf, skew):
    tokens = _tokens()
    g = 8
    idx = (np.zeros(g) if skew else
           np.random.default_rng(1).permutation(S)[:g]).astype(np.int32)
    st = _store(cf)
    b, o = st.fetch(st.place_tokens(tokens), torch.from_numpy(idx))
    jb, jo = _jax_fetch(tokens.view(np.uint8).reshape(S, -1), idx, cf)
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(o.numpy(), jo)
    cap = required_capacity(g, 1, cf)
    assert o.shape == (1,) and o.dtype == torch.bool
    assert o.item() == (g > cap)
    got = tokens_from_payload(b, L).numpy()
    np.testing.assert_array_equal(got[:cap], tokens[idx[:cap]])
    assert not got[cap:].any()                  # dropped slots stay zero


def test_fetch_dequant_pipeline():
    """Compressed records (int8 payload + f16 scales), decoded after fetch."""
    n, f = 32, 512
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, f)).astype(np.float32)
    q, scales = block_quantize(x)
    payload = np.concatenate([q.view(np.uint8), scales.view(np.uint8),
                              np.zeros((n, 4), np.uint8)], axis=1)
    st = _store(4.0, num_samples=n, sample_bytes=payload.shape[1])
    idx = rng.permutation(n)[:8].astype(np.int32)
    b, o = st.fetch(st.place(payload), torch.from_numpy(idx))
    jb, _ = _jax_fetch(payload, idx, 4.0)
    np.testing.assert_array_equal(b.numpy(), jb)
    assert not o.item()
    out = decode_records(b, f, out_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), jax_host_dequant(q, scales)[idx])
    out16 = decode_records(b, f)
    assert out16.dtype == torch.bfloat16
    want16 = torch.from_numpy(jax_host_dequant(q, scales)[idx]).to(torch.bfloat16)
    assert torch.equal(out16, want16)


def test_store_validates_shapes():
    with pytest.raises(ValueError):
        DeviceStoreConfig(num_samples=4, sample_bytes=6)
    st = _store(2.0)
    with pytest.raises(ValueError):
        st.place(np.zeros((S, L * 4 + 4), np.uint8))
    assert st.device_bytes == S * L * 4

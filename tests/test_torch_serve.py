"""Serving driver of the port and its device policy: it runs on the CPU only
when asked to, and no kernel wrapper computes on a tensor that is not on a
card."""
import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import DeviceStore, DeviceStoreConfig
from repro_torch.kernels import ops
from repro_torch.kernels.dequant import dequant as dequant_kernel
from repro_torch.kernels.flash_attn import flash_attention as flash_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
from repro_torch.launch import serve
from repro_torch.models import build_model


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a CUDA card")


@pytest.mark.parametrize("arch", ["chatglm3-6b", None],
                         ids=["chatglm3-6b", "default"])
def test_serve_main_on_cpu(capsys, arch):
    pick = [] if arch is None else ["--arch", arch]
    out = serve.main(pick + ["--device", "cpu", "--prompt-len", "8",
                             "--steps", "4", "--batch", "2"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    arch = arch or "hymba-1.5b"          # the reference's default
    assert int(out.max()) < get_smoke(arch).vocab_size
    assert f"{arch} on cpu: generated (2, 4)" in capsys.readouterr().out


def test_serve_run_is_deterministic_and_times_phases():
    cfg = get_smoke("qwen2-72b").scaled(remat=False)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    a, ta, model = serve.run(cfg, toks, steps=3, device="cpu")
    b, _, _ = serve.run(cfg, toks, steps=3, device="cpu")
    assert torch.equal(a, b)
    assert ta["prefill_s"] > 0 and ta["decode_s"] > 0
    assert model.device == torch.device("cpu")


def test_temperature_sampling_on_cpu():
    out = serve.main(["--device", "cpu", "--prompt-len", "4", "--steps", "3",
                      "--sample", "temp", "--batch", "2"])
    assert tuple(out.shape) == (2, 3)


def test_entry_points_refuse_cpu_fallback(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--prompt-len", "4", "--steps", "2"])
    with pytest.raises(RuntimeError):
        build_model(get_smoke("chatglm3-6b"))
    with pytest.raises(RuntimeError):
        DeviceStore(DeviceStoreConfig(num_samples=4, sample_bytes=8))
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((2, 256), dtype=torch.int8)
    s = torch.ones((2, 1), dtype=torch.float16)
    x = torch.zeros((1, 8, 2, 16))
    u, bc, a = torch.zeros((1, 8, 4)), torch.zeros((1, 8, 2)), torch.zeros((4, 2))
    before = (dequant_kernel.launches, flash_kernel.launches, ssm_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ops.dequant(q, s, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        dequant_kernel(q, s)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(x, x, x, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssm_scan(u, u, bc, bc, a, a[:, 0], impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel(u, u, bc, bc, a, a[:, 0])
    with pytest.raises(ValueError):
        ops.attention(x, x, x, impl="interpret")
    assert (dequant_kernel.launches, flash_kernel.launches,
            ssm_kernel.launches) == before
    # auto dispatch on CPU tensors is the plain version
    assert ops.dequant(q, s).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-large",
                                  "deepseek-v2-236b", "internvl2-76b"])
def test_unported_archs_name_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_smoke(arch)


def test_full_chatglm3_config_shape():
    cfg = get_config("chatglm3-6b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (28, 4096, 32, 2, 128,
                                                        13696, 65024)
    model = build_model(cfg.scaled(num_layers=1), device="meta")
    per_layer = sum(p.numel() for p in model.layers[0].parameters())
    embeds = 2 * cfg.vocab_size * cfg.d_model
    total = embeds + cfg.d_model + 28 * per_layer
    assert 6.2e9 < total < 6.3e9


def test_full_hymba_config_shape():
    cfg = get_config("hymba-1.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.d_inner, cfg.ssm_state,
            cfg.vocab_size) == (32, 1600, 25, 5, 64, 5504, 3200, 16, 32001)
    assert (cfg.window, cfg.global_layers) == (1024, (0, 15, 31))
    model = build_model(cfg.scaled(num_layers=2), device="meta")
    assert [blk.attn.window for blk in model.layers] == [None, 1024]
    per_layer = sum(p.numel() for p in model.layers[1].parameters())
    embeds = 2 * cfg.vocab_size * cfg.d_model
    total = embeds + cfg.d_model + 32 * per_layer
    assert total == model.param_count() + 30 * per_layer
    assert 1.5e9 < total < 1.7e9

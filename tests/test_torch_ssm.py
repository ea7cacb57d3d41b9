"""The ssm family of the port against the JAX reference on the CPU: the plain
selective scan, the causal conv, the Mamba-1 mixer and `launch.serve`.
The falcon-mamba model as a whole (logits, prefill caches, decode steps,
greedy tokens) is one of the parametrised archs of ``test_torch_model.py``;
the CUDA kernel against the plain scan is in ``test_torch_cuda.py``. The
scan's gradient: the plain backward (``ref.ssm_scan_bwd_ref``) against
``jax.vjp`` of ``repro.models.mamba.selective_scan``, the scan JAX training
differentiates, and ``ops.ssm_scan`` under grad against autograd through the
plain forward.

Tolerances: in f32 the port's plain scan agrees with the Pallas kernel (run in
interpret mode) and with ``repro.kernels.ref.ssm_scan_ref`` within
rtol = atol = 3e-5, the bound ``tests/test_kernels.py`` holds them to (the
same f32 arithmetic, sums in another order). With bf16 inputs it agrees with
the Pallas kernel within 1e-3, since both widen every input to f32 before
any arithmetic, but only within 2e-2 with ``repro.kernels.ref``, which
rounds ``dt * u`` to bf16 first: that is the one deliberate difference. The
conv and the mixer in f32 agree within 1e-5 (the same ops; the reference's
prefill scan is an associative scan, summed in another order). The scan's
gradients in f32 agree within 1e-5 (the same arithmetic: the reference's
autodiff of its associative scan against an explicit reverse loop, sums in
another order); with bf16 inputs within 2e-2: both widen the inputs and
work in f32, but the reference rounds du's two parts (through the scan and
the skip) to bf16 apart and adds them in bf16, where the port rounds their
f32 sum once, one bf16 ulp apart at most.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import mamba as jax_mamba
from repro.models.mamba import selective_scan
from repro.models.transformer import _mamba_prefill
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd as ssm_bwd_kernel
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.mamba import MambaMixer, causal_conv

F32 = dict(rtol=3e-5, atol=3e-5)
MIXER = dict(rtol=1e-5, atol=1e-5)


def _scan_inputs(rng, b, t, d, s):
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            (rng.random((b, t, d)) * 0.3).astype(np.float32),
            rng.standard_normal((b, t, s)).astype(np.float32),
            rng.standard_normal((b, t, s)).astype(np.float32),
            np.log(np.tile(np.arange(1, s + 1, dtype=np.float32)[None], (d, 1))),
            rng.standard_normal(d).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,t,d,s,bd,tc", [
    (1, 32, 16, 8, 16, 32),
    (2, 64, 32, 8, 16, 16),
    (2, 128, 64, 16, 32, 32),
])
def test_ssm_scan_plain_vs_reference_and_pallas(rng, b, t, d, s, bd, tc):
    args = _scan_inputs(rng, b, t, d, s)
    y, h = ops.ssm_scan(*map(torch.from_numpy, args))
    assert y.dtype == h.dtype == torch.float32
    jargs = list(map(jnp.asarray, args))
    for want in (jax_ops.ssm_scan(*jargs, impl="interpret", block_d=bd,
                                  time_chunk=tc),
                 jax_ref.ssm_scan_ref(*jargs)):
        _close(y, want[0], F32)
        _close(h, want[1], F32)


def test_ssm_scan_plain_with_initial_state(rng):
    args = _scan_inputs(rng, 2, 24, 16, 8)
    h0 = rng.standard_normal((2, 16, 8)).astype(np.float32)
    y, h = ref.ssm_scan_ref(*map(torch.from_numpy, args), h0=torch.from_numpy(h0))
    want = jax_ref.ssm_scan_ref(*map(jnp.asarray, args), h0=jnp.asarray(h0))
    _close(y, want[0], F32)
    _close(h, want[1], F32)


def test_ssm_scan_plain_bf16_widens_before_the_product(rng):
    u, dt, b_in, c_in, a_log, d_skip = _scan_inputs(rng, 1, 32, 16, 8)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (u, dt, b_in, c_in)]
    y, h = ops.ssm_scan(*bf, torch.from_numpy(a_log), torch.from_numpy(d_skip))
    jbf = [jnp.asarray(x, jnp.bfloat16) for x in (u, dt, b_in, c_in)]
    jp = (jnp.asarray(a_log), jnp.asarray(d_skip))
    pallas = jax_ops.ssm_scan(*jbf, *jp, impl="interpret", block_d=16,
                              time_chunk=16)
    _close(y, pallas[0], dict(rtol=1e-3, atol=1e-3))
    _close(h, pallas[1], dict(rtol=1e-3, atol=1e-3))
    jref = jax_ref.ssm_scan_ref(*jbf, *jp)
    _close(y, jref[0], dict(rtol=2e-2, atol=2e-2))
    # the reference rounds dt * u to bf16 before widening; the port does not
    assert not np.array_equal(y.numpy(), np.asarray(jref[0]))


def _grad_inputs(rng, b, t, d, s, dt_kind):
    """Scan inputs with a per-(d, s) a_log and random D; dt as the model's
    init draws it (softplus of a bias in [1e-3, 0.1]) or trained-like, up to
    10, where ā = exp(dt a) underflows for most states."""
    u, _, b_in, c_in, a_log, d_skip = _scan_inputs(rng, b, t, d, s)
    a_log = (a_log + 0.1 * rng.standard_normal((d, s))).astype(np.float32)
    if dt_kind == "init":
        dt = np.exp(rng.random((b, t, d)) * 4.6 - 6.9).astype(np.float32)
    else:
        dt = (rng.random((b, t, d)) * 10).astype(np.float32)
    return u, dt, b_in, c_in, a_log, d_skip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed_h", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("dt_kind", ["init", "trained"])
@pytest.mark.parametrize("b,t,d,s", [(2, 300, 12, 16),     # T past one 256 chunk
                                     (1, 37, 8, 5),        # T below it, S < 16
                                     (2, 260, 6, 1)])
def test_ssm_scan_bwd_ref_vs_jax_vjp(rng, b, t, d, s, dt_kind, seed_h, dtype):
    args = _grad_inputs(rng, b, t, d, s, dt_kind)
    dy = rng.standard_normal((b, t, d)).astype(np.float32)
    dh = (rng.standard_normal((b, d, s)) if seed_h else np.zeros((b, d, s))
          ).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(x, jdt) for x in args[:4]] + [jnp.asarray(x) for x in args[4:]]
    _, vjp = jax.vjp(selective_scan, *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(x).to(tdt) for x in args[:4]] + \
        [torch.from_numpy(x) for x in args[4:]]
    got = ref.ssm_scan_bwd_ref(*targs, torch.from_numpy(dy),
                               torch.from_numpy(dh) if seed_h else None)
    tol = MIXER if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for name, g, w, x in zip(("du", "ddt", "dB", "dC", "da_log", "dD"), got, want,
                             targs):
        assert g.dtype == x.dtype and tuple(g.shape) == tuple(x.shape), name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("use_h", [False, True], ids=["y", "y+h_final"])
def test_ssm_scan_grad_vs_autograd_through_plain_forward(rng, use_h):
    args = _grad_inputs(rng, 2, 40, 8, 16, "init")
    dy = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    grads = []
    for scan in (ops.ssm_scan, ref.ssm_scan_ref):
        xs = [torch.from_numpy(x).requires_grad_() for x in args]
        y, h = scan(*xs)
        loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0)
        loss.backward()
        grads.append([x.grad for x in xs])
    assert type(y.grad_fn).__name__ != "SelectiveScanBackward"    # ref: autograd
    for name, g, w in zip(("du", "ddt", "dB", "dC", "da_log", "dD"), *grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **MIXER)


def test_ssm_scan_under_grad_runs_the_autograd_function(rng):
    xs = [torch.from_numpy(x).requires_grad_() for x in _scan_inputs(rng, 1, 6, 4, 2)]
    y, h = ops.ssm_scan(*xs)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    before = (ssm_kernel.launches, ssm_bwd_kernel.launches)
    (y.sum() + h.sum()).backward()          # CPU tensors: the plain backward
    assert (ssm_kernel.launches, ssm_bwd_kernel.launches) == before
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in xs)
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with ctx:
            assert ops.ssm_scan(*xs)[0].grad_fn is None
    with pytest.raises(ValueError, match="CUDA"):       # impl="kernel": no fallback
        ops.ssm_scan(*xs, impl="kernel")


def test_ssm_scan_bwd_kernel_refuses_cpu_tensors(rng):
    args = [torch.from_numpy(x) for x in _scan_inputs(rng, 1, 6, 4, 2)]
    dy = torch.zeros((1, 6, 4))
    ck = torch.zeros((0, 1, 4, 16))          # no checkpoint before step 8
    before = ssm_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssm_bwd_kernel(*args, dy, h_checkpoints=ck)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_bwd_kernel(*args, dy, torch.zeros((1, 4, 2)), h_checkpoints=ck)
    assert ssm_bwd_kernel.launches == before


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 2, 9])
def test_causal_conv_vs_reference(rng, with_state, t):
    u = rng.standard_normal((2, t, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    got = causal_conv(*map(torch.from_numpy, (u, w, b)),
                      None if st is None else torch.from_numpy(st))
    want = jax_mamba._causal_conv(*map(jnp.asarray, (u, w, b)),
                                  None if st is None else jnp.asarray(st))
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape
        _close(g, wnt, MIXER)


@pytest.fixture(scope="module")
def mixer_pair():
    over = dict(remat=False, dtype="float32")
    jcfg = jax_get_smoke("falcon-mamba-7b").scaled(**over)
    params = jax_mamba.mamba_params(jax.random.key(3), jcfg)
    cfg = get_smoke("falcon-mamba-7b").scaled(**over)
    mixer = MambaMixer(cfg, device="cpu", dtype=torch.float32)
    mixer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    return jcfg, params, mixer


@pytest.mark.parametrize("t", [2, 17])
@torch.no_grad()          # the inference entry points, as serving calls them
def test_mixer_forward_prefill_decode_vs_reference(rng, mixer_pair, t):
    """T = 2 < K - 1 left-pads the conv tail, as the reference does."""
    jcfg, params, mixer = mixer_pair
    x = rng.standard_normal((2, t + 3, jcfg.d_model)).astype(np.float32)
    prompt, steps = x[:, :t], x[:, t:]
    _close(mixer(torch.from_numpy(prompt)),
           jax_mamba.apply_mamba(params, jnp.asarray(prompt), jcfg), MIXER)
    out, cache = mixer.prefill(torch.from_numpy(prompt))
    jout, jcache = _mamba_prefill(params, jnp.asarray(prompt), jcfg)
    _close(out, jout, MIXER)
    assert set(cache) == {"h", "conv"}
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
        _close(cache[key], jcache[key], MIXER)
    jstate = {"h": jcache["h"], "conv": jcache["conv"]}
    for i in range(steps.shape[1]):
        xi = steps[:, i:i + 1]
        got = mixer.decode(torch.from_numpy(xi), cache)
        want, jstate = jax_mamba.apply_mamba_decode(params, jnp.asarray(xi),
                                                    jstate, jcfg)
        _close(got, want, MIXER)
        for key in cache:
            _close(cache[key], jstate[key], MIXER)


def test_serve_main_falcon_mamba_on_cpu(capsys):
    out = serve.main(["--arch", "falcon-mamba-7b", "--device", "cpu",
                      "--prompt-len", "8", "--steps", "4", "--batch", "2"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert int(out.max()) < get_smoke("falcon-mamba-7b").vocab_size
    assert "falcon-mamba-7b on cpu: generated (2, 4)" in capsys.readouterr().out


def test_full_falcon_mamba_config_shape():
    cfg = get_config("falcon-mamba-7b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
            cfg.ssm_conv, cfg.dt_rank, cfg.vocab_size) == (64, 4096, 8192, 16,
                                                           4, 256, 65024)
    model = build_model(cfg.scaled(num_layers=1), device="meta")
    per_layer = sum(p.numel() for p in model.layers[0].parameters())
    assert model.out_embed is None                  # tied embeddings
    total = cfg.vocab_size * cfg.d_model + cfg.d_model + 64 * per_layer
    assert 7.0e9 < total < 7.01e9

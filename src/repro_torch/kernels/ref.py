"""Plain PyTorch versions of the kernels (the correctness ground truth).

Counterparts of ``repro.kernels.ref``: deliberately naive, device-agnostic.
The CPU path runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def dequant_ref(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """q: (N, F) int8; scales: (N, F//block) f16/f32 -> (N, F) out_dtype.

    The product is taken in f32 and rounded once to ``out_dtype``
    (round-to-nearest-even), the same arithmetic as the CUDA kernel.
    """
    n, f = q.shape
    xb = q.reshape(n, f // block, block).to(torch.float32)
    out = xb * scales.to(torch.float32)[..., None]
    return out.reshape(n, f).to(out_dtype)


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                 c_in: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba-1 selective scan with an f32 state.

    u, dt: (B, T, D); b_in, c_in: (B, T, S); a_log: (D, S); d_skip: (D,);
    h0: (B, D, S) initial state (zeros when None). Per step
    ``h = exp(dt * A) * h + (dt * u) * B`` and ``y = h . C + D * u`` with
    ``A = -exp(a_log)``. Returns (y (B, T, D) f32, h_final (B, D, S) f32).

    Every input is widened to f32 before any arithmetic, as the TPU kernel
    and the JAX models' scans do. One deliberate difference from
    ``repro.kernels.ref.ssm_scan_ref``: that one multiplies ``dt * u`` in
    the input dtype and widens after, so with bf16 inputs it rounds the
    product once more; in f32 the two compute the same thing.
    """
    bsz, t, d = u.shape
    a = -torch.exp(a_log.float())
    uf, dtf, bf, cf = u.float(), dt.float(), b_in.float(), c_in.float()
    h = (u.new_zeros((bsz, d, b_in.shape[-1]), dtype=torch.float32)
         if h0 is None else h0.float())
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=u.device)
    for i in range(t):
        dti = dtf[:, i]
        a_bar = torch.exp(dti[..., None] * a)
        bu = (dti * uf[:, i])[..., None] * bf[:, i, None, :]
        h = a_bar * h + bu
        y[:, i] = torch.einsum("bds,bs->bd", h, cf[:, i])
    return y + uf * d_skip.float(), h


def ssm_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                     c_in: torch.Tensor, a_log: torch.Tensor,
                     d_skip: torch.Tensor, dy: torch.Tensor,
                     dh_final: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``ssm_scan_ref`` from a zero state, by an explicit reverse
    loop (not autograd).

    dy: (B, T, D) the cotangent of y; dh_final: (B, D, S) that of h_final
    (zeros when None). Everything is f32 on the widened inputs. With
    ``a = -exp(a_log)``, ``ā_t = exp(dt_t a)`` and ``g`` the adjoint of h,
    walking t from T-1 down to 0::

        g_t = dy_t C_t + ā_{t+1} g_{t+1}        (g_{T-1} = dh_final + dy C)
        du_t  = dt_t Σ_s g_t B_t + D dy_t
        ddt_t = Σ_s g_t (a ā_t h_{t-1} + u_t B_t)
        dB_t  = Σ_d g_t dt_t u_t                dC_t = Σ_d dy_t h_t
        da_log = a Σ_{b,t} g_t dt_t ā_t h_{t-1}   dD = Σ_{b,t} dy_t u_t

    Returns (du, ddt, dB, dC, da_log, dD): the first four in u's dtype, the
    last two in a_log's, each rounded once from f32.
    """
    bsz, t, d = u.shape
    a = -torch.exp(a_log.float())
    uf, dtf, bf, cf = u.float(), dt.float(), b_in.float(), c_in.float()
    dyf = dy.float()
    h = u.new_zeros((bsz, d, b_in.shape[-1]), dtype=torch.float32)
    hs = []                                  # h_t for every step
    for i in range(t):
        dti = dtf[:, i, :, None]
        h = torch.exp(dti * a) * h + (dti * uf[:, i, :, None]) * bf[:, i, None, :]
        hs.append(h)
    carry = (torch.zeros_like(h) if dh_final is None else dh_final.float())
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    db, dc = torch.empty_like(bf), torch.empty_like(bf)
    da = torch.zeros_like(a)
    for i in reversed(range(t)):
        dti, ui = dtf[:, i, :, None], uf[:, i, :, None]
        bi, ci = bf[:, i, None, :], cf[:, i, None, :]
        a_bar = torch.exp(dti * a)
        h_prev = hs[i - 1] if i else torch.zeros_like(h)
        g = dyf[:, i, :, None] * ci + carry
        q = g * a_bar * h_prev
        du[:, i] = dti[..., 0] * (g * bi).sum(-1)
        ddt[:, i] = (a * q + g * ui * bi).sum(-1)
        db[:, i] = (g * dti * ui).sum(1)
        dc[:, i] = (dyf[:, i, :, None] * hs[i]).sum(1)
        da += (dti * q).sum(0)
        carry = a_bar * g
    du += dyf * d_skip.float()
    dd = (dyf * uf).sum((0, 1))
    return (du.to(u.dtype), ddt.to(dt.dtype), db.to(b_in.dtype),
            dc.to(c_in.dtype), (a * da).to(a_log.dtype), dd.to(d_skip.dtype))


def _attention_mask(tq: int, tk: int, causal: bool, window: Optional[int],
                    device) -> torch.Tensor:
    """(tq, tk) bool: key k is live for query q. When Tq != Tk the query
    block is aligned to the end of the keys."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None, scale_in_q: bool = False,
                  probs_bf16: bool = False, return_lse: bool = False):
    """Naive softmax attention. q: (B,Tq,H,dh); k,v: (B,Tk,KV,*).

    Query head h reads kv head h // (H/KV). When Tq != Tk the query block is
    aligned to the end of the keys. Probabilities are rounded to v's dtype
    before the product with v, as in the reference.

    The two flags are ``layers.flash_attention_lax``'s arithmetic as XLA
    compiles it: ``scale_in_q`` multiplies q by ``scale`` in f32 and rounds
    it back to q's dtype, and the scores are then taken without a scale;
    ``probs_bf16`` rounds the exp's argument ``s - m`` to bf16 and takes the
    exp of that in f32, sums those values in f32 and divides the product of
    P (in v's dtype) with v by that sum. The reference's source also rounds
    the exp's result to bf16, but XLA removes that round trip (its compiled
    program computes ``exp(f32(bf16(s - m)))``), so this follows what the
    reference computes. ``m`` is the row's global max;
    ``flash_attention_lax`` takes a running max over key blocks of 512, so
    the two agree exactly for Tk <= 512 (one key block) and within bf16
    rounding of the argument beyond.

    ``return_lse`` also returns each row's log-sum-exp of its scaled, masked
    scores, ``lse = m + log l`` (B, H, Tq) f32, what the backward
    (``attention_bwd_ref``) recomputes P from; it is taken without the two
    flags only (they have no backward).
    """
    if return_lse and (scale_in_q or probs_bf16):
        raise ValueError("the LSE is returned only without the attention flags")
    b, tq, h, dh = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if scale_in_q:
        q = (q.to(torch.float32) * scale).to(q.dtype)
    qg = q.reshape(b, tq, kv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    if not scale_in_q:
        s = s * scale
    mask = _attention_mask(tq, tk, causal, window, q.device)
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    if not probs_bf16:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
        out = out.reshape(b, tq, h, v.shape[-1])
        if return_lse:
            return out, torch.logsumexp(s, dim=-1).reshape(b, h, tq)
        return out
    p = torch.exp((s - s.amax(-1, keepdim=True)).to(torch.bfloat16).to(torch.float32))
    l = p.sum(-1)                                        # (b, kv, g, tq)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    out = out.to(torch.float32) / l.permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype).reshape(b, tq, h, v.shape[-1])


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``attention_ref`` (no flags): the flash backward.

    q: (B,T,H,dh); k, v: (B,T,KV,*); o, do: (B,T,H,dv) the forward's output
    and its cotangent; lse: (B,H,T) f32 from ``attention_ref(...,
    return_lse=True)``. Returns (dq, dk, dv) in the inputs' dtypes, from
    f32 arithmetic on the widened inputs::

        D  = rowsum(dO * O)           P  = exp(S * scale - lse)  (masked: 0)
        dV = P^T dO                   dP = dO V^T
        dS = P * (dP - D)             dQ = dS K * scale,  dK = dS^T Q * scale

    dK and dV sum over the H/KV query heads of each kv head. P is rounded to
    v's dtype before P^T dO, as the forward rounds it before P V, and dS to
    q's dtype before its two products, as the reference's autodiff rounds
    the scores' cotangent to the einsum's dtype; in f32 neither rounds.
    """
    b, t, h, dh = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, t, kv, g, dh)
    dog = do.float().reshape(b, t, kv, g, -1)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    mask = _attention_mask(t, tk, causal, window, q.device)
    p = torch.exp(s - lse.float().reshape(b, kv, g, t)[..., None])
    p = torch.where(mask, p, torch.zeros((), device=p.device))
    dsum = (dog * o.float().reshape(b, t, kv, g, -1)).sum(-1)     # (b,t,kv,g)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(v.dtype).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = (p * (dp - dsum.permute(0, 2, 3, 1)[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(b, t, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))

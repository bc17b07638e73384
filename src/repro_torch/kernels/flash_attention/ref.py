"""Plain PyTorch version of forward attention: the online-softmax scan over
KV chunks of the JAX package's ``models/attention.py::chunked_attention``
(``attention.py:40-97``), whose TPU execution target is the Pallas kernel
``kernels/flash_attention/kernel.py::_flash_kernel``.

The CPU runs it in place of the CUDA kernel, and ``chip_smoke.py`` holds
the kernel against it on the card.  As in the JAX code, p is cast to v's
dtype before p·v; the kernel keeps it in f32, as the Pallas kernel does.
The two agree in f32 and differ by p's bf16 rounding in bf16.

``flash_attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``): the same three steps, written out with
no autograd — delta = rowsum(dO ∘ O), then per KV chunk P = exp(scale
q·k − lse) under the mask, dV = Pᵀ dO, dS = P (dO vᵀ − delta), dQ = scale
dS K, dK = scale dSᵀ Q — in f32 (f64 for f64 inputs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG", "flash_attention_ref", "flash_attention_bwd_ref"]

NEG = -1e30


def _mask(qi, kj, Sk, causal, window):
    mask = kj < Sk
    if causal:
        mask = mask & (kj <= qi)
    if window > 0:
        mask = mask & (qi - kj < window)
    return mask


def flash_attention_ref(
    q,
    k,
    v,
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    return_lse: bool = False,
):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, vh), H = KH·g.
    ``window`` > 0 is a sliding window; query i sits at position
    i + Sk − Sq.  Returns (B, Sq, H, vh) in q's dtype; the softmax state
    is f32 whatever the input dtype (f64 for f64 inputs).  With
    ``return_lse`` also each row's log-sum-exp m + log(max(l, 1e-30)),
    (B, H, Sq) f32."""
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    vh = v.shape[-1]
    g = H // KH
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:  # padded keys are masked out below (kj < Sk)
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device

    st = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, KH, g, hd)
    qi = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    m = torch.full((B, KH, g, Sq), NEG, dtype=st, device=dev)
    lsum = torch.zeros((B, KH, g, Sq), dtype=st, device=dev)
    acc = torch.zeros((B, Sq, KH, g, vh), dtype=st, device=dev)
    for c0 in range(0, Sk + pad, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kj = c0 + torch.arange(chunk, device=dev)[None, :]
        mask = _mask(qi, kj, Sk, causal, window)
        logits = torch.einsum("bqkgh,bckh->bkgqc", qg, kb).to(st)
        logits = torch.where(mask, logits * scale, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        lsum = lsum * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckv->bqkgv", p.to(vb.dtype), vb)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp_min(lsum, 1e-30)
    out = (acc / denom.permute(0, 3, 1, 2)[..., None]).reshape(
        B, Sq, H, vh).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(denom)).reshape(B, H, Sq)
    return out, lse


def flash_attention_bwd_ref(
    q,
    k,
    v,
    o,
    lse,
    do,
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at q, k,
    v, given its output ``o`` (B, Sq, H, vh), its log-sum-exp ``lse``
    (B, H, Sq) and the output's gradient ``do``; the same masks and
    layouts.  Computed in f32 (in f64 for f64 inputs) over KV chunks of
    ``chunk`` keys, returned in the inputs' dtypes.  A key the mask
    hides gets p = 0."""
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    vh = v.shape[-1]
    g = H // KH
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    chunk = min(chunk, Sk)
    qf, kf, vf, of, dof = (t.to(ct) for t in (q, k, v, o, do))
    # step 1: delta = rowsum(dO * O), (B, KH, g, Sq) as the logits' rows
    delta = (dof * of).sum(-1).reshape(B, Sq, KH, g).permute(0, 2, 3, 1)
    lse_g = lse.to(ct).reshape(B, KH, g, Sq)
    qg = qf.reshape(B, Sq, KH, g, hd)
    dog = dof.reshape(B, Sq, KH, g, vh)
    qi = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    # steps 2 and 3: per KV chunk, dK and dV of its keys, dQ summed
    for c0 in range(0, Sk, chunk):
        kb, vb = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        kj = c0 + torch.arange(kb.shape[1], device=dev)[None, :]
        mask = _mask(qi, kj, Sk, causal, window)
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kb) * scale
        p = torch.where(mask, torch.exp(s - lse_g[..., None]), 0.0)
        dvs.append(torch.einsum("bkgqc,bqkgv->bckv", p, dog))
        dp = torch.einsum("bqkgv,bckv->bkgqc", dog, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bkgqc,bckh->bqkgh", ds, kb) * scale
        dks.append(torch.einsum("bkgqc,bqkgh->bckh", ds, qg) * scale)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype))

"""Plain PyTorch version of forward attention: the online-softmax scan over
KV chunks of the JAX package's ``models/attention.py::chunked_attention``
(``attention.py:40-97``), whose TPU execution target is the Pallas kernel
``kernels/flash_attention/kernel.py::_flash_kernel``.

The CPU runs it in place of the CUDA kernel, and ``chip_smoke.py`` holds
the kernel against it on the card.  As in the JAX code, p is cast to v's
dtype before p·v; the kernel keeps it in f32, as the Pallas kernel does.
The two agree in f32 and differ by p's bf16 rounding in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG", "flash_attention_ref"]

NEG = -1e30


def flash_attention_ref(
    q, k, v, *, scale: float, causal: bool = True, window: int = 0, chunk: int = 1024
):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, vh), H = KH·g.
    ``window`` > 0 is a sliding window; query i sits at position
    i + Sk − Sq.  Returns (B, Sq, H, vh) in q's dtype; the softmax state
    is f32 whatever the input dtype."""
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

    qg = q.reshape(B, Sq, KH, g, hd)
    qi = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    m = torch.full((B, KH, g, Sq), NEG, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, KH, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KH, g, vh), dtype=torch.float32, device=dev)
    for c0 in range(0, Sk + pad, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kj = c0 + torch.arange(chunk, device=dev)[None, :]
        mask = kj < Sk
        if causal:
            mask = mask & (kj <= qi)
        if window > 0:
            mask = mask & (qi - kj < window)
        logits = torch.einsum("bqkgh,bckh->bkgqc", qg, kb).float()
        logits = torch.where(mask, logits * scale, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        lsum = lsum * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckv->bqkgv", p.to(vb.dtype), vb)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp_min(lsum, 1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).reshape(B, Sq, H, vh).to(q.dtype)

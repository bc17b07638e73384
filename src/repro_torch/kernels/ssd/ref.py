"""Plain PyTorch version of the SSD chunked scan: the math of the JAX
package's ``models/ssm.py::ssd_chunked`` (which its Pallas kernel
``kernels/ssd/kernel.py::_ssd_kernel`` is held against), in f32.

The CPU runs it in place of the CUDA kernel, and ``chip_smoke.py`` holds
the kernel against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_ref"]


def ssd_ref(x, dt, A, B_, C_, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,) negative; B_, C_:
    (B,S,N), shared across heads; all f32.  Returns (y (B,S,H,P),
    final_state (B,H,N,P)), f32, without the D skip or the gate."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    # pad to a chunk multiple: dt = 0 steps are exact no-ops (no decay, no
    # state update, zero output weight), so padding keeps the final state
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    nc = (S + pad) // Q

    xr = x.reshape(Bb, nc, Q, H, P)
    dtr = dt.reshape(Bb, nc, Q, H)
    Br = B_.reshape(Bb, nc, Q, N)
    Cr = C_.reshape(Bb, nc, Q, N)

    dA = dtr * A[None, None, None, :]  # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk: decay(i, j) = exp(cum_i - cum_j) for i >= j, else 0
    tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    decay = torch.where(tril[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    M = cb[..., None] * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xr)

    # chunk summaries
    last = cum[:, :, -1:, :]  # (B,nc,1,H)
    wj = torch.exp(last - cum) * dtr
    S_c = torch.einsum("bcqh,bcqn,bcqhp->bchnp", wj, Br, xr)

    # inter-chunk recurrence, sequential over chunks
    state = torch.zeros((Bb, H, N, P), dtype=x.dtype, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * torch.exp(last[:, c, 0, :])[:, :, None, None] \
            + S_c[:, c]
    S_prevs = torch.stack(prevs, dim=1)  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cr, S_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S]
    return y, state

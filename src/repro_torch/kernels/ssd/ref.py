"""Plain PyTorch version of the SSD chunked scan: the math of the JAX
package's ``models/ssm.py::ssd_chunked`` (which its Pallas kernel
``kernels/ssd/kernel.py::_ssd_kernel`` is held against), in f32.

The CPU runs it in place of the CUDA kernel, and ``chip_smoke.py`` holds
the kernel against it on the card.  ``ssd_bwd_ref`` is the plain version
of the backward kernel (``csrc/ssd_bwd.cu``): the same gradients written
out chunk by chunk, with no autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_ref", "ssd_bwd_ref"]


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

    # intra-chunk: decay(i, j) = exp(cum_i - cum_j) for i >= j, else 0.
    # Above the diagonal seg > 0 and exp overflows once cum spans more than
    # ~88 (Mamba2-2.7B's chunks do); JAX's where(mask, exp(seg), 0) keeps
    # the inf out of the value but not out of its gradient (0 · inf = nan),
    # so the exponent is masked to -inf first: the same values, a finite
    # gradient under autograd
    tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    decay = torch.exp(seg.masked_fill(~tril[None, None, :, :, None],
                                      float("-inf")))
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


def ssd_bwd_ref(x, dt, A, B_, C_, chunk: int, dy, dstate=None):
    """The gradients (dx, ddt, dA, dB_, dC_) of :func:`ssd_ref` at its
    inputs, from the output's gradient ``dy`` (B,S,H,P) and the final
    state's ``dstate`` (B,H,N,P) or None (zero); in x's dtype (f32, or f64
    for the referee).  Per chunk, with a = dt·A, cum its cumsum, L_ij =
    exp(cum_i − cum_j) for i ≥ j, w_j = exp(cum_last − cum_j) and G the
    gradient of the state after the chunk (a reverse pass):
    u_j = Σ_i (C_i·B_j) L_ij dy_i + w_j Gᵀ B_j, dx = dt u, dB_j = Σ_i L_ij
    dt_j (dy_i·x_j) C_i + w_j dt_j G x_j, dC_i = Σ_j L_ij dt_j (dy_i·x_j)
    B_j + exp(cum_i) S_in dy_i, and every exp(·)'s share of d cum, whose
    reverse cumsum is da: ddt = x·u + A da, dA = Σ da·dt."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if dy is None:
        dy = torch.zeros_like(x)
    if pad:  # dt = 0 steps: no-ops forward, and their gradients are cut
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xr = x.reshape(Bb, nc, Q, H, P)
    dyr = dy.reshape(Bb, nc, Q, H, P)
    dtr = dt.reshape(Bb, nc, Q, H)
    Br = B_.reshape(Bb, nc, Q, N)
    Cr = C_.reshape(Bb, nc, Q, N)

    cum = torch.cumsum(dtr * A[None, None, None, :], dim=2)  # (B,nc,Q,H)
    last = cum[:, :, -1, :]  # (B,nc,H)
    tril = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    L = torch.exp(seg.masked_fill(~tril[None, None, :, :, None],
                                  float("-inf")))
    wl = torch.exp(last[:, :, None, :] - cum)  # (B,nc,Q,H)
    ecum = torch.exp(cum)
    # the forward's chunk states and the state each chunk starts from
    S_c = torch.einsum("bcqh,bcqn,bcqhp->bchnp", wl * dtr, Br, xr)
    state = torch.zeros((Bb, H, N, P), dtype=x.dtype, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * torch.exp(last[:, c])[:, :, None, None] + S_c[:, c]
    S_in = torch.stack(prevs, dim=1)  # (B,nc,H,N,P)
    # the reverse pass: G[c], the gradient of the state chunk c ends with
    U = torch.einsum("bcqh,bcqn,bcqhp->bchnp", ecum, Cr, dyr)
    G = (torch.zeros_like(state) if dstate is None else dstate.to(x.dtype))
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = G
        G = G * torch.exp(last[:, c])[:, :, None, None] + U[:, c]
    Gn = torch.stack(gs, dim=1)  # (B,nc,H,N,P)

    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    DX = torch.einsum("bcihp,bcjhp->bcijh", dyr, xr)
    M = cb[..., None] * L  # (B,nc,Qi,Qj,H)
    R = L * dtr[:, :, None, :, :] * DX
    T = M * dtr[:, :, None, :, :] * DX
    GB = torch.einsum("bcjn,bchnp->bcjhp", Br, Gn)  # Gᵀ B_j
    u = torch.einsum("bcijh,bcihp->bcjhp", M, dyr) + wl[..., None] * GB
    dx = dtr[..., None] * u
    ddt_direct = (xr * u).sum(-1)
    Gx = torch.einsum("bchnp,bcjhp->bcjhn", Gn, xr)  # G x_j
    summ = (wl * dtr)[..., None] * Gx  # (B,nc,Q,H,N)
    dB = torch.einsum("bcijh,bcin->bcjn", R, Cr) + summ.sum(3)
    W = torch.einsum("bcjn,bcjhn->bcjh", Br, summ)
    Sdy = torch.einsum("bchnp,bcihp->bcihn", S_in, dyr)  # S_in dy_i
    inter = ecum[..., None] * Sdy
    dC = torch.einsum("bcijh,bcjn->bcin", R, Br) + inter.sum(3)
    I = torch.einsum("bcin,bcihn->bcih", Cr, inter)
    dcum = T.sum(3) - T.sum(2) + I - W
    dcl = W.sum(2) + torch.exp(last) * (S_in * Gn).sum((-2, -1))
    dcum[:, :, -1, :] += dcl
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt_direct + da * A[None, None, None, :]
    dA = (da * dtr).sum((0, 1, 2))
    Sp = nc * Q
    return (dx.reshape(Bb, Sp, H, P)[:, :S], ddt.reshape(Bb, Sp, H)[:, :S],
            dA, dB.reshape(Bb, Sp, N)[:, :S], dC.reshape(Bb, Sp, N)[:, :S])

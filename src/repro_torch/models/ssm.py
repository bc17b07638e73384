"""Mamba2 (SSD — state-space duality) block: chunked prefill scan and
O(1)-state decode; the port of the JAX package's ``models/ssm.py``.

Shapes follow the Mamba2 convention: d_inner = expand·d_model, H heads of
size P = ssm_head_dim, state size N = ssm_state, n_groups = 1 (B/C shared
across heads).  The chunked scan is ``ssd_chunked``: on the card the CUDA
kernel of ``kernels/ssd`` (K7's counterpart), on the CPU its plain
version.  Decode keeps (ssm_state (B,H,P,N), conv_state).

``mamba_train`` takes the JAX package's sharding hook ``rules`` at its one
site (x's d_inner over the heads' axis); on ``DTensor`` operands the scan
runs on each rank's shards (``models.local.ssd_on_shards``).
``mamba_decode`` takes it for one site of the port's (see there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dtensor import is_dtensor
from ..kernels.ssd import ssd_op
from .layers import ID_RULES, Leaf, rms_norm
from .local import split_heads, ssd_on_shards, zero_pad

__all__ = ["conv_dim", "ssm_specs", "ssd_chunked", "mamba_train",
           "mamba_decode"]


def conv_dim(cfg) -> int:
    """channels that pass through the causal depthwise conv: x ++ B ++ C."""
    return cfg.d_inner + 2 * cfg.ssm_state  # n_groups = 1


def ssm_specs(cfg) -> dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    return {
        "wz": Leaf((d, di), axes=("embed", "heads")),
        "wxbc": Leaf((d, conv_dim(cfg)), axes=("embed", "heads")),
        "wdt": Leaf((d, H), axes=("embed", None)),
        "dt_bias": Leaf((H,), "zeros", axes=(None,)),
        "A_log": Leaf((H,), "zeros", axes=(None,)),
        "D": Leaf((H,), "ones", axes=(None,)),
        "conv_w": Leaf((cfg.conv_width, conv_dim(cfg)), "normal", 0.1,
                       axes=(None, "heads")),
        "conv_b": Leaf((conv_dim(cfg),), "zeros", axes=("heads",)),
        "gate_norm": Leaf((di,), "ones", axes=("heads",)),
        "wo": Leaf((di, d), axes=("heads", "embed")),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv. xbc: (B, S, Ch); w: (W, Ch)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = zero_pad(xbc, 1, before=W - 1)
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu(out + b)


def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """Chunked SSD scan.

    x: (B,S,H,P) values; dt: (B,S,H) post-softplus; A: (H,) negative;
    B_, C_: (B,S,N).  Returns (y: (B,S,H,P), final_state: (B,H,N,P)), f32
    (no D skip / gate).  CUDA tensors go to the kernel (or raise), CPU
    tensors to its plain version, a ``DTensor`` x to either on each
    rank's shards.
    """
    if is_dtensor(x):
        return ssd_on_shards(ssd_op, x, dt, A, B_, C_, chunk)
    return ssd_op(x, dt, A, B_, C_, chunk)


def mamba_train(
    p, cfg, x, chunk: int | None = None, return_state: bool = False, rules=ID_RULES
):
    """Full-sequence Mamba2 block. x: (B,S,d) -> (y, final_state).

    final_state (when requested) is a dict {"ssm": (B,H,P,N), "conv":
    (B, W-1, conv_dim)} — exactly the decode-step carry.
    """
    B, S, _ = x.shape
    di, H, P, N = (cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim,
                   cfg.ssm_state)
    chunk = chunk or cfg.ssm_chunk

    z = x @ p["wz"]  # (B,S,di)
    xbc_raw = x @ p["wxbc"]
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    # one f32 copy; x, B and C are strided views of it, which the kernel
    # reads in place
    xs, B_, C_ = torch.split(xbc.float(), [di, N, N], dim=-1)
    xs = rules(xs, ("batch", "seq", "heads"))
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    xh = split_heads(xs, H, P)
    y, S_final = ssd_chunked(xh, dt, A, B_, C_, chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, False)
    out = y @ p["wo"]
    if not return_state:
        return out, None
    W = cfg.conv_width
    state = {
        "ssm": S_final.transpose(2, 3).to(x.dtype),  # (B,H,P,N)
        "conv": xbc_raw[:, S - (W - 1):, :].to(x.dtype),
    }
    return out, state


def mamba_decode(p, cfg, x, state, rules=ID_RULES):
    """One-token step. x: (B,1,d); state: {"ssm": (B,H,P,N),
    "conv": (B, W-1, conv_dim)}. Returns (y, new_state).  ``rules`` pins
    the new conv row as the window's channels, a site the JAX package's
    ``mamba_decode`` leaves to GSPMD: on ``DTensor`` states the window
    then stays on its shards (left to ``DTensor``, the row's partial sum
    over the embed axis made the whole window partial, all-reduced twice
    a layer); the split of the channels into x, B and C, whose points
    fall inside a shard, gathers one (B, conv_dim) row."""
    B = x.shape[0]
    di, H, P, N = (cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim,
                   cfg.ssm_state)
    W = cfg.conv_width

    z = x @ p["wz"]
    # laid out as the conv window's channels (``_CONV_AXES``), so that the
    # window joins it where it lies
    xbc_new = rules((x @ p["wxbc"])[:, 0, :], ("batch", "heads"))  # (B, Ch)
    conv_in = torch.cat([state["conv"], xbc_new[:, None, :]], dim=1)
    w = p["conv_w"]
    out = sum(conv_in[:, i, :] * w[i] for i in range(W)) + p["conv_b"]
    xbc = F.silu(out)  # (B, Ch)
    new_conv = conv_in[:, 1:, :]

    xs, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus((x[:, 0, :] @ p["wdt"]).float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])

    xh = xs.reshape(B, H, P).float()
    ssm = state["ssm"].float()
    upd = (dt[:, :, None] * xh)[:, :, :, None] * B_[:, None, None, :].float()
    ssm_new = ssm * dA[:, :, None, None] + upd  # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", ssm_new, C_.float())
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, False)
    return y @ p["wo"], {"ssm": ssm_new.to(state["ssm"].dtype),
                         "conv": new_conv}

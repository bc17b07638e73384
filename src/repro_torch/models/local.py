"""The hand-written kernels on ``DTensor`` activations: K6 (attention) and
K7 (the SSD scan) run on each rank's own shards.

The kernels' ``torch.library`` operators have no ``DTensor`` sharding
strategy, and gathering their inputs whole first would hide the sharding.
So each call site unwraps the local shards (``DTensor.to_local``, with
the gradients' placements declared), calls the operator on them — under
autograd its backward kernel too — and wraps the local outputs again
(``DTensor.from_local``): what ``local_map`` does.  Launch counts count
the local launches.

Attention: q (B, Sq, H, hd) may be sharded over batch (dim 0) and heads
(dim 2) and nothing else; k and v (B, Sk, KV, ·) follow q's batch
sharding, and its heads sharding where the rules could shard the kv heads
too.  Where they could not (kv_heads does not divide the axis: ``Rules``
falls back to replication while the q heads still shard), each rank cuts
from its whole k and v exactly the kv heads its q heads read — q head h
reads kv head h // g — as one slice when they form equal groups, else as
one kv head a q head; the k and v gradients are then partial sums over
that axis.  SSD: x (B, S, H, P) may be sharded over batch and heads; dt
and A follow x's heads, B and C (shared across heads) its batch, their
gradients partial over the heads' axis, A's over the batch's.  The
cross-entropy's gold logit on a vocab-sharded ``DTensor``
(:func:`take_last`) is read on the rank that holds its vocab slice, and
a flat projection splits into heads (:func:`split_heads`) after its
columns are gathered over any mesh dim that cannot split the heads evenly
(GQA's 2 kv heads on a model axis of 4); :func:`zero_pad` pads a
``DTensor`` by concatenating zeros, since ``F.pad`` on a ``DTensor`` leaves
a spec of one placement on a 2-D mesh in torch 2.11 (its backward's view
then fails).

The moe dispatch (``models/moe.py``) has gathers, scatters and stable
sorts that ``DTensor`` has no strategy for on a sharded dim; they are
independent for each dispatch group, so :func:`on_group_shards` runs them
on this rank's groups (the leading dim, sharded as the rules' moe_group)
and wraps their outputs alike.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dtensor import is_dtensor

__all__ = ["attention_on_shards", "ssd_on_shards", "on_group_shards",
           "take_last", "split_heads", "zero_pad", "local_slice"]


def local_slice(mesh, placements, dim: int, n: int) -> tuple[int, int]:
    """(offset, length) of this rank's slice of a tensor dim of size ``n``
    under ``placements``: the mesh dims that shard it, major to minor."""
    coord = mesh.get_coordinate()
    off = 0
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n //= mesh.size(i)
            off += coord[i] * n
    return off, n


def _check(name, t, allowed):
    for pl in t.placements:
        if not (isinstance(pl, Replicate)
                or (isinstance(pl, Shard) and pl.dim in allowed)):
            raise ValueError(
                f"{name} has placements {t.placements}: the kernel runs on "
                f"shards of dims {allowed} only (pin the operand with the "
                "rules before the call)")


def _as_dtensor(t, mesh):
    """A plain tensor as a replicated ``DTensor`` on ``mesh``."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _to(t, mesh, placements):
    placements = tuple(placements)
    return t if tuple(t.placements) == placements else t.redistribute(
        mesh, placements)


def attention_on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` — the attention operator — on this rank's
    shards of the ``DTensor``s q, k, v; returns the (B, Sq, H, vh)
    ``DTensor`` laid out as q."""
    mesh = q.device_mesh
    _check("q", q, (0, 2))
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    H, KV = q.shape[2], k.shape[2]
    # k and v: q's batch sharding; its heads sharding where they have it
    kv_pl, kv_grad = [], []
    for i, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            shared = k.placements[i] == Shard(2) and KV % mesh.size(i) == 0
            kv_pl.append(Shard(2) if shared else Replicate())
            kv_grad.append(Shard(2) if shared else Partial())
        else:
            kv_pl.append(pl)
            kv_grad.append(pl)
    k, v = _to(k, mesh, kv_pl), _to(v, mesh, kv_pl)
    ql = q.to_local()
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    q_off, h_loc = local_slice(mesh, q.placements, 2, H)
    k_off, kv_loc = local_slice(mesh, kv_pl, 2, KV)
    g = H // KV
    if h_loc // g != kv_loc or q_off // g != k_off or h_loc % g:
        # the kv heads the local q heads read: q head h reads h // g
        need = [(q_off + j) // g - k_off for j in range(h_loc)]
        lo, n = need[0], need[-1] - need[0] + 1
        if h_loc % n == 0 and need == [lo + j // (h_loc // n)
                                       for j in range(h_loc)]:
            kl, vl = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
        else:  # unequal groups: one kv head a q head
            idx = torch.tensor(need, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    out = fn(ql, kl, vl, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def ssd_on_shards(fn, x, dt, A, B_, C_, chunk: int):
    """``fn(x, dt, A, B_, C_, chunk)`` — the SSD operator — on this rank's
    shards; x a ``DTensor``.  Returns (y laid out as x, the final state
    (B, H, N, P) sharded as x's batch and heads)."""
    mesh = x.device_mesh
    _check("x", x, (0, 2))
    dt, A, B_, C_ = (_as_dtensor(t, mesh) for t in (dt, A, B_, C_))
    dt_pl, a_pl, a_grad, bc_pl, bc_grad, st_pl = [], [], [], [], [], []
    for pl in x.placements:
        heads = isinstance(pl, Shard) and pl.dim == 2
        dt_pl.append(pl)
        a_pl.append(Shard(0) if heads else Replicate())
        # A is shared over the batch: its gradient sums the batch's shards
        a_grad.append(Shard(0) if heads else (
            Partial() if pl == Shard(0) else Replicate()))
        bc_pl.append(Replicate() if heads else pl)
        bc_grad.append(Partial() if heads else pl)
        st_pl.append(Shard(1) if heads else pl)
    dt, A = _to(dt, mesh, dt_pl), _to(A, mesh, a_pl)
    B_, C_ = _to(B_, mesh, bc_pl), _to(C_, mesh, bc_pl)
    y, state = fn(x.to_local(), dt.to_local(),
                  A.to_local(grad_placements=a_grad),
                  B_.to_local(grad_placements=bc_grad),
                  C_.to_local(grad_placements=bc_grad), chunk)
    return (DTensor.from_local(y, mesh, x.placements, run_check=False),
            DTensor.from_local(state, mesh, st_pl, run_check=False))


def on_group_shards(fn, ref, *args):
    """``fn(*args)`` on this rank's dispatch groups: with ``ref`` a
    ``DTensor`` (B, ...) sharded over its leading dim, every ``DTensor``
    argument goes to ref's group sharding (``Shard(0)`` where ref has it,
    replicated elsewhere), ``fn`` runs on the local tensors, and each
    output comes back as a ``DTensor`` laid out alike.  Plain tensors run
    ``fn`` as they are."""
    if not is_dtensor(ref):
        return fn(*args)
    mesh = ref.device_mesh
    layout = tuple(Shard(0) if pl == Shard(0) else Replicate()
                   for pl in ref.placements)
    local = [_to(_as_dtensor(a, mesh), mesh, layout).to_local()
             for a in args]
    out = fn(*local)
    wrap = (lambda t: DTensor.from_local(t, mesh, layout, run_check=False))
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def take_last(x, idx):
    """``x[..., idx]``: the entries of x (..., V) at the indices idx (...)
    along the last dim.  On a ``DTensor`` whose last dim is sharded each
    rank reads the indices in its own slice, zeros elsewhere, and the
    result is partial over those mesh dims: one term in each sum, so it
    is exact (what ``DTensor``'s own masked gather means to do)."""
    last = x.ndim - 1
    if not is_dtensor(x) or Shard(last) not in x.placements:
        return torch.gather(x, -1, idx[..., None])[..., 0]
    mesh = x.device_mesh
    lead = [pl if isinstance(pl, Shard) and pl.dim < last else Replicate()
            for pl in x.placements]
    out_pl = [Partial() if pl == Shard(last) else lead[i]
              for i, pl in enumerate(x.placements)]
    off, n = local_slice(mesh, x.placements, last, x.shape[last])
    li = _to(_as_dtensor(idx, mesh), mesh, lead).to_local() - off
    ok = (li >= 0) & (li < n)
    got = torch.gather(x.to_local(), -1, li.clamp(0, n - 1)[..., None])[..., 0]
    return DTensor.from_local(torch.where(ok, got, 0.0), mesh, out_pl,
                              run_check=False)


def split_heads(x, heads: int, hd: int):
    """x (..., heads·hd) as (..., heads, hd).  A ``DTensor`` whose last
    dim is sharded over mesh dims that do not divide ``heads`` is first
    gathered over those (the view cannot cut a head); the rest stay."""
    if is_dtensor(x):
        last, n, pl = x.ndim - 1, heads, list(x.placements)
        for i, p in enumerate(pl):
            if p == Shard(last):
                if n % x.device_mesh.size(i):
                    pl[i] = Replicate()
                else:
                    n //= x.device_mesh.size(i)
        x = _to(x, x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], heads, hd)


def zero_pad(x, dim: int, before: int = 0, after: int = 0):
    """x with ``before`` zeros ahead of it and ``after`` behind it along
    ``dim``: ``F.pad`` for a plain tensor, a concatenation with zeros of
    x's own layout for a ``DTensor`` (each pad no longer than x's dim)."""
    if not is_dtensor(x):
        pads = [0, 0] * (x.ndim - 1 - dim) + [before, after]
        return torch.nn.functional.pad(x, pads)
    if max(before, after) > x.shape[dim]:
        raise ValueError(f"a pad of {max(before, after)} exceeds dim {dim} "
                         f"of {tuple(x.shape)}")

    def zeros(n):
        return [torch.zeros_like(x.narrow(dim, 0, n))] if n else []
    return torch.cat(zeros(before) + [x] + zeros(after), dim=dim)

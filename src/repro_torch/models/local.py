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

Serving: a cache leaf (B, S_max, ...) may be sharded over its sequence
dim, and ``DTensor`` has no strategy for slicing or ``index_put`` along a
sharded dim.  So each rank writes, in place, the positions its own slice
holds, from the new values laid out as the cache but whole along the
sequence (they move, never the cache): a prefill's prefix
(:func:`write_prefix`), a decode's row at each row's position
(:func:`write_rows`), a state (:func:`write_state`).  The one-token decode attends over the sharded
cache on local shards (:func:`decode_attention_on_shards`,
:func:`mla_decode_on_shards`): q is gathered over the mesh dims that
shard the cache's sequence, each rank takes its slice's logits with the
causal and window mask on global positions, its max, its sum of
exponentials and its unnormalised context, and those are all-reduced over
the same mesh dims — (B, heads, width)-sized partials a layer, never a
cache leaf.  A rank whose slice is wholly masked contributes zero.  On a
cache whose sequence no mesh dim shards, the plain softmax runs on the
local shards, as the unsharded decode does.  The greedy token of
vocab-sharded logits (:func:`argmax_last`) is each slice's argmax,
combined as the largest value and then the least global index among its
ties, the first maximum as ``jnp.argmax`` returns it.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dtensor import is_dtensor
from ..kernels.flash_attention.ref import NEG

__all__ = ["attention_on_shards", "ssd_on_shards", "on_group_shards",
           "take_last", "split_heads", "zero_pad", "local_slice",
           "write_prefix", "write_rows", "write_state", "gqa_decode",
           "mla_decode_softmax", "decode_attention_on_shards",
           "mla_decode_on_shards", "argmax_last"]


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


# ---------------------------------------------------------------------------
# serving: cache writes, decode attention and the greedy token on shards
# ---------------------------------------------------------------------------

def _layout_but(placements, dim: int):
    """``placements`` with every ``Shard(dim)`` replaced by
    ``Replicate()``: an operand laid out as a cache but whole along the
    cache's dim ``dim``."""
    return [Replicate() if pl == Shard(dim) else pl for pl in placements]


def _rows(pos, mesh, placements):
    """This rank's rows of the per-row positions ``pos`` (B,) (a plain
    tensor or a ``DTensor``) for a cache laid out as ``placements``."""
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in placements]
    return _to(_as_dtensor(pos, mesh), mesh, pl).to_local()


def write_prefix(cache, new):
    """cache (B, S_max, ...)[:, :S] ← new (B, S, ...), in place.  On a
    ``DTensor`` cache each rank writes the positions of [0, S) its slice
    holds, from ``new`` gathered to the cache's layout but whole along
    the sequence."""
    S = new.shape[1]
    if not is_dtensor(cache):
        cache[:, :S].copy_(new)
        return cache
    mesh = cache.device_mesh
    off, n = local_slice(mesh, cache.placements, 1, cache.shape[1])
    lo, hi = max(off, 0), min(off + n, S)
    # every rank joins the redistribution, also one that writes nothing
    src = _to(_as_dtensor(new, mesh), mesh,
              _layout_but(cache.placements, 1)).to_local()
    if lo < hi:
        cache.to_local()[:, lo - off:hi - off].copy_(src[:, lo:hi])
    return cache


def write_rows(cache, new, pos):
    """cache (B, S_max, ...) ← new (B, 1, ...) at the per-row positions
    pos (B,), in place.  On a ``DTensor`` cache sharded over its sequence
    each rank writes the rows whose position its slice holds and keeps
    its other rows as they are (a select, not a mask: no host
    synchronisation); unsharded there, it writes as the plain cache."""
    B = cache.shape[0]
    if not is_dtensor(cache):
        cache[torch.arange(B, device=cache.device), pos] = new[:, 0].to(
            cache.dtype)
        return cache
    mesh, local = cache.device_mesh, cache.to_local()
    src = _to(_as_dtensor(new, mesh), mesh,
              _layout_but(cache.placements, 1)).to_local()[:, 0].to(
                  local.dtype)
    rows = torch.arange(local.shape[0], device=local.device)
    at = _rows(pos, mesh, cache.placements)
    if Shard(1) not in cache.placements:
        local[rows, at] = src
        return cache
    off, n = local_slice(mesh, cache.placements, 1, cache.shape[1])
    held = (at >= off) & (at < off + n)
    at = (at - off).clamp(0, n - 1)
    keep = held.reshape((-1,) + (1,) * (src.ndim - 1))
    local[rows, at] = torch.where(keep, src, local[rows, at])
    return cache


def write_state(cache, new):
    """cache ← new, in place (a recurrent state or the cross-attention's
    keys and values): on a ``DTensor`` cache, ``new`` laid out as the
    cache and copied shard to shard."""
    if not is_dtensor(cache):
        cache.copy_(new)
        return cache
    mesh = cache.device_mesh
    cache.to_local().copy_(
        _to(_as_dtensor(new, mesh), mesh, cache.placements).to_local())
    return cache


def _all_reduce(t, mesh, placements, dims, op: str):
    """``t``, this rank's term, reduced with ``op`` over the mesh dims
    ``dims``; ``placements`` lay out its other dims."""
    pl = [Partial(op) if i in dims else p for i, p in enumerate(placements)]
    done = [Replicate() if i in dims else p for i, p in enumerate(placements)]
    return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
        mesh, done).to_local()


def _softmax_context(lf, m, context, combine):
    """The softmax of the masked f32 logits ``lf`` (..., s) applied by
    ``context(weights)`` (..., w).  With ``combine`` (this rank holds a
    slice of s): the local max, the exponentials' sum and the
    unnormalised context, ``combine(t, op)`` reducing them across the
    slices; a wholly masked slice adds zeros."""
    if combine is None:
        return context(torch.softmax(lf, dim=-1))
    mx = combine(lf.amax(dim=-1, keepdim=True), "max")
    e = torch.where(m, torch.exp(lf - mx), 0.0)
    both = combine(torch.cat([context(e).float(), e.sum(-1, keepdim=True)],
                             dim=-1), "sum")
    return both[..., :-1] / both[..., -1:]


def gqa_decode(q, k_cache, v_cache, pos, *, window=None, off=0, combine=None):
    """One query row a (row, head) against a cache slice: q (B, 1, H, hd),
    k/v (B, n, KV, hd) holding the global positions [off, off + n), pos
    (B,) the positions each row attends up to, ``window`` > 0 a sliding
    window.  Returns the context (B, 1, KV, g, hd).  ``combine`` None:
    the whole cache, the plain softmax."""
    B, _, H, hd = q.shape
    KV, n = k_cache.shape[2], k_cache.shape[1]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg,
                          k_cache.to(q.dtype)) / math.sqrt(hd)
    idx = torch.arange(off, off + n, device=q.device)[None, None, None,
                                                      None, :]
    m = idx <= pos[:, None, None, None, None]
    if window is not None and window > 0:
        m = m & (pos[:, None, None, None, None] - idx < window)
    lf = torch.where(m, logits.float(), NEG)
    if combine is None:
        attn = torch.softmax(lf, dim=-1)
        return torch.einsum("bkgqs,bskh->bqkgh", attn.to(v_cache.dtype),
                            v_cache)
    ctx = _softmax_context(lf, m, lambda w: torch.einsum(
        "bkgqs,bskh->bkgqh", w.to(v_cache.dtype), v_cache), combine)
    return ctx.permute(0, 3, 1, 2, 4)


def mla_decode_softmax(
    q_eff, q_rope, c_cache, r_cache, pos, scale, *, off=0, combine=None
):
    """MLA's absorbed decode attention over a cache slice: q_eff (B, 1, H,
    R), q_rope (B, 1, H, rh), c (B, n, R), r (B, n, rh) holding the global
    positions [off, off + n).  Returns the compressed context (B, 1, H,
    R) in c's dtype (f32 under ``combine``)."""
    n = c_cache.shape[1]
    logits = (torch.einsum("bqhr,bsr->bhqs", q_eff, c_cache.to(q_eff.dtype))
              + torch.einsum("bqhp,bsp->bhqs", q_rope,
                             r_cache.to(q_rope.dtype))) * scale
    idx = torch.arange(off, off + n, device=q_eff.device)[None, None, None, :]
    m = idx <= pos[:, None, None, None]
    lf = torch.where(m, logits.float(), NEG)
    if combine is None:
        attn = torch.softmax(lf, dim=-1)
        return torch.einsum("bhqs,bsr->bqhr", attn.to(c_cache.dtype),
                            c_cache)
    ctx = _softmax_context(lf, m, lambda w: torch.einsum(
        "bhqs,bsr->bhqr", w.to(c_cache.dtype), c_cache), combine)
    return ctx.transpose(1, 2)


def _decode_layout(cache, heads_dim):
    """(q's placements, the sequence-sharding mesh dims) for a decode over
    ``cache``: q follows the cache's batch sharding and, where the cache
    shards its heads (``heads_dim``), its heads; it is whole over every
    other mesh dim, those that shard the sequence among them."""
    q_pl = [pl if pl == Shard(0) or (heads_dim is not None
                                     and pl == Shard(heads_dim))
            else Replicate() for pl in cache.placements]
    seq = [i for i, pl in enumerate(cache.placements) if pl == Shard(1)]
    return q_pl, seq


def decode_attention_on_shards(q, k_cache, v_cache, pos, *, window=None):
    """:func:`gqa_decode` on this rank's shards of the ``DTensor`` caches
    (B, S_max, KV, hd), sharded over batch, sequence and kv heads: q (B,
    1, H, hd) is laid out as the cache (its heads with the kv heads, whole
    over the sequence's mesh dims); returns the context (B, 1, H, hd) as
    a ``DTensor`` laid out so."""
    mesh = k_cache.device_mesh
    _check("k_cache", k_cache, (0, 1, 2))
    q_pl, seq = _decode_layout(k_cache, 2)
    ql = _to(_as_dtensor(q, mesh), mesh, q_pl).to_local()
    off, _ = local_slice(mesh, k_cache.placements, 1, k_cache.shape[1])
    # the partials (B, KV, g, 1, ·): batch dim 0, kv heads dim 1
    part = [Shard(1) if pl == Shard(2) else pl for pl in q_pl]
    combine = (lambda t, op: _all_reduce(t, mesh, part, seq, op)) \
        if seq else None
    ctx = gqa_decode(ql, k_cache.to_local(), v_cache.to_local(),
                     _rows(pos, mesh, k_cache.placements), window=window,
                     off=off, combine=combine)
    B, _, KV, g, hd = ctx.shape
    return DTensor.from_local(ctx.reshape(B, 1, KV * g, hd), mesh, q_pl,
                              run_check=False)


def mla_decode_on_shards(q_eff, q_rope, c_cache, r_cache, pos, scale):
    """:func:`mla_decode_softmax` on this rank's shards of the ``DTensor``
    caches (B, S_max, ·), sharded over batch and sequence; returns the
    compressed context (B, 1, H, R) as a ``DTensor`` (whole heads)."""
    mesh = c_cache.device_mesh
    _check("c_cache", c_cache, (0, 1))
    q_pl, seq = _decode_layout(c_cache, None)
    qe, qr = (_to(_as_dtensor(t, mesh), mesh, q_pl).to_local()
              for t in (q_eff, q_rope))
    r_cache = _to(_as_dtensor(r_cache, mesh), mesh, c_cache.placements)
    off, _ = local_slice(mesh, c_cache.placements, 1, c_cache.shape[1])
    combine = (lambda t, op: _all_reduce(t, mesh, q_pl, seq, op)) \
        if seq else None
    ctx = mla_decode_softmax(qe, qr, c_cache.to_local(), r_cache.to_local(),
                             _rows(pos, mesh, c_cache.placements), scale,
                             off=off, combine=combine)
    return DTensor.from_local(ctx, mesh, q_pl, run_check=False)


def argmax_last(x):
    """The index of the largest entry along the last dim, the first among
    ties, as int64.  On a ``DTensor`` whose last dim is sharded each rank
    takes its slice's argmax, then the largest value is all-reduced, and
    the least global index among the slices that hold it; the result is
    laid out as x's leading dims."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1)
    last, mesh = x.ndim - 1, x.device_mesh
    whole = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    x = _to(x, mesh, whole)
    lead = [pl if isinstance(pl, Shard) and pl.dim < last else Replicate()
            for pl in whole]
    dims = [i for i, pl in enumerate(whole) if pl == Shard(last)]
    local = x.to_local()
    if not dims:
        return DTensor.from_local(torch.argmax(local, dim=-1), mesh, lead,
                                  run_check=False)
    off, _ = local_slice(mesh, whole, last, x.shape[last])
    at = torch.argmax(local, dim=-1)
    val = torch.gather(local, -1, at[..., None])[..., 0]
    best = _all_reduce(val, mesh, lead, dims, "max")
    cand = torch.where(val == best, at + off, x.shape[last])
    return DTensor.from_local(_all_reduce(cand, mesh, lead, dims, "min"),
                              mesh, lead, run_check=False)

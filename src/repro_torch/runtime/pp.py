"""Pipeline parallelism: a GPipe-style microbatch pipeline over one axis of
a ``DeviceMesh``, on ``torch.distributed`` point-to-point operations — the
port of the JAX package's ``runtime/pp.py`` (``shard_map`` +
``lax.ppermute`` there).

Schedule: T = M + S − 1 ticks.  At tick t stage 0 ingests microbatch t
(clamped to M − 1, as the JAX loop reads it); every stage applies its own
slice of the stacked parameters; activations hop one stage, i → (i+1)
mod S, as one ``batch_isend_irecv`` of a send and a receive on the axis's
process group.  The last stage banks the finished microbatch t − (S − 1),
and at the end its bank is broadcast to every rank of the axis (JAX's
masked ``psum``).  The other mesh axes run the same pipeline on their own
sub-groups, replicated, as JAX's ``P()`` does.  Bubble fraction =
(S − 1)/T (``bubble_fraction``), so launch configs can size M.

Forward only: no caller differentiates through the pipeline, and an input
that requires a gradient raises rather than being detached.
"""
from __future__ import annotations

import torch

__all__ = ["gpipe", "bubble_fraction"]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"stage_params holds a {type(tree).__name__}: a tree of "
                    "tensors in dicts, lists and tuples is expected")


def _tensors(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def gpipe(stage_fn, stage_params, micro_inputs, *, mesh, axis: str):
    """Run ``micro_inputs`` through S sequential stages, pipelined over the
    mesh axis ``axis`` (S = its size).

    stage_fn(params_one_stage, x) -> y, the same shape as x.
    stage_params: a tree of tensors stacked along a leading stage dim of
    size S; the rank at position i of the axis applies slice i.
    micro_inputs: (M, mb, ...) microbatches, the same on every rank.
    Returns the (M, mb, ...) outputs on every rank."""
    import torch.distributed as dist

    from ..launch.mesh import require_execution

    require_execution(mesh, "gpipe")
    leaves = _tensors(stage_params) + [micro_inputs]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        raise ValueError("gpipe runs forward only: an input requires a "
                         "gradient, and the pipeline has no backward")
    S = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    M = int(micro_inputs.shape[0])
    for t in _tensors(stage_params):
        if t.shape[0] != S:
            raise ValueError(f"a stage parameter of shape {tuple(t.shape)} "
                             f"is not stacked over the {S} stages of {axis!r}")
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)  # global, in axis order
    nxt, prv = ranks[(idx + 1) % S], ranks[(idx - 1) % S]
    p = _tree_map(lambda a: a[idx], stage_params)

    buf = torch.zeros_like(micro_inputs[0])
    outs = torch.zeros_like(micro_inputs)
    for t in range(M + S - 1):
        cur = micro_inputs[min(t, M - 1)] if idx == 0 else buf
        y = stage_fn(p, cur)
        out_t = t - (S - 1)
        if idx == S - 1 and out_t >= 0:
            outs[out_t] = y
        if S == 1:
            buf = y  # the hop is the identity
            continue
        buf = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, buf, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if S > 1:
        dist.broadcast(outs, src=ranks[S - 1], group=group)
    return outs

"""Logical-axis sharding rules with a divisibility fallback: the port of
the JAX package's ``runtime/sharding.py``.

A ``Rules`` object maps logical axis names to mesh axes.
``spec(shape, axes)`` gives each tensor dim its mesh axes, dropping any
assignment whose mesh-axis product does not divide the dim, or whose mesh
axis an earlier dim already took — the same per-dim assignment as JAX's
``PartitionSpec``: ``None``, one axis name, or a tuple of names (e.g.
kv_heads = 8 on a model = 16 axis falls back to replication while the
flattened 1024-wide weight column still shards).  From the spec come the
``torch.distributed.tensor`` placements of a ``DeviceMesh``
(:meth:`Rules.placements`) and one device's shard shape
(:meth:`Rules.local_shape`, as ``NamedSharding.shard_shape`` gives it).

The mesh arithmetic reads only the mesh's axis names and sizes: a
``DeviceMesh`` (``mesh_dim_names``, ``shape``), or any object with
``axis_names`` and a ``shape`` mapping of name to size, as JAX's ``Mesh``
has.  So ``spec`` and ``local_shape`` need no process group.

Presets:
  train/prefill : DP over (pod, data), FSDP params over data, TP over
                  model, SP residuals (seq → model)
  decode        : batch over (pod, data), KV-cache seq over model
  long          : batch = 1 ⇒ cache/state sharded over everything available
  fsdp          : no TP; params over both mesh axes (ZeRO-3)

The models' training losses call ``rules(x, axes)`` at the JAX package's
sites (``Model.loss(params, batch, rules=...)``): on ``DTensor``
activations it redistributes to the rule's placements, on plain tensors
and without a mesh it is the identity.  The dry run uses the same rules
to know where each parameter, cache and batch leaf lives.

Placing a tree on a mesh, the counterpart of ``jax.device_put(tree,
rules.tree_shardings(...))``: every rank builds the same full tensors (from
one seed, or read from a checkpoint), and :func:`shard_tensor` keeps this
rank's slice as a ``DTensor`` (``DTensor.from_local``, no communication).
:func:`place` does that for each leaf of a state — a ``ParamTree``, the
dataclasses of a train state, dicts, lists — from a tree of ``Sharding``s
nested alike, and :func:`zeros_placed` allocates a serving cache so, each
rank its own slice alone; :func:`state_leaves` and :func:`map_state` walk
such trees with the checkpoint's "/"-joined keys.  A program that mixes plain tensors
(``torch.arange`` positions, masks) into ``DTensor`` arithmetic runs under
:func:`replicating`, which takes them as replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

from ..dtensor import is_dtensor

__all__ = ["Rules", "Sharding", "make_rules", "PRESETS", "mesh_axes",
           "shard_tensor", "local_chunk", "place", "zeros_placed",
           "state_leaves", "map_state", "replicating", "full"]

# logical name -> tuple of mesh axes (in priority order)
PRESETS: dict[str, dict[str, tuple[str, ...]]] = {
    "train": {
        "batch": ("pod", "data"),
        "seq": (),  # attention runs with full seq per shard
        "seq_sp": ("model",),  # SP: residual stream seq-sharded
        "embed": ("data",),  # FSDP
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "layers": (),
        "cache_seq": (),
        "moe_group": ("pod", "data"),
    },
    "decode": {
        "batch": ("pod", "data"),
        "seq": (),
        "seq_sp": (),
        "embed": ("data",),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "layers": (),
        "cache_seq": ("model",),
        "moe_group": ("pod", "data"),
    },
    "long": {
        "batch": (),
        "seq": (),
        "seq_sp": ("model",),
        "embed": ("data",),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "layers": (),
        "cache_seq": ("pod", "data"),
        "moe_group": ("model",),
    },
    # FSDP pivot: no tensor parallelism — params fully sharded over BOTH
    # mesh axes (ZeRO-3), residuals sequence-sharded over model
    "fsdp": {
        "batch": ("pod", "data"),
        "seq": (),
        "seq_sp": ("model",),
        "embed": ("data", "model"),
        "vocab": (),
        "heads": (),
        "kv_heads": (),
        "mlp": (),
        "expert": ("model",),
        "layers": (),
        "cache_seq": (),
        "moe_group": ("pod", "data"),
    },
}


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's order: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``, or a JAX-style ``axis_names`` and
    ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


class Sharding(NamedTuple):
    """Where one tensor lives: the mesh, its per-dim spec and the mesh's
    placements (``Rules.named``; JAX's ``NamedSharding``)."""
    mesh: Any
    spec: tuple
    placements: tuple


def _is_axes(node) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(node, tuple) and all(
        a is None or isinstance(a, str) for a in node)


@dataclasses.dataclass(frozen=True, eq=False)
class Rules:
    mesh: Optional[Any]
    table: dict[str, tuple[str, ...]]

    def spec(self, shape: tuple[int, ...], axes) -> tuple:
        """Each dim's mesh axes for a concrete shape, divisibility-aware:
        ``None``, one axis name, or a tuple of names.  ``()`` without a
        mesh (JAX's empty ``PartitionSpec``)."""
        if self.mesh is None:
            return ()
        sizes = mesh_axes(self.mesh)
        used: set[str] = set()
        parts: list[Any] = []
        for dim, name in zip(shape, axes):
            assign: tuple[str, ...] = ()
            if name is not None:
                want = tuple(a for a in self.table.get(name, ())
                             if a in sizes and a not in used)
                prod = math.prod(sizes[a] for a in want)
                if want and dim % prod == 0 and prod > 1:
                    assign = want
            used.update(assign)
            parts.append(assign if len(assign) > 1 else
                         (assign[0] if assign else None))
        return tuple(parts)

    @staticmethod
    def dim_axes(entry) -> tuple[str, ...]:
        """One spec entry as a tuple of mesh axes."""
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def local_shape(self, shape: tuple[int, ...], axes) -> tuple[int, ...]:
        """One device's shard of a tensor of ``shape``: each dim divided by
        the product of the mesh axes it is sharded over (the divisibility
        fallback makes every division exact)."""
        shape = tuple(int(s) for s in shape)
        if self.mesh is None:
            return shape
        sizes = mesh_axes(self.mesh)
        spec = self.spec(shape, axes)
        out = list(shape)
        for d, entry in enumerate(spec):
            out[d] //= math.prod(sizes[a] for a in self.dim_axes(entry))
        return tuple(out)

    def placements(self, shape: tuple[int, ...], axes) -> tuple:
        """The ``torch.distributed.tensor`` placements over the mesh's dims:
        ``Shard(d)`` where mesh dim i shards tensor dim d, else
        ``Replicate()``.  A tensor dim sharded over several mesh axes takes
        them major to minor in the spec's order, which must be the mesh's
        (every preset's is)."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(mesh_axes(self.mesh))
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec(shape, axes)):
            group = self.dim_axes(entry)
            pos = [names.index(a) for a in group]
            if pos != sorted(pos):
                raise ValueError(f"dim {d} is sharded over {group}, out of "
                                 f"the mesh's order {tuple(names)}: "
                                 "placements cannot express that order")
            for i in pos:
                out[i] = Shard(d)
        return tuple(out)

    def named(self, shape: tuple[int, ...], axes) -> Sharding:
        spec = self.spec(shape, axes)
        placements = () if self.mesh is None else self.placements(shape, axes)
        return Sharding(self.mesh, spec, placements)

    def tree_shardings(self, abstract_tree, axes_tree):
        """A ``Sharding`` for every leaf of ``abstract_tree`` (a
        ``ParamTree``, or dicts, lists and tuples of tensors), nested as
        ``axes_tree``, whose leaves are the tensors' axes tuples."""
        def walk(ab, ax):
            if _is_axes(ax):
                return self.named(tuple(ab.shape), ax)
            if isinstance(ax, dict):
                return {k: walk(ab[k], v) for k, v in ax.items()}
            return type(ax)(walk(ab[i], v) for i, v in enumerate(ax))
        return walk(abstract_tree, axes_tree)

    def __call__(self, x, axes):
        """``x`` redistributed to the rule's placements when it is a
        ``DTensor``; ``x`` unchanged without a mesh or for a plain
        tensor."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(x.shape, axes))


def make_rules(
    mesh: Optional[Any], preset: str = "train", overrides: Optional[dict] = None
) -> Rules:
    table = dict(PRESETS[preset])
    if overrides:
        table.update({k: tuple(v) for k, v in overrides.items()})
    return Rules(mesh=mesh, table=table)



# ---------------------------------------------------------------------------
# placing full tensors on a mesh
# ---------------------------------------------------------------------------

def full(x):
    """The whole tensor: a ``DTensor``'s ``full_tensor()`` (a collective
    every rank of its mesh joins), a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def replicating(rules: Optional[Rules]):
    """A context in which plain tensors meet ``DTensor``s as replicated
    ones (``implicit_replication``) when ``rules`` has a mesh; a null
    context otherwise."""
    import contextlib
    if rules is None or getattr(rules, "mesh", None) is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def local_chunk(t, mesh, placements):
    """This rank's slice of the full tensor ``t`` under ``placements``:
    each mesh dim that shards a tensor dim cuts it into equal chunks, in
    the mesh's dim order (the layout ``distribute_tensor`` makes)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if t.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not "
                                 f"split into {n} equal shards")
            t = torch.chunk(t, n, dim=pl.dim)[coord[i]]
        elif not isinstance(pl, Replicate):
            raise ValueError(f"cannot place a full tensor as {pl}")
    return t


def _mesh_device(mesh):
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_tensor(t, mesh, placements, dtype=None):
    """The full tensor ``t`` (the same on every rank) as a ``DTensor`` on
    ``mesh``: this rank keeps its own slice, on the mesh's device, in
    ``dtype`` (default ``t``'s).  No communication.  A slice is a copy (the
    full tensor can go); a whole tensor already on that device in that
    dtype is kept as it is, its storage shared."""
    from torch.distributed.tensor import DTensor
    t = t.detach()
    local = local_chunk(t, mesh, tuple(placements))
    if local.shape != t.shape:
        local = local.clone()
    local = local.to(_mesh_device(mesh), dtype or t.dtype)
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def zeros_placed(abstract, shardings):
    """Zeros of the shapes and dtypes of ``abstract`` (a tree of meta
    tensors: dicts, lists, tuples), each placed by its ``Sharding`` in
    ``shardings`` (nested alike, every one with a mesh): this rank
    allocates its own slice alone, on the mesh's device, a ``DTensor`` of
    the whole leaf's shape."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(shardings, Sharding):
        shape = tuple(abstract.shape)
        mesh, local = shardings.mesh, list(shape)
        for i, pl in enumerate(shardings.placements):
            if isinstance(pl, Shard):
                local[pl.dim] //= mesh.size(i)
        z = torch.zeros(local, dtype=abstract.dtype, device=_mesh_device(mesh))
        return DTensor.from_local(z, mesh, shardings.placements,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())
    if isinstance(shardings, dict):
        return {k: zeros_placed(abstract[k], v) for k, v in shardings.items()}
    return type(shardings)(zeros_placed(abstract[i], v)
                           for i, v in enumerate(shardings))


def _key(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def state_leaves(state, prefix: str = "", leaf_type=None):
    """(key, leaf) pairs of a state, in a fixed order: tensors (or, with
    ``leaf_type``, objects of that type) in dataclasses, ``nn.Module``
    parameter trees (named as ``named_parameters``), dicts, lists and
    tuples, keyed "params/blocks.0.attn.wq", "opt/m/embed", "opt/step"."""
    import dataclasses

    import torch
    if leaf_type is not None and isinstance(state, leaf_type):
        yield prefix, state
    elif isinstance(state, torch.Tensor):
        yield prefix, state
    elif isinstance(state, torch.nn.Module):
        for name, p in state.named_parameters():
            yield _key(prefix, name), p
    elif dataclasses.is_dataclass(state):
        for f in dataclasses.fields(state):
            yield from state_leaves(getattr(state, f.name),
                                    _key(prefix, f.name), leaf_type)
    elif isinstance(state, dict):
        for k, v in state.items():
            yield from state_leaves(v, _key(prefix, k), leaf_type)
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from state_leaves(v, _key(prefix, i), leaf_type)
    elif state is not None:
        raise TypeError(f"{prefix}: a state holds no {type(state)}")


def map_state(state, fn, prefix: str = ""):
    """``state`` with each tensor ``t`` at key ``k`` replaced by ``fn(k,
    t)``: an ``nn.Module``'s parameters are replaced in place (an
    ``nn.Parameter`` of the new value that requires a gradient as the old
    did); a dataclass, dict, list or tuple is rebuilt where one of its
    leaves changed, and is the same object where none did."""
    import dataclasses

    import torch
    if isinstance(state, torch.nn.Module):
        for name, p in list(state.named_parameters()):
            new = fn(_key(prefix, name), p)
            if new is p:
                continue
            *path, last = name.split(".")
            mod = state
            for part in path:
                mod = getattr(mod, part) if not part.isdigit() else mod[int(part)]
            setattr(mod, last, torch.nn.Parameter(
                new.detach(), requires_grad=p.requires_grad))
        return state
    if isinstance(state, torch.Tensor):
        return fn(prefix, state)
    if state is None:
        return None
    if dataclasses.is_dataclass(state):
        old = {f.name: getattr(state, f.name)
               for f in dataclasses.fields(state)}
        new = {k: map_state(v, fn, _key(prefix, k)) for k, v in old.items()}
        same = all(new[k] is old[k] for k in old)
        return state if same else dataclasses.replace(state, **new)
    if isinstance(state, dict):
        new = {k: map_state(v, fn, _key(prefix, k)) for k, v in state.items()}
        return state if all(new[k] is state[k] for k in state) else new
    if isinstance(state, (list, tuple)):
        new = [map_state(v, fn, _key(prefix, i)) for i, v in enumerate(state)]
        same = all(a is b for a, b in zip(new, state))
        return state if same else type(state)(new)
    raise TypeError(f"{prefix}: a state holds no {type(state)}")


def place(state, shardings):
    """``state`` with every leaf on its ``Sharding``'s mesh and
    placements: ``shardings`` nests as ``state`` does, a parameter tree's
    place taken by a {parameter name: Sharding} dict (the keys of
    :func:`state_leaves` agree); a ``Sharding`` without a mesh, or a
    missing one, leaves its leaf as it is.  A ``DTensor`` leaf is gathered whole first
    (every rank of its mesh joins), so a state moves between meshes."""
    table = dict(state_leaves(shardings, leaf_type=Sharding))

    def put(key, t):
        sh = table.get(key)
        if sh is None or sh.mesh is None:
            return t
        return shard_tensor(full(t), sh.mesh, sh.placements)
    return map_state(state, put)

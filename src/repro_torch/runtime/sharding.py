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

The models do not call ``Rules`` on their activations yet (one card); the
dry run uses it to know where each parameter, cache and batch leaf lives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

__all__ = ["Rules", "Sharding", "make_rules", "PRESETS", "mesh_axes"]

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


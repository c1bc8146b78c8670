"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP on one mesh).

Every parameter in the model template carries a tuple of *logical* axis
names; this module maps them onto mesh axes by the JAX package's table.
A spec is a tuple with one entry per tensor dim: None (replicated), a
mesh axis name, or a tuple of names (the dim split over those axes,
the first one major).  On a `DeviceMesh` a spec becomes one DTensor
placement per mesh dim (`Sharding.placements`); a dim that its mesh
axes do not divide degrades to replication.  Without a mesh every
constraint is the identity.  The models do not place activations by
these specs: under a mesh they gather, reduce and split with the
explicit collectives of `repro_torch.sharding.collectives`, led by the
parameters' specs (`models.transformer.ModelParallel`).  Serving state
is placed as the JAX package's dry run places it: a batch by
`batch_lead`, a decode cache by `cache_specs`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

# Logical axis vocabulary used by model templates.
#   layers/groups: stacked layer dims, never sharded
#   embed:    d_model dim of weights (FSDP target)
#   q_heads:  fused head*head_dim output dim of attention projections (TP)
#   kv_heads: fused kv_head*head_dim dim (TP only if divisible)
#   ff:       dense FFN hidden (TP)
#   ff_expert: per-expert FFN hidden (unsharded; experts carry the TP)
#   experts:  MoE expert dim (EP -> "model")
#   vocab:    embedding/vocab dim (TP)
#   ssm_inner: mamba d_inner (TP)
#   ssm_heads: mamba head dim (TP)
#   norep:    always replicated


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or None). fsdp=False drops the FSDP dim."""

    tensor_axis: str = "model"
    fsdp_axis: str | None = "data"   # None disables FSDP (pure replication)
    batch_axes: tuple = ("data",)    # activations; multi-pod: ("pod","data")
    seq_axis: str | None = None      # SP for long-context decode caches
    act_seq_axis: str | None = "model"  # Megatron-SP: residual activations
                                        # sharded seq-wise over the TP axis

    def logical_to_mesh(self) -> dict:
        t, f = self.tensor_axis, self.fsdp_axis
        return {
            "layers": None,
            "groups": None,
            "embed": f,
            "q_heads": t,
            "kv_heads": t,      # dropped at spec time if not divisible
            "ff": t,
            "ff_expert": None,
            "experts": t,
            "vocab": t,
            "ssm_inner": t,
            "ssm_heads": t,
            "ssm_state": None,
            "conv": None,
            "codebooks": None,
            "norep": None,
            "batch": self.batch_axes,
            "seq": self.seq_axis,
            "actseq": self.act_seq_axis,
            # MoE routing groups spread over every mesh axis
            "moe_groups": tuple(self.batch_axes) + (self.tensor_axis,),
        }


PROD_RULES = ShardingRules()
MULTIPOD_RULES = ShardingRules(batch_axes=("pod", "data"))


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_of(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def spec_for(axes: tuple, rules: ShardingRules, shape: tuple | None = None,
             mesh=None) -> tuple:
    """Map a tuple of logical axes to a spec.

    If ``shape`` and ``mesh`` (a `DeviceMesh`) are given,
    any dim not divisible by its mesh axes' size degrades to replication
    (e.g. 4 kv heads on a 16-way model axis).
    """
    table = rules.logical_to_mesh()
    sizes = mesh_axis_sizes(mesh) if mesh is not None else None
    out = []
    for i, ax in enumerate(axes):
        m = table.get(ax)
        if m is None:
            out.append(None)
            continue
        if shape is not None and sizes is not None:
            size = 1
            for a in _axes_of(m):
                size *= sizes[a]
            if shape[i] % size != 0:
                out.append(None)
                continue
        out.append(m)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the counterpart of jax's ``NamedSharding``)."""

    mesh: Any        # a DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(i)`` for the tensor
        dim ``i`` its axis splits, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_axis_sizes(self.mesh):
            dims = [i for i, e in enumerate(self.spec)
                    if e is not None and name in _axes_of(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def split_axes(self, dim: int) -> tuple:
        """The mesh axes that split tensor dim ``dim`` (major first)."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        return () if entry is None else _axes_of(entry)

    def global_shape(self, local_shape: tuple) -> tuple:
        """The whole array's shape, from the shape of one rank's slice."""
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for i, n in enumerate(local_shape):
            for a in self.split_axes(i):
                n *= sizes[a]
            out.append(n)
        return tuple(out)

    def counted_here(self, coordinate) -> bool:
        """Whether the rank at mesh ``coordinate`` holds the copy of its
        slice that a sum over the mesh counts: the one at 0 along every
        mesh axis that does not split the array."""
        used = {a for i in range(len(self.spec)) for a in self.split_axes(i)}
        return all(c == 0 for name, c in zip(mesh_axis_sizes(self.mesh),
                                             coordinate) if name not in used)

    def local_index(self, shape: tuple, coordinate) -> tuple:
        """The slices of a ``shape`` array held at mesh ``coordinate`` (one
        index per mesh dim): each split dim cut into equal parts, its
        axes' coordinates read row-major."""
        sizes = mesh_axis_sizes(self.mesh)
        names = list(sizes)
        index = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            if entry is None:
                index.append(slice(None))
                continue
            part, parts = 0, 1
            for a in _axes_of(entry):
                part = part * sizes[a] + coordinate[names.index(a)]
                parts *= sizes[a]
            size = n // parts
            index.append(slice(part * size, (part + 1) * size))
        return tuple(index)

    def local_shape(self, shape: tuple, coordinate) -> tuple:
        """The shape of the slice of a ``shape`` array held at
        ``coordinate``."""
        return tuple(len(range(*s.indices(n))) for s, n in
                     zip(self.local_index(shape, coordinate), shape))


# ---------------------------------------------------- serving placement ----
def batch_lead(mesh, rules: ShardingRules, n: int):
    """The entry that places ``n`` batch rows: the batch axes where their
    extents divide ``n``, else None (every rank of them holds all the
    rows), as the JAX package's dry run places a serving batch."""
    sizes = mesh_axis_sizes(mesh)
    n_b = 1
    for a in rules.batch_axes:
        n_b *= sizes[a]
    return tuple(rules.batch_axes) if n % n_b == 0 else None


def cache_specs(cache, mesh, rules: ShardingRules = PROD_RULES):
    """Specs of a decode cache (a `DecodeCache` whose leaves are the
    global arrays, or anything with their ``.shape``; ``()`` where a
    family keeps none), in its structure, as the JAX package's
    ``cache_pspecs`` places them: the KV buffers ``(L, B, Smax, KV, hd)``
    with rows over the batch axes and kv heads over the tensor axis where
    its extent divides them, otherwise the *sequence* over the tensor axis
    (each rank holds a run of positions of every kv head); the SSM
    ``conv`` (``(..., B, K-1, conv_dim)``) and ``ssm`` (``(..., B, H, P,
    N)``) states with rows over the batch axes and their inner / head
    dims over the tensor axis by `spec_for`; ``length`` None."""
    m = mesh_axis_sizes(mesh)[rules.tensor_axis]

    def kv(x):
        if isinstance(x, tuple):
            return ()
        _, B, smax, heads, _ = shape = tuple(x.shape)
        if heads % m == 0:
            return spec_for(("layers", "batch", None, "kv_heads", None),
                            rules, shape, mesh)
        if smax % m:
            raise ValueError(
                f"a decode cache of {smax} positions and {heads} kv heads "
                f"splits over neither on a '{rules.tensor_axis}' axis of "
                f"{m}: the sequence split needs max_len a multiple of {m}")
        return (None, batch_lead(mesh, rules, B), rules.tensor_axis, None,
                None)

    ssm = cache.ssm
    if len(ssm):
        lead = ("layers",) * (ssm.conv.ndim - 3)
        ssm = type(ssm)(
            spec_for(lead + ("batch", None, "ssm_inner"), rules,
                     tuple(ssm.conv.shape), mesh),
            spec_for(lead + ("batch", "ssm_heads", None, None), rules,
                     tuple(ssm.ssm.shape), mesh))
    return cache._replace(kv_k=kv(cache.kv_k), kv_v=kv(cache.kv_v), ssm=ssm,
                          length=None)


def tree_shardings(mesh, axes_tree, shape_tree, rules: ShardingRules):
    """A dict tree of logical-axes tuples + a tree of the same structure
    with shapes (tensors or anything with ``.shape``) -> a tree of
    `Sharding`."""
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(mesh, axes_tree[k], shape_tree[k], rules)
                for k in axes_tree}
    return Sharding(mesh, spec_for(axes_tree, rules,
                                   tuple(shape_tree.shape), mesh))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh + rules bundle.  mesh=None turns every constraint into a
    no-op."""

    mesh: Any = None
    rules: ShardingRules = PROD_RULES


NO_SHARD = ShardCtx(mesh=None)


def constrain(x, ctx: ShardCtx, *axes):
    """Place ``x`` by logical axes: the identity without a mesh; a DTensor
    is redistributed to the spec's placements, and a plain tensor (this
    rank's whole array) passes unchanged."""
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(axes, ctx.rules, tuple(x.shape), ctx.mesh)
    return x.redistribute(ctx.mesh, Sharding(ctx.mesh, spec).placements)

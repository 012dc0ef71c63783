"""Logical-axis -> mesh-dim sharding rules over a ``torch.distributed``
device mesh.

Counterpart of ``repro/sharding/api.py``.  The reference names activation
axes logically and lets GSPMD place arrays on a ``jax.sharding.Mesh``; the
port runs SPMD over ``torch.distributed``, one process per mesh position,
on a ``DeviceMesh`` with the same dim names.  A shard is a plain local
tensor: :func:`local_shard` slices this rank's block of a full tensor
(:func:`local_view` without a copy: a rank's MoE expert weights), and
:func:`gather_shards` undoes it with one ``all_gather`` over the whole mesh.
:func:`gather_owned` gathers rows that each rank computed for its own
pairs (the MoE combine).  The reference's ``constrain`` has no
counterpart: every activation is a full local tensor, replicated on each
rank, and the sharded regions (the paged attention block,
``models/attention.py:_shard_paged_attention``; the routed experts,
``models/moe.py``) are sliced and gathered explicitly.

A spec (the counterpart of a ``PartitionSpec``) is a tuple with one entry
per axis: None (replicated), a mesh dim name, or a tuple of names
(composed, the first outermost).  :meth:`MeshRules.pspec` resolves logical
axes to a spec, replicating a dim that the product of its mapped mesh dims
does not divide (MQA's single KV head over a 2-way "model" dim), as the
reference does.

Serving's parameters are replicated but for MoE expert weights, which a
rank holds a block of (``sharding/rules.py:MOE_PARAM_RULES``); the
reference's ``param_rules`` and parameter-tree specs come with training.
Disk records that several ranks would write are written once, by the rank
at the mesh's first position (:func:`is_leader`), which hands its outcome
to the others (:func:`from_leader`).
Collectives use the backend the process group was made with (gloo or
nccl, an explicit choice of its creator).  gloo's support for CUDA tensors
differs between builds, so the collectives here stage a CUDA tensor
through host memory themselves when the backend is gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

_ACTIVE: list["MeshRules"] = []


def mesh_shape(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any                      # torch.distributed DeviceMesh
    axis_map: dict[str, Any]       # logical name -> mesh dim | tuple | None

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    def _mesh_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        shape = self.shape
        return math.prod(shape.get(a, 1) for a in mesh_axes)

    def pspec(self, logical_axes: Sequence[str | None],
              shape: Sequence[int] | None = None) -> tuple:
        """The spec of the given logical axes; with ``shape``, a dim that
        its mesh dims do not divide is replicated."""
        entries = []
        for i, name in enumerate(logical_axes):
            mesh_axes = self.axis_map.get(name) if name else None
            if mesh_axes is not None and shape is not None:
                if shape[i] % self._mesh_size(mesh_axes) != 0:
                    mesh_axes = None          # replicate indivisible dims
            entries.append(mesh_axes)
        return tuple(entries)


def current_rules() -> MeshRules | None:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_rules(rules: MeshRules | None):
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def _block_index(entry, coord: dict[str, int],
                 shape: dict[str, int]) -> tuple[int, int]:
    """``(index, count)`` of this coordinate's block along an axis whose
    spec entry is ``entry``."""
    if entry is None:
        return 0, 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    idx, n = 0, 1
    for name in names:
        size = shape.get(name, 1)
        idx, n = idx * size + coord.get(name, 0), n * size
    return idx, n


def _coordinate(mesh) -> dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def block_index(rules: MeshRules, entry) -> tuple[int, int]:
    """``(index, count)`` of this rank's block along an axis whose spec
    entry is ``entry`` (a mesh dim, a tuple of them, or None)."""
    return _block_index(entry, _coordinate(rules.mesh), rules.shape)


def local_view(rules: MeshRules, x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``, as a view
    of ``x`` (no copy; contiguous where only the leading split axis is
    cut)."""
    coord, shape = _coordinate(rules.mesh), rules.shape
    for axis, entry in enumerate(spec):
        i, n = _block_index(entry, coord, shape)
        if n > 1:
            step = x.shape[axis] // n
            x = x.narrow(axis, i * step, step)
    return x


def local_shard(rules: MeshRules, x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``, as a new
    contiguous tensor (the kernels take contiguous operands)."""
    return local_view(rules, x, spec).contiguous()


_GROUPS: dict[tuple, tuple] = {}


def mesh_group(mesh):
    """``(group, order)``: a process group of every rank of ``mesh`` and,
    for each flat (row-major) mesh position, the group rank there.  A mesh
    over the whole world uses the default group; any other makes its group
    once, which every process of the default group must reach together (as
    SPMD code does)."""
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    key = tuple(ranks)
    if key not in _GROUPS:
        if sorted(ranks) == list(range(dist.get_world_size())):
            group = dist.group.WORLD
        else:
            group = dist.new_group(sorted(ranks))
        order = dist.get_process_group_ranks(group)
        _GROUPS[key] = (group, [order.index(r) for r in ranks])
    return _GROUPS[key]


def collective_device(group=None) -> str:
    """The device type a collective of ``group`` (default: the default
    group) takes its tensors on, and the ``DeviceMesh`` type over it:
    "cuda" for an nccl group, "cpu" for gloo (whatever device its ranks
    compute on)."""
    return "cuda" if dist.get_backend(group) == "nccl" else "cpu"


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on ``x`` stages it through host memory: a CUDA
    tensor under gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def gather_shards(rules: MeshRules, x: torch.Tensor, spec) -> torch.Tensor:
    """Undo :func:`local_shard`: every rank's block ``x`` in one
    ``all_gather`` over the mesh, placed at its coordinates into the full
    tensor.  Ranks that hold the same block (replicated dims) send it each;
    the first one's is used.  Pure data movement, so the result is the bits
    the blocks hold.  With no sharded axis it returns ``x``."""
    mesh, shape = rules.mesh, rules.shape
    dims = list(mesh.mesh_dim_names)
    counts = [_block_index(e, {}, shape)[1] for e in spec]
    if all(n == 1 for n in counts):
        return x
    if x.dtype == torch.bfloat16:
        # Moved as its 16-bit words: gloo builds differ in bf16 support.
        return gather_shards(rules, x.view(torch.int16), spec).view(
            torch.bfloat16)
    group, order = mesh_group(mesh)
    staged = _staged(x, group)
    src = x.cpu() if staged else x.contiguous()
    bufs = [torch.empty_like(src) for _ in order]
    dist.all_gather(bufs, src, group=group)
    full = src.new_empty([s * n for s, n in zip(src.shape, counts)])
    seen = set()
    positions = itertools.product(*(range(shape[d]) for d in dims))
    for flat, pos in enumerate(positions):
        coord = dict(zip(dims, pos))
        idx = tuple(_block_index(e, coord, shape)[0] for e in spec)
        if idx in seen:
            continue
        seen.add(idx)
        at = tuple(slice(i * s, (i + 1) * s) for i, s in zip(idx, src.shape))
        full[at] = bufs[order[flat]]
    return full.to(x.device) if staged else full


def any_rank(rules: MeshRules, flag: bool, dim: str | None = None) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (or of its ``dim``
    group): one ``all_reduce(MAX)``, so every rank takes the same branch."""
    group = (mesh_group(rules.mesh)[0] if dim is None
             else rules.mesh.get_group(dim))
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def gather_owned(rules: MeshRules, x: torch.Tensor, owner: torch.Tensor,
                 dims) -> torch.Tensor:
    """Rows that each rank computed for the entries it owns, put together:
    ``x`` is this rank's ``[*owner.shape, ...]`` tensor, right where this
    rank owns an entry (its block index along ``dims``, a mesh dim or a
    tuple of them, equals ``owner`` there) and anything elsewhere.  One
    ``all_gather`` (:func:`gather_shards` over ``dims`` of ``x`` on a new
    leading axis), then each entry taken from its owner's block: pure data
    movement, so every entry has the bits its owner computed, on every
    rank."""
    spec = (dims,) + (None,) * x.ndim
    every = gather_shards(rules, x[None], spec)       # [n_owners, *x.shape]
    idx = owner.long().reshape((1,) + owner.shape
                               + (1,) * (x.ndim - owner.ndim))
    return torch.gather(every, 0, idx.expand((1,) + tuple(x.shape)))[0]


def is_leader(rules: MeshRules) -> bool:
    """Whether this rank sits at the mesh's first position: the one rank
    that writes a record the whole mesh shares (a snapshot, a prefix-store
    record)."""
    return all(c == 0 for c in _coordinate(rules.mesh).values())


def from_leader(rules: MeshRules, values: Sequence[int]) -> list[int]:
    """The leader's ``values`` on every rank (one ``broadcast`` over the
    mesh; what the others pass is ignored).  A rank past it knows that
    whatever the leader did before the call is done: the collective is a
    barrier too."""
    group, order = mesh_group(rules.mesh)
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=collective_device(group))
    dist.broadcast(t, group=group,
                   src=dist.get_global_rank(group, order[0]))
    return [int(v) for v in t.tolist()]


def write_once(rules: MeshRules | None, write, n: int = 1) -> list[int]:
    """Run ``write()``, which returns its outcome as ``n`` ints, on the
    mesh's leader alone and return that outcome on every rank (one
    :func:`from_leader`, which is also the barrier that makes the write
    visible before any rank reads it).  Without rules it just runs
    ``write()``.  What is written must be whole (the same on every
    rank)."""
    if rules is None:
        return list(write())
    out = list(write()) if is_leader(rules) else [0] * n
    return from_leader(rules, out)

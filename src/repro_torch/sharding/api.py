"""Logical-axis -> mesh-dim sharding rules over a ``torch.distributed``
device mesh.

Counterpart of ``repro/sharding/api.py``.  The reference names activation
axes logically and lets GSPMD place arrays on a ``jax.sharding.Mesh``; the
port runs SPMD over ``torch.distributed``, one process per mesh position,
on a ``DeviceMesh`` with the same dim names.  A shard is a plain local
tensor: :func:`local_shard` slices this rank's block of a full tensor, and
:func:`gather_shards` undoes it with one ``all_gather`` over the whole mesh.
The reference's ``constrain`` has no counterpart: every activation is a
full local tensor, replicated on each rank, and the one sharded region (the
paged attention block, ``models/attention.py:_shard_paged_attention``) is
sliced and gathered explicitly.

A spec (the counterpart of a ``PartitionSpec``) is a tuple with one entry
per axis: None (replicated), a mesh dim name, or a tuple of names
(composed, the first outermost).  :meth:`MeshRules.pspec` resolves logical
axes to a spec, replicating a dim that the product of its mapped mesh dims
does not divide (MQA's single KV head over a 2-way "model" dim), as the
reference does.

Serving has no parameter rules (its parameters are replicated), so the
reference's ``param_rules`` and parameter-tree specs come with training.
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


def local_shard(rules: MeshRules, x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``, as a new
    contiguous tensor (the kernels take contiguous operands)."""
    coord, shape = _coordinate(rules.mesh), rules.shape
    for axis, entry in enumerate(spec):
        i, n = _block_index(entry, coord, shape)
        if n > 1:
            step = x.shape[axis] // n
            x = x.narrow(axis, i * step, step)
    return x.contiguous()


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

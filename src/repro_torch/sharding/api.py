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
pairs (the MoE combine; in training its gradient stays with each
owner).  The reference's ``constrain`` has no counterpart: every
activation is a full local tensor, replicated on each rank, and the
sharded regions (the paged attention block,
``models/attention.py:_shard_paged_attention``; the routed experts,
``models/moe.py``) are sliced and gathered explicitly.

A spec (the counterpart of a ``PartitionSpec``) is a tuple with one entry
per axis: None (replicated), a mesh dim name, or a tuple of names
(composed, the first outermost).  :meth:`MeshRules.pspec` resolves logical
axes to a spec, replicating a dim that the product of its mapped mesh dims
does not divide (MQA's single KV head over a 2-way "model" dim), as the
reference does.

Serving's parameters are replicated but for MoE expert weights, which a
rank holds a block of (``sharding/rules.py:MOE_PARAM_RULES``).  Training's
rules carry the reference's ``param_rules``: :meth:`MeshRules.tree_pspecs`
gives every leaf of a parameter or train-state tree its spec,
:func:`shard_state` cuts a full tree to this rank's blocks and
:func:`gather_state` puts them back together (on every rank, or on the
leader for a checkpoint).  The training forward runs on those blocks
through three autograd collectives: :func:`gather_param` (a weight's
"data" blocks gathered before use; its gradient summed over the batch
dims and cut back to the block), and the Megatron pair
:func:`copy_to_model` / :func:`reduce_from_model`; MoE gathers every data
rank's routing ids (:func:`batch_gather`) and sums its expert counts
(:func:`batch_sum`), integers with no gradient.  Every sum over ranks
is an ``all_gather`` followed by a sum in mesh order (an ``all_to_all`` of
each rank's block where a rank keeps only its block of the sum, a
gradient under :func:`gather_param`), so every rank holds the same bits
and a run repeats.
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
import functools
import itertools
import math
import re
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist

_ACTIVE: list["MeshRules"] = []

# The type bf16 tensors take on the wire (their bits, reinterpreted).
WIRE_16 = torch.float16

# Wall seconds this process has spent in the torch.distributed calls of
# this module's collectives (host staging copies are outside it): read it
# before and after a step to time the step's collectives.
COLLECTIVE_S = 0.0


def _collective(fn, *args, **kw):
    """``fn(*args, **kw)``, a torch.distributed call, its wall time added
    to ``COLLECTIVE_S``."""
    global COLLECTIVE_S
    t = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        COLLECTIVE_S += time.perf_counter() - t


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh dims without ranks (the reference's ``AbstractMesh``): enough
    for layouts (:meth:`MeshRules.tree_pspecs`), no collective."""
    shape_tuple: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def mesh_shape(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape_tuple))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any                      # torch.distributed DeviceMesh
    axis_map: dict[str, Any]       # logical name -> mesh dim | tuple | None
    # (path regex, logical axes): training's parameter rules
    param_rules: tuple[tuple[str, tuple], ...] = ()

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

    # -- parameter trees ----------------------------------------------------

    def param_pspec(self, path: str, shape: Sequence[int]) -> tuple:
        """The spec of the leaf at ``path`` ("/"-joined): the first rule
        whose pattern it matches, with unsplit axes prepended where the
        leaf has more dims than the rule names (a stacked layer axis);
        ``()`` where no rule matches."""
        for pattern, axes in self.param_rules:
            if re.search(pattern, path):
                if len(shape) > len(axes):
                    axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
                return self.pspec(axes, shape)
        return ()

    def tree_pspecs(self, tree, prefix: str = ""):
        """The spec of every leaf of a tree of nested dicts and lists, by
        its "/"-joined path (list items by index): ``opt/m/.../attn/wq/w``
        matches the parameter's pattern, so moments split as their
        parameter does.  Leaves are read for their shape only."""
        if isinstance(tree, dict):
            return {k: self.tree_pspecs(v, f"{prefix}{k}/")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.tree_pspecs(v, f"{prefix}{i}/")
                    for i, v in enumerate(tree)]
        return self.param_pspec(prefix[:-1], tuple(tree.shape))


def splits_model(rules: MeshRules, entry) -> bool:
    """Whether a spec entry puts its axis over a "model" dim of more than
    one rank."""
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return "model" in names and rules.shape.get("model", 1) > 1


def model_split(rules: MeshRules, path: str, shape: Sequence[int],
                axis: int) -> bool:
    """Whether training's ``rules`` split axis ``axis`` of the parameter
    at ``path`` (its full ``shape``) over "model": the spec
    :meth:`MeshRules.param_pspec` gives it, which is also the spec a
    rank's block of it was cut by.  A layer asks this of its weights to
    choose Megatron's split, so the split it runs and the blocks it holds
    are one decision."""
    return splits_model(rules, rules.param_pspec(path, shape)[axis])


def training_rules() -> "MeshRules | None":
    """The active rules if they are training's (they carry parameter
    rules), else None: the training forward splits its layers under them,
    and under serving's rules or none it runs as on one device."""
    rules = current_rules()
    return rules if rules is not None and rules.param_rules else None


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


def _place(bufs, order, spec, shape, dims, src):
    """The full tensor from every mesh position's block (``bufs`` in group
    rank order): each block at its coordinates; where ranks hold the same
    block (replicated dims), the first one's."""
    counts = [_block_index(e, {}, shape)[1] for e in spec]
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
    return full


def gather_shards(rules: MeshRules, x: torch.Tensor, spec) -> torch.Tensor:
    """Undo :func:`local_shard`: every rank's block ``x`` in one
    ``all_gather`` over the mesh, placed at its coordinates into the full
    tensor.  Ranks that hold the same block (replicated dims) send it each;
    the first one's is used.  Pure data movement, so the result is the bits
    the blocks hold.  With no sharded axis it returns ``x``."""
    mesh, shape = rules.mesh, rules.shape
    counts = [_block_index(e, {}, shape)[1] for e in spec]
    if all(n == 1 for n in counts):
        return x
    if x.dtype == torch.bfloat16:
        # Moved as its 16-bit words in a type every gloo build carries
        # (bf16 and int16 support differ between builds); a collective
        # that only moves data keeps the bits.
        return gather_shards(rules, x.view(WIRE_16), spec).view(
            torch.bfloat16)
    group, order = mesh_group(mesh)
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    bufs = [torch.empty_like(src) for _ in order]
    _collective(dist.all_gather, bufs, src, group=group)
    full = _place(bufs, order, spec, shape, list(mesh.mesh_dim_names), src)
    return full.to(x.device) if staged else full


def gather_to_leader(rules: MeshRules, x: torch.Tensor, spec,
                     to_host: bool = False):
    """:func:`gather_shards` onto the leader alone (one ``gather``): the
    full tensor there, None on every other rank; with ``to_host`` in host
    memory (never whole on the leader's device).  With no sharded axis
    nothing moves."""
    mesh, shape = rules.mesh, rules.shape
    counts = [_block_index(e, {}, shape)[1] for e in spec]
    if all(n == 1 for n in counts):
        if not is_leader(rules):
            return None
        return x.detach().cpu() if to_host else x
    if x.dtype == torch.bfloat16:
        full = gather_to_leader(rules, x.view(WIRE_16), spec, to_host)
        return None if full is None else full.view(torch.bfloat16)
    group, order = mesh_group(mesh)
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    lead = is_leader(rules)
    bufs = [torch.empty_like(src) for _ in order] if lead else None
    _collective(dist.gather, src, bufs, group=group,
                dst=dist.get_global_rank(group, order[0]))
    if not lead:
        return None
    full = _place(bufs, order, spec, shape, list(mesh.mesh_dim_names), src)
    if to_host:
        return full.cpu()
    return full.to(x.device) if staged else full


def any_rank(rules: MeshRules, flag: bool, dim: str | None = None) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (or of its ``dim``
    group): one ``all_reduce(MAX)``, so every rank takes the same branch."""
    group = (mesh_group(rules.mesh)[0] if dim is None
             else rules.mesh.get_group(dim))
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=collective_device(group))
    _collective(dist.all_reduce, t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


class _GatherOwned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, owner, dims):
        idx, _ = block_index(rules, dims)
        ctx.save_for_backward(owner == idx)
        if isinstance(dims, str):
            every = dim_all_gather(rules.mesh, x, dims)
        else:
            spec = (dims,) + (None,) * x.ndim
            every = gather_shards(rules, x[None], spec)
        at = owner.long().reshape((1,) + owner.shape
                                  + (1,) * (x.ndim - owner.ndim))
        return torch.gather(every, 0, at.expand((1,) + tuple(x.shape)))[0]

    @staticmethod
    def backward(ctx, g):
        mine, = ctx.saved_tensors
        mine = mine.reshape(mine.shape + (1,) * (g.ndim - mine.ndim))
        return g * mine, None, None, None


def gather_owned(rules: MeshRules, x: torch.Tensor, owner: torch.Tensor,
                 dims) -> torch.Tensor:
    """Rows that each rank computed for the entries it owns, put together:
    ``x`` is this rank's ``[*owner.shape, ...]`` tensor, right where this
    rank owns an entry (its block index along ``dims``, a mesh dim or a
    tuple of them, equals ``owner`` there) and anything elsewhere.  The
    ranks that differ from this one along ``dims`` alone send their ``x``
    (one ``all_gather`` over the dim's group; over the whole mesh for a
    tuple of dims, whose ranks must then hold the same entries) and each
    entry is taken from its owner's: pure data movement, so every entry has
    the bits its owner computed, on every rank.  In backward each owner
    keeps its own entries' gradient: the result is the same on every rank
    of the group, and so is the gradient that reaches it (a training step's
    replicated activations), so no rank needs another's."""
    return _GatherOwned.apply(x, rules, owner, dims)


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
    _collective(dist.broadcast, t, group=group,
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


# ---------------------------------------------------------------------------
# Training: state trees, per-dim collectives and the autograd collectives
# ---------------------------------------------------------------------------


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def shard_state(rules: MeshRules, tree, specs=None):
    """This rank's block of every leaf of a full tree (host or device;
    parameters, moments, error feedback, a 0-d step), by
    :meth:`MeshRules.tree_pspecs` of the tree unless ``specs`` are given.
    Every leaf is a new tensor, detached, on the leaf's device: a rank that
    received the full tree by shared memory or CUDA IPC updates its own
    copy, never the sender's."""
    specs = rules.tree_pspecs(tree) if specs is None else specs
    return _tree_map(lambda x, spec: local_view(rules, x.detach(), spec)
                     .clone(memory_format=torch.contiguous_format),
                     tree, specs)


def gather_state(rules: MeshRules, tree, specs, leader_only: bool = False):
    """The inverse of :func:`shard_state`: the full tree on every rank (one
    ``all_gather`` a split leaf), or with ``leader_only`` on the leader
    alone in host memory (one ``gather`` a split leaf, each moved to the
    host as it arrives, so the leader's device holds one whole leaf at
    most; None on the other ranks), as a checkpoint is written.  Pure data
    movement: the leaves hold the blocks' bits."""
    if not leader_only:
        return _tree_map(lambda x, spec: gather_shards(rules, x, spec),
                         tree, specs)
    out = _tree_map(lambda x, spec: gather_to_leader(rules, x, spec,
                                                     to_host=True),
                    tree, specs)
    return out if is_leader(rules) else None


def holds_first_copy(rules: MeshRules, spec) -> bool:
    """Whether this rank holds the first copy of its block of a leaf with
    ``spec``: its coordinate is 0 along every mesh dim the spec does not
    split.  Summing over such ranks counts each block once."""
    used = set()
    for e in spec:
        if e is not None:
            used.update((e,) if isinstance(e, str) else e)
    return all(c == 0 for d, c in _coordinate(rules.mesh).items()
               if d not in used)


def batch_dims(rules: MeshRules) -> tuple[str, ...]:
    """The mesh dims the batch is split over (outermost first), of more
    than one rank."""
    entry = rules.axis_map.get("batch")
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(d for d in names if rules.shape.get(d, 1) > 1)


def _dim_group(mesh, dim: str):
    """``(group, order)`` of this rank's group along mesh dim ``dim``: its
    process group (``DeviceMesh`` made it with the mesh) and, for each
    coordinate along the dim, the group rank there."""
    group = mesh.get_group(dim)
    at: list = list(mesh.get_coordinate())
    at[list(mesh.mesh_dim_names).index(dim)] = slice(None)
    along = mesh.mesh[tuple(at)]
    members = dist.get_process_group_ranks(group)
    return group, [members.index(int(r)) for r in along.tolist()]


def dim_all_gather(mesh, x: torch.Tensor, dim: str) -> torch.Tensor:
    """Every block ``x`` of this rank's group along mesh dim ``dim``,
    stacked in coordinate order on a new leading axis, on ``x``'s device
    (one ``all_gather``; through host memory for a CUDA tensor under
    gloo).  Pure data movement."""
    n = mesh_shape(mesh)[dim]
    if n == 1:
        return x[None]
    if x.dtype == torch.bfloat16:
        return dim_all_gather(mesh, x.view(WIRE_16), dim).view(
            torch.bfloat16)
    group, order = _dim_group(mesh, dim)
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    buf = src.new_empty((n,) + tuple(src.shape))
    _collective(dist.all_gather, list(buf.unbind(0)), src, group=group)
    if order != list(range(n)):
        buf = buf[torch.tensor(order)]
    return buf.to(x.device) if staged else buf


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right."""
    return functools.reduce(torch.add, parts.unbind(0))


def _cut(x: torch.Tensor, cuts) -> torch.Tensor:
    for axis, start, length in cuts:
        x = x.narrow(axis, start, length)
    return x


def dim_all_to_all(mesh, parts: list, dim: str) -> list:
    """``parts[c]`` (one shape for every ``c``) sent to the rank at
    coordinate ``c`` along mesh dim ``dim``: what every rank of the group
    sent this one, in coordinate order, this rank's own part as it was
    (one ``all_to_all`` of the others; through host memory for a CUDA
    tensor under gloo).  Pure data movement."""
    x = parts[0]
    if x.dtype == torch.bfloat16:
        got = dim_all_to_all(mesh, [t.view(WIRE_16) for t in parts], dim)
        return [t.view(torch.bfloat16) for t in got]
    group, order = _dim_group(mesh, dim)
    me = _coordinate(mesh)[dim]
    ranked = sorted(range(len(parts)), key=order.__getitem__)
    others = [c for c in ranked if c != me]           # in group rank order
    staged = _staged(x, group)
    if staged:
        src = torch.empty((len(others),) + tuple(x.shape), dtype=x.dtype)
        for i, c in enumerate(others):
            src[i].copy_(parts[c])
    else:
        src = torch.stack([parts[c] for c in others])
    buf = torch.empty_like(src)
    sizes = [int(c != me) for c in ranked]            # rows of src and buf
    _collective(dist.all_to_all_single, buf, src, sizes, sizes, group=group)
    if staged:
        buf = buf.to(x.device)
    got = dict(zip(others, buf.unbind(0)))
    return [parts[c] if c == me else got[c] for c in range(len(parts))]


def dim_sum(mesh, x: torch.Tensor, dim: str, cuts=None) -> torch.Tensor:
    """The sum over this rank's group along mesh dim ``dim`` of ``x``, in
    coordinate order, the same bits on every rank of the group.  With
    ``cuts`` (for each coordinate along the dim, the ``(axis, start,
    length)`` cuts, each within the last, of the block the rank there
    keeps of a reduced gradient) only this rank's block is summed, and a
    rank sends each other only that one's block of ``x``
    (:func:`dim_all_to_all`): a reduce-scatter in a fixed order."""
    if cuts is None:
        return _sum_in_order(dim_all_gather(mesh, x, dim))
    if mesh_shape(mesh)[dim] == 1:
        return _cut(x, cuts[0])
    return functools.reduce(torch.add, dim_all_to_all(
        mesh, [_cut(x, c) for c in cuts], dim))


def dim_max(mesh, x: torch.Tensor, dim: str) -> torch.Tensor:
    """The elementwise max over this rank's group along ``dim``."""
    return dim_all_gather(mesh, x, dim).amax(0)


def mesh_sum(rules: MeshRules, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank of the mesh, in flat mesh order
    (one ``all_gather``), the same bits on every rank."""
    group, order = mesh_group(rules.mesh)
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    buf = src.new_empty((len(order),) + tuple(src.shape))
    _collective(dist.all_gather, list(buf.unbind(0)), src, group=group)
    out = _sum_in_order(buf[torch.tensor(order)])
    return out.to(x.device) if staged else out


def batch_sum(rules: MeshRules, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the batch dims (no gradient): a global token
    count, the loss summed over data ranks."""
    for d in batch_dims(rules):
        x = dim_sum(rules.mesh, x, d)
    return x


def batch_gather(rules: MeshRules, x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` (no gradient: routing ids) concatenated on
    its first axis in batch-block order, on every rank: for this rank's
    rows of the batch, the whole batch's rows in one device's order."""
    return _gather_axis(rules.mesh, x, batch_dims(rules), 0)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dim_sum(ctx.mesh, g, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return dim_sum(mesh, x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """Enter a Megatron region: the identity forward; backward sums the
    gradient over "model" (each rank's region saw its own heads, hidden
    units or vocab rows of the same input)."""
    if rules.shape.get("model", 1) == 1:
        return x
    return _CopyToModel.apply(x, rules.mesh)


def reduce_from_model(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """Leave a Megatron region: forward sums the partial products over
    "model" in rank order (the same bits on every rank); backward is the
    identity."""
    if rules.shape.get("model", 1) == 1:
        return x
    return _ReduceFromModel.apply(x, rules.mesh)


# -- sequence parallelism ---------------------------------------------------


def seq_parallel(rules: MeshRules | None) -> bool:
    """Whether ``rules`` split the residual stream's sequence over a
    "model" dim of more than one rank (``make_rules(sequence_parallel=
    True)``; :func:`seq_rules` turns it off where "model" does not divide
    the sequence)."""
    return (rules is not None and rules.axis_map.get("seq") == "model"
            and rules.shape.get("model", 1) > 1)


def seq_rules(rules: MeshRules, seq_len: int | None) -> MeshRules:
    """``rules`` for a stream of ``seq_len`` positions: the sequence stays
    whole where "model" does not divide it, as :meth:`MeshRules.pspec`
    replicates an indivisible dim, and where ``seq_len`` is None."""
    if seq_parallel(rules) and (seq_len is None or rules.pspec(
            ("seq",), (seq_len,))[0] is None):
        return dataclasses.replace(rules, axis_map=dict(rules.axis_map,
                                                        seq=None))
    return rules


def _gather_axis(mesh, x: torch.Tensor, dims, axis: int) -> torch.Tensor:
    """Every rank's ``x`` along the mesh dims ``dims`` (outermost first),
    concatenated on ``axis`` in coordinate order (pure data movement)."""
    for d in reversed(dims):                          # innermost first
        x = torch.cat(dim_all_gather(mesh, x, d).unbind(0), axis)
    return x


def _scatter_axis(mesh, x: torch.Tensor, dims, axis: int) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``dims``, cut on ``axis`` to
    this rank's part (a reduce-scatter in a fixed order): the adjoint of
    :func:`_gather_axis`."""
    shape = mesh_shape(mesh)
    for d in dims:                                    # outermost first
        n = shape[d]
        part = x.shape[axis] // n
        x = dim_sum(mesh, x, d, [[(axis, c * part, part)]
                                 for c in range(n)])
    return x.contiguous()


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, axis):
        ctx.args = (mesh, dims, axis)
        return _gather_axis(mesh, x, dims, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, axis = ctx.args
        return _scatter_axis(mesh, g, dims, axis), None, None, None


class _ScatterAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, axis):
        ctx.args = (mesh, dims, axis)
        return _scatter_axis(mesh, x, dims, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, axis = ctx.args
        return _gather_axis(mesh, g, dims, axis), None, None, None


def seq_gather(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """This rank's part ``[B, S / model, ...]`` of the stream -> the whole
    sequence (an all-gather over "model"); backward sums each rank's
    gradient of the whole sequence and keeps this rank's part (a
    reduce-scatter in rank order)."""
    return _GatherAxis.apply(x, rules.mesh, ("model",), 1)


def seq_scatter(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """A partial sum over "model" of the whole sequence -> this rank's part
    of its sum (a reduce-scatter in rank order); backward all-gathers the
    parts' gradients."""
    return _ScatterAxis.apply(x, rules.mesh, ("model",), 1)


def seq_part(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """This rank's part of a sequence every "model" rank holds whole (a
    slice; its gradient is this rank's part's alone)."""
    n = rules.shape["model"]
    length = x.shape[1] // n
    return x.narrow(1, block_index(rules, "model")[0] * length, length)


def enter_model(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """Enter a Megatron region: :func:`copy_to_model`, except under
    sequence parallelism, where the input is the gathered sequence and the
    gather's backward already sums the ranks' gradients."""
    return x if seq_parallel(rules) else copy_to_model(x, rules)


def leave_model(y: torch.Tensor, rules: MeshRules | None,
                partial: bool = True) -> torch.Tensor:
    """Leave a block's mixer or FFN under training's ``rules``: a
    ``partial`` sum over "model" is summed (:func:`reduce_from_model`), a
    result whole on every rank stays as it is; under sequence parallelism
    each becomes this rank's part of the sequence (:func:`seq_scatter`,
    :func:`seq_part`)."""
    if rules is None:
        return y
    if seq_parallel(rules):
        return seq_scatter(y, rules) if partial else seq_part(y, rules)
    return reduce_from_model(y, rules) if partial else y


def gather_rows(rules: MeshRules, x: torch.Tensor, dims) -> torch.Tensor:
    """The rows of ``x`` of every rank along the batch dims ``dims``
    (outermost first) on each of them, in batch order (as
    :func:`batch_gather` puts them), with a gradient: backward sums each
    rank's gradient of those rows over ``dims`` and keeps this rank's rows
    (a reduce-scatter)."""
    return _GatherAxis.apply(x, rules.mesh, tuple(dims), 0)


def scatter_rows(rules: MeshRules, x: torch.Tensor, dims) -> torch.Tensor:
    """The adjoint of :func:`gather_rows`: a partial sum over ``dims`` of
    the rows it put together -> this rank's rows of the sum (a
    reduce-scatter); backward all-gathers the rows' gradients."""
    return _ScatterAxis.apply(x, rules.mesh, tuple(dims), 0)


class _GatherParam(torch.autograd.Function):
    """A weight's blocks gathered over ``gather`` (per axis, the mesh dims
    to gather, outermost first) before use; backward sums the gradient over
    the ``reduce`` dims, in order, and keeps this rank's block."""

    @staticmethod
    def forward(ctx, w, mesh, gather, reduce):
        ctx.mesh, ctx.gather, ctx.reduce = mesh, gather, reduce
        for axis, dims in enumerate(gather):
            w = _gather_axis(mesh, w, dims, axis)
        return w

    @staticmethod
    def backward(ctx, g):
        coord, shape = _coordinate(ctx.mesh), mesh_shape(ctx.mesh)

        def cuts(at, dims_now, x):
            # The block along ``dims_now`` that the rank at coordinates
            # ``at`` keeps of ``x``, each cut within the last.
            out, size = [], list(x.shape)
            for axis, dims in enumerate(ctx.gather):
                for d in dims:                        # outermost first
                    if d in dims_now:
                        size[axis] //= shape[d]
                        out.append((axis, at[d] * size[axis], size[axis]))
            return out

        # Sum over the reduce dims in order.  A gathered dim is cut at the
        # first sum after which no later sum runs over it (a reduce-scatter
        # where the sum runs over that dim itself), so every rank sums only
        # the blocks that its peers along the summed dim share with it.
        pending = {d for dims in ctx.gather for d in dims}
        for i, d in enumerate(ctx.reduce):
            now = pending - set(ctx.reduce[i + 1:])
            g = dim_sum(ctx.mesh, g, d, [cuts(coord | {d: c}, now, g)
                                         for c in range(shape[d])]
                        if now else None)
            pending -= now
        if pending:
            g = _cut(g, cuts(coord, pending, g))
        return g.contiguous(), None, None, None


def gather_param(rules: MeshRules, w: torch.Tensor, spec,
                 gather_model: bool = False,
                 sum_model: bool = False) -> torch.Tensor:
    """Training's use of this rank's block ``w`` of a weight with ``spec``:
    its blocks over every dim but "model" all-gathered (FSDP), and over
    "model" too with ``gather_model`` (a weight a replicated layer reads
    whole); in backward the gradient is summed over the batch dims (each
    data rank's tokens), and over "model" with ``sum_model`` (a whole
    weight inside a Megatron region, whose gradient each rank has for its
    own heads only; under sequence parallelism every weight not split
    over "model", whose gradient each rank has for its own part of the
    sequence), then cut back to the block.  A leaf with nothing to gather
    still sums its gradient over the batch dims."""
    shape = rules.shape
    gather = []
    for e in spec:
        names = () if e is None else ((e,) if isinstance(e, str) else e)
        gather.append(tuple(d for d in names if shape.get(d, 1) > 1 and
                            (d != "model" or gather_model)))
    reduce = batch_dims(rules) + (
        ("model",) if sum_model and shape.get("model", 1) > 1 else ())
    if not reduce and not any(gather):
        return w
    return _GatherParam.apply(w, rules.mesh, tuple(gather), reduce)


def held_param(rules: MeshRules, w: torch.Tensor, spec) -> torch.Tensor:
    """Training's use of a weight that each rank uses as held (resident
    experts, whose rank sees every row of the batch dims its ``spec`` lies
    on): nothing gathered; in backward the gradient is summed over the
    batch dims ``spec`` does not lie on (an outer "pod", whose ranks hold
    the same block and see other rows)."""
    held = {d for e in spec if e is not None
            for d in ((e,) if isinstance(e, str) else e)}
    reduce = tuple(d for d in batch_dims(rules) if d not in held)
    if not reduce:
        return w
    return _GatherParam.apply(w, rules.mesh, ((),) * w.dim(), reduce)

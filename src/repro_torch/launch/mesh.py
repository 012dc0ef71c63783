"""Device meshes over ``torch.distributed``, and ranks to run them.

Counterpart of ``repro/launch/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over the devices one controller sees; the port runs
one process per mesh position (SPMD), so a mesh needs an initialized
process group first.  :func:`make_debug_mesh` builds the ("data", "model")
``DeviceMesh`` over it (or ("pod", "data", "model")),
:func:`make_production_mesh` the reference's (16, 16) or (2, 16, 16)
production mesh over a world of that size (a ``torchrun`` launch);
:func:`start_mesh` / :func:`spawn_mesh` start ``data x model`` ranks
(``pod x data x model``), each with its process group (a ``file://``
rendezvous, so no port is picked), its mesh and its device, run a function
there and hand back each rank's result.

Tensors in a job's arguments reach the ranks by shared memory (CUDA IPC
for a card's), so the ranks hold no copy of the weights; a rank's engine
keeps views of its block of the routed MoE experts
(``sharding/rules.py:shard_params``), and only that block is its to read.

Backends are explicit: ``gloo`` runs anywhere, several ranks sharing one
CUDA card included (its collectives stage through host memory,
``sharding/api.py``); ``nccl`` needs a card per rank.  Every process group
gets a timeout, so ranks whose host decisions diverge fail instead of
waiting in a collective for ever.  A CPU rank runs one torch intra-op
thread: at reduced widths torch's thread pool costs many times the work on
a shared CPU, and ranks share the host's cores.
"""

from __future__ import annotations

import datetime
import gc
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding.api import collective_device

PG_TIMEOUT_S = 60.0


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 1):
    """A (data, model) ``DeviceMesh`` over the initialized default process
    group, whose world it must fill, or (pod, data, model) with ``pod`` >
    1; its device type follows the group's backend
    (``sharding/api.py:collective_device``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if pod > 1:
        return init_device_mesh(collective_device(), (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(collective_device(), (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(multi_pod: bool = False):
    """The reference's production mesh over the initialized default process
    group: (data=16, model=16), 256 ranks, or with ``multi_pod`` (pod=2,
    data=16, model=16), 512 ranks ("pod" the outer data dim).  The world
    must be exactly that size (``torchrun --nproc-per-node`` over the
    hosts); anything else raises ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if not dist.is_initialized():
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs an "
            f"initialized process group of {n} ranks (a torchrun launch); "
            f"none is initialized")
    if dist.get_world_size() != n:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs {n} "
            f"ranks; this world has {dist.get_world_size()}")
    return init_device_mesh(collective_device(), shape,
                            mesh_dim_names=names)


def _rank_device(device: str, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or card ``rank`` mod
    the cards there are (several ranks share one card under gloo)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, shape, device, backend, workdir, box):
    # ``box`` is a one-item list holding ``fn``'s arguments.  The process
    # object keeps its arguments until the interpreter exits, so taking
    # them out of the box is what lets this rank free the parent's CUDA
    # tensors (CUDA IPC) before it exits: a consumer that exits holding
    # them leaves the parent's shared blocks counted as in use.
    args = box.pop()
    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=shape[0] * shape[1] * shape[2],
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_debug_mesh(*shape)
        result = fn(mesh, dev, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        del args
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
        dist.destroy_process_group()


class MeshJob:
    """Ranks started by :func:`start_mesh`; :meth:`join` waits for them."""

    def __init__(self, ctx, workdir: str, n: int, deadline: float):
        self._ctx, self._workdir, self._n = ctx, workdir, n
        self._deadline = deadline

    def running(self) -> bool:
        """Whether any rank is still running."""
        return any(p.is_alive() for p in self._ctx.processes)

    def join(self) -> list:
        """Each rank's result, in rank order.  A rank's exception is raised
        here; past the deadline every rank is killed and TimeoutError
        raised."""
        try:
            while not self._ctx.join(
                    timeout=max(0.0, self._deadline - time.monotonic())):
                if time.monotonic() >= self._deadline:
                    raise TimeoutError(
                        "mesh ranks still running at their time limit")
            return [torch.load(os.path.join(self._workdir, f"rank{r}.pt"),
                               weights_only=False) for r in range(self._n)]
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            shutil.rmtree(self._workdir, ignore_errors=True)
            if torch.cuda.is_initialized():
                # Free what the ranks shared and have released.
                torch.cuda.ipc_collect()


def start_mesh(fn, data: int, model: int, *, device: str, backend: str,
               args: tuple = (), timeout: float = 120.0,
               pod: int = 1) -> MeshJob:
    """Start ``data x model`` ranks (``pod x data x model`` with ``pod``,
    :func:`make_debug_mesh`) on ``device`` ("cpu" or "cuda"), their
    collectives over ``backend`` ("gloo" or "nccl"), each running
    ``fn(mesh, device, *args)``; ``fn`` must be importable (a module-level
    function), and its result picklable.  Tensors in ``args`` reach the
    ranks through shared memory (CUDA IPC for a card's tensors, which the
    caller keeps alive until :meth:`MeshJob.join` returns; each rank frees
    them before it exits).  ``timeout`` bounds the whole job,
    ``PG_TIMEOUT_S`` each collective."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo|nccl, got {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu|cuda, got {device!r}")
    workdir = tempfile.mkdtemp(prefix="mesh-")
    n = pod * data * model
    ctx = mp.start_processes(
        _rank_main,
        args=(fn, (data, model, pod), device, backend, workdir, [args]),
        nprocs=n, join=False, start_method="spawn")
    return MeshJob(ctx, workdir, n, time.monotonic() + timeout)


def spawn_mesh(fn, data: int, model: int, *, device: str, backend: str,
               **kw) -> list:
    """:func:`start_mesh` and wait: each rank's result, in rank order."""
    return start_mesh(fn, data, model, device=device, backend=backend,
                      **kw).join()

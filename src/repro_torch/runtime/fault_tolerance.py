"""Fault tolerance policies: heartbeats, elastic re-meshing decisions,
stragglers and the serving stuck-tick watchdog.

Counterpart of ``repro/runtime/fault_tolerance.py``.  Failures are injected
(``inject_failure``), which drives the same code path a heartbeat service
would.  Every class takes its clock as an argument, so tests drive it with a
:class:`~repro_torch.runtime.clock.ManualClock`.

* :class:`ClusterMonitor`: a node missing ``timeout`` seconds of beats is
  declared failed.
* :class:`ElasticMeshManager`: the largest (data, model) mesh the surviving
  devices hold, keeping the model-parallel degree, the
  ``torch.distributed`` ``DeviceMesh`` over the surviving ranks, and a
  host tree resharded onto it with training's rules
  (:meth:`ElasticMeshManager.reshard`).
* :class:`StragglerPolicy`: a per-step deadline from an EMA of step times,
  and a deterministic donor for a straggler's data shard.
* :class:`EngineWatchdog`: wraps ``PagedEngine.step()`` and raises
  :class:`StuckTickError` when a tick blows past the EMA deadline.  It
  lives here, not in ``serving/``, because it is the one component of the
  serving stack that reads a clock.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding.api import collective_device


class ClusterMonitor:
    def __init__(self, n_nodes: int, timeout: float = 30.0,
                 clock=time.monotonic):
        self.n_nodes = n_nodes
        self.timeout = timeout
        self._clock = clock
        now = self._clock()
        self._last_beat = {i: now for i in range(n_nodes)}
        self._failed: set[int] = set()

    def heartbeat(self, node: int, t: float | None = None):
        if node not in self._failed:
            self._last_beat[node] = t if t is not None else self._clock()

    def inject_failure(self, node: int):
        self._failed.add(node)
        self._last_beat[node] = -float("inf")

    def recover(self, node: int):
        self._failed.discard(node)
        self._last_beat[node] = self._clock()

    def failed_nodes(self, now: float | None = None) -> set[int]:
        now = now if now is not None else self._clock()
        out = set(self._failed)
        for node, beat in self._last_beat.items():
            if now - beat > self.timeout:
                out.add(node)
        return out

    def healthy_count(self) -> int:
        return self.n_nodes - len(self.failed_nodes())


@dataclasses.dataclass
class ElasticDecision:
    data: int
    model: int
    dropped_nodes: int

    @property
    def devices(self) -> int:
        return self.data * self.model


class ElasticMeshManager:
    """Largest valid mesh from surviving devices, preserving the TP degree."""

    def __init__(self, model_parallel: int, devices_per_node: int = 4):
        self.model_parallel = model_parallel
        self.devices_per_node = devices_per_node

    def decide(self, healthy_nodes: int) -> ElasticDecision:
        devices = healthy_nodes * self.devices_per_node
        tp = self.model_parallel
        if devices < tp:
            raise RuntimeError(
                f"{devices} devices cannot host model-parallel degree {tp}")
        data = devices // tp
        return ElasticDecision(data=data, model=tp, dropped_nodes=0)

    def rebuild_mesh(self, decision: ElasticDecision, ranks=None):
        """A (data, model) ``DeviceMesh`` over the first ``data x model``
        surviving ranks (``ranks``, by default every rank of the
        initialized default process group), row-major as the reference
        lays out its devices, of the device type the group's backend
        takes (``sharding/api.py:collective_device``).  Building it makes
        the mesh's process groups, so every rank of the default group calls
        it together; a rank left out gets a mesh it is not part of.  A
        ``PagedEngine`` on the rebuilt mesh restores a snapshot taken on
        the larger one: snapshots are whole, and each rank takes its KV
        heads of the scales."""
        if not dist.is_initialized():
            raise RuntimeError(
                "rebuild_mesh needs the ranks' torch.distributed process "
                "group (init_process_group, or launch/mesh.py:start_mesh)")
        ranks = list(range(dist.get_world_size()) if ranks is None
                     else ranks)
        usable = decision.data * decision.model
        if usable > len(ranks):
            raise RuntimeError(
                f"a {decision.data}x{decision.model} mesh needs {usable} "
                f"ranks, {len(ranks)} survive")
        grid = torch.tensor(ranks[:usable]).reshape(decision.data,
                                                    decision.model)
        return DeviceMesh(collective_device(), grid,
                          mesh_dim_names=("data", "model"))

    @staticmethod
    def reshard(mesh, host_tree, n_routed: int = 0):
        """This rank's blocks of a full (host) tree on the rebuilt
        ``mesh`` under training's rules (``sharding/rules.py:make_rules``),
        as the reference re-places a host tree after a re-mesh; None on a
        rank the mesh left out.  Local slicing: no collective."""
        from repro_torch.sharding.api import shard_state
        from repro_torch.sharding.rules import make_rules
        if mesh.get_coordinate() is None:
            return None
        return shard_state(make_rules(mesh, n_routed=n_routed), host_tree)


class StragglerPolicy:
    """EMA-deadline detection and deterministic shard reassignment."""

    def __init__(self, slack: float = 2.5, ema_alpha: float = 0.1):
        self.slack = slack
        self.ema_alpha = ema_alpha
        self.ema: float | None = None

    def observe(self, step_time: float):
        if self.ema is None:
            self.ema = step_time
        else:
            self.ema = ((1 - self.ema_alpha) * self.ema
                        + self.ema_alpha * step_time)

    def deadline(self) -> float | None:
        return None if self.ema is None else self.slack * self.ema

    def is_straggler(self, step_time: float) -> bool:
        d = self.deadline()
        return d is not None and step_time > d

    @staticmethod
    def reassign_shard(failed_shard: int, healthy_shards: list[int],
                       step: int) -> int:
        """Deterministic donor for a straggler's data shard: every host
        agrees without communication (a pure function of the step and the
        failed shard)."""
        return healthy_shards[(failed_shard + step) % len(healthy_shards)]


class StuckTickError(RuntimeError):
    """A serving engine tick exceeded the watchdog's EMA deadline (a hung
    kernel, a wedged allocator loop): the supervisor's cue to kill the
    process and restore from the latest crash snapshot."""


class EngineWatchdog:
    """Stuck-tick watchdog for a serving engine.

    Each ``engine.step()`` is timed on the injected clock, compared with
    the policy's deadline (``slack * ema``) and then fed to its EMA.
    ``warmup`` ticks are observed but never flagged: the first ticks of a
    serve build kernels and warm caches, and must seed the EMA without
    tripping it."""

    def __init__(self, engine, policy: StragglerPolicy | None = None,
                 clock=time.monotonic, warmup: int = 8):
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.engine = engine
        self.policy = policy if policy is not None else StragglerPolicy()
        self.clock = clock
        self.warmup = warmup
        self.ticks_seen = 0
        self.last_tick_time: float | None = None

    def step(self) -> bool:
        t0 = self.clock()
        alive = self.engine.step()
        dt = self.clock() - t0
        self.last_tick_time = dt
        self.ticks_seen += 1
        # Check against the deadline before this tick joins the EMA: a
        # monster tick must not dilute the deadline meant to catch it.
        if (self.ticks_seen > self.warmup
                and self.policy.is_straggler(dt)):
            raise StuckTickError(
                f"engine tick {self.ticks_seen} took {dt:.4f}s, deadline "
                f"{self.policy.deadline():.4f}s "
                f"(ema {self.policy.ema:.4f}s x slack "
                f"{self.policy.slack})")
        self.policy.observe(dt)
        return alive

    def run(self, seed: int = 0) -> None:
        """Drain the engine under watchdog supervision."""
        self.engine.begin(seed)
        while self.engine.pending():
            self.step()

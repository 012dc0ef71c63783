"""The fault-tolerant training loop, on one device or over a mesh.

Counterpart of ``repro/train/trainer.py``:

* checkpoint every ``ckpt_every`` steps (async, atomic) and resume from the
  latest, in the reference's on-disk layout (a checkpoint of either package
  resumes in the other);
* straggler deadline tracking (``runtime.StragglerPolicy``'s EMA);
* retry of a failed step on one device (``max_retries``, then re-raise);
* deterministic data: ``batch_at(step)`` is a pure function of the step,
  so a resumed run sees the batches a straight run sees.

The device is explicit (``device=None`` means the card).  With training's
mesh ``rules`` (``sharding/rules.py:make_rules`` over the ranks'
``DeviceMesh``; every rank builds its Trainer and calls :meth:`train`
together) the state is this rank's blocks, cut from the seeded state
part by part as it is drawn or from a checkpoint of any layout leaf by
leaf as it is read, so a rank's device never holds the whole state; the
step runs under the rules on this rank's rows of each batch (data rank i
reads shard i); a checkpoint is gathered onto the leader's host memory
leaf by leaf and written once by it (``write_once``) in the reference's
layout: a file of a mesh run is one device's kind of file, and resumes on
any mesh or on one device.  A failed step is not retried over a mesh (the
other ranks may be inside a collective the failed one never reaches, and
cannot agree to retry without it): every rank logs its failure and
raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import StragglerPolicy
from repro_torch.sharding.api import (MeshRules, block_index, gather_state,
                                      is_leader, shard_state, use_rules,
                                      write_once)
from repro_torch.train.optimizer import tree_map
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step, state_from_numpy,
                                          state_specs, state_to_numpy)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    max_retries: int = 2
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 run: TrainerConfig, data_cfg: DataConfig | None = None,
                 device=None, rules: MeshRules | None = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.run = run
        self.rules = rules
        self.device = resolve_device(device)
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=256, global_batch=8, seed=run.seed)
        shard, n_shards = 0, 1
        self.specs = None
        if rules is not None:
            shard, n_shards = block_index(rules, rules.pspec(
                ("batch",), (self.data_cfg.global_batch,))[0])
            self.specs = state_specs(cfg, tcfg, rules)
        self.dataset = SyntheticLMDataset(self.data_cfg, shard=shard,
                                          num_shards=n_shards,
                                          microbatches=tcfg.microbatches)
        self.ckpt = CheckpointManager(run.ckpt_dir)
        self.straggler = StragglerPolicy()
        self.metrics_log: list[dict] = []
        # (kind, step, seconds) of each checkpoint load, sync save and
        # async save's host snapshot (its write runs in the background).
        self.ckpt_events: list[tuple[str, int, float]] = []
        self._step = make_train_step(cfg, tcfg)

    # ------------------------------------------------------------------

    def _part_block(self, path, part):
        """This rank's blocks of one freshly drawn part of the parameters
        (``path`` its keys in the parameter tree)."""
        spec = functools.reduce(lambda s, k: s[k], path,
                                self.specs["params"])
        return shard_state(self.rules, part, spec)

    def _leaf_block(self, path: str, leaf: np.ndarray) -> np.ndarray:
        """This rank's block of a checkpoint leaf (``path`` in the
        reference's layout, where a scanned segment's leading axis is
        whole)."""
        spec = self.rules.param_pspec(path, leaf.shape)
        for axis, entry in enumerate(spec):
            i, n = block_index(self.rules, entry)
            if n > 1:
                size = leaf.shape[axis] // n
                leaf = leaf[(slice(None),) * axis
                            + (slice(i * size, (i + 1) * size),)]
        return np.ascontiguousarray(leaf)

    def init_or_resume(self):
        """The seeded initial state, or the latest checkpoint's (this
        rank's blocks of it under mesh rules)."""
        mesh = self.rules is not None
        if latest_step(self.ckpt.directory) is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.run.seed)
            return init_train_state(
                self.cfg, self.tcfg, gen, self.device,
                place=self._part_block if mesh else None), 0
        # The checkpoint's structure and dtypes, from shapes alone.
        shapes = init_train_state(self.cfg, self.tcfg, torch.Generator(),
                                  "meta")
        like = state_to_numpy(tree_map(
            lambda t: torch.empty(0, dtype=t.dtype), shapes), self.cfg)
        t0 = time.perf_counter()
        tree, ck_step = self.ckpt.restore(
            like, place=self._leaf_block if mesh else None)
        state = state_from_numpy(tree, self.cfg, self.device)
        self.ckpt_events.append(("load", ck_step, time.perf_counter() - t0))
        self._log(f"[trainer] resumed from step {ck_step}")
        return state, ck_step

    def _log(self, line: str, every_rank: bool = False):
        """Print on one device, or on the mesh's leader; with
        ``every_rank`` on every rank, after its coordinate."""
        if self.rules is None or is_leader(self.rules):
            print(line)
        elif every_rank:
            print(f"[rank {tuple(self.rules.mesh.get_coordinate())}] "
                  f"{line}")

    def _save(self, kind: str, save, state, step: int):
        """Write ``state`` at ``step`` with ``save`` (the manager's sync or
        async save): on one device as it is; under mesh rules gathered onto
        the leader's host memory, which alone writes (``write_once``)."""
        t0 = time.perf_counter()
        if self.rules is None:
            save(state_to_numpy(state, self.cfg), step)
        else:
            full = gather_state(self.rules, state, self.specs,
                                leader_only=True)
            write_once(self.rules, lambda: (
                save(state_to_numpy(full, self.cfg), step), [step])[1])
        self.ckpt_events.append((kind, step, time.perf_counter() - t0))

    def save_async(self, state, step: int):
        self._save("snapshot", self.ckpt.save_async, state, step)

    def save_sync(self, state, step: int):
        self._save("save", self.ckpt.save_sync, state, step)

    def train(self, on_step: Callable[[int, dict], None] | None = None):
        with use_rules(self.rules):
            return self._train(on_step)

    def _train(self, on_step):
        state, start = self.init_or_resume()
        for step in range(start, self.run.steps):
            batch = torch.as_tensor(self.dataset.batch_at(step),
                                    device=self.device)
            t0 = time.monotonic()
            state, metrics = self._run_with_retry(state, batch)
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.straggler.observe(dt)
            m["step_time"] = dt
            m["straggler"] = self.straggler.is_straggler(dt)
            self.metrics_log.append(m)
            if on_step:
                on_step(step, m)
            if self.run.log_every and step % self.run.log_every == 0:
                self._log(f"[trainer] step {step} loss {m['loss']:.4f} "
                          f"gnorm {m['grad_norm']:.3f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.run.ckpt_every == 0:
                self.save_async(state, step + 1)
        self.ckpt.wait()
        self.save_sync(state, self.run.steps)
        return state

    def _run_with_retry(self, state, batch):
        """The step, retried up to ``max_retries`` times on one device;
        over a mesh run once (see the module's docstring)."""
        retries = self.run.max_retries if self.rules is None else 0
        last_err = None
        for attempt in range(retries + 1):
            try:
                return self._step(state, batch)
            except Exception as e:  # a transient device or runtime failure
                last_err = e
                self._log(f"[trainer] step failed (attempt {attempt + 1}): "
                          f"{e}", every_rank=True)
                if attempt < retries:
                    time.sleep(0.1 * (attempt + 1))
        raise last_err

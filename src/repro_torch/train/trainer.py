"""The fault-tolerant training loop on one device.

Counterpart of ``repro/train/trainer.py``:

* checkpoint every ``ckpt_every`` steps (async, atomic) and resume from the
  latest, in the reference's on-disk layout (a checkpoint of either package
  resumes in the other);
* straggler deadline tracking (``runtime.StragglerPolicy``'s EMA);
* retry of a failed step (``max_retries``, then re-raise);
* deterministic data: ``batch_at(step)`` is a pure function of the step,
  so a resumed run sees the batches a straight run sees.

The device is explicit (``device=None`` means the card).  Mesh training
(the reference's ``rules``) is the next slice of the port.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import StragglerPolicy
from repro_torch.train.optimizer import tree_map
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step, state_from_numpy,
                                          state_to_numpy)


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
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.run = run
        self.device = resolve_device(device)
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=256, global_batch=8, seed=run.seed)
        self.dataset = SyntheticLMDataset(self.data_cfg)
        self.ckpt = CheckpointManager(run.ckpt_dir)
        self.straggler = StragglerPolicy()
        self.metrics_log: list[dict] = []
        # (kind, step, seconds) of each checkpoint load, sync save and
        # async save's host snapshot (its write runs in the background).
        self.ckpt_events: list[tuple[str, int, float]] = []
        self._step = make_train_step(cfg, tcfg)

    # ------------------------------------------------------------------

    def init_or_resume(self):
        """The seeded initial state, or the latest checkpoint's."""
        gen = torch.Generator(device=self.device).manual_seed(self.run.seed)
        state = init_train_state(self.cfg, self.tcfg, gen, self.device)
        if latest_step(self.ckpt.directory) is None:
            return state, 0
        # The checkpoint's structure and dtypes, without a host copy.
        like = state_to_numpy(tree_map(lambda t: t.detach().reshape(-1)[:0],
                                       state), self.cfg)
        del state
        t0 = time.perf_counter()
        tree, ck_step = self.ckpt.restore(like)
        state = state_from_numpy(tree, self.cfg, self.device)
        self.ckpt_events.append(("load", ck_step, time.perf_counter() - t0))
        print(f"[trainer] resumed from step {ck_step}")
        return state, ck_step

    def save_async(self, state, step: int):
        t0 = time.perf_counter()
        self.ckpt.save_async(state_to_numpy(state, self.cfg), step)
        self.ckpt_events.append(("snapshot", step, time.perf_counter() - t0))

    def save_sync(self, state, step: int):
        t0 = time.perf_counter()
        self.ckpt.save_sync(state_to_numpy(state, self.cfg), step)
        self.ckpt_events.append(("save", step, time.perf_counter() - t0))

    def train(self, on_step: Callable[[int, dict], None] | None = None):
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
                print(f"[trainer] step {step} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.run.ckpt_every == 0:
                self.save_async(state, step + 1)
        self.ckpt.wait()
        self.save_sync(state, self.run.steps)
        return state

    def _run_with_retry(self, state, batch):
        last_err = None
        for attempt in range(self.run.max_retries + 1):
            try:
                return self._step(state, batch)
            except Exception as e:  # a transient device or runtime failure
                last_err = e
                print(f"[trainer] step failed (attempt {attempt + 1}): {e}")
                time.sleep(0.1 * (attempt + 1))
        raise last_err

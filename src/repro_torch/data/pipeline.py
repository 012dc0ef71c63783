"""Synthetic LM data pipeline: no external corpora.

Counterpart of ``repro/data/pipeline.py`` (numpy only, so the port keeps
its own copy); batches are the reference's, value for value.

Generates a *structured* token stream — a mixture of Zipfian unigrams and
repeated n-gram motifs — so a small LM actually has something to learn
(needed for the Fig-13a quality/efficiency reproduction, where we measure
loss deltas under BitStopper pruning).  Deterministic per (seed, step,
shard), so restarted/elastic runs replay identical batches: a checkpoint
at step N resumes bit-identically on any surviving topology.

A shard's rows are dealt contiguously (the reference's deal) or, for a
step run in ``microbatches`` slices, microbatch-major
(:func:`shard_rows`): shard d's i-th local microbatch is then d's part of
one device's i-th microbatch, so a mesh microbatch holds one device's.
At one shard or one microbatch both deals are the same.

Host-side double-buffer prefetch thread overlaps generation with compute.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    n_motifs: int = 64
    motif_prob: float = 0.35


def shard_rows(global_batch: int, shard: int, num_shards: int,
               microbatches: int = 1) -> list[int]:
    """The global rows of ``shard``'s local batch, in its order: local row
    j is global row ``(j // r) * mb + shard * r + j % r``, where ``mb =
    global_batch / microbatches`` and ``r = mb / num_shards``, so local
    microbatch i (rows ``[i * r, (i + 1) * r)``) is this shard's part of
    global microbatch i.  With one microbatch, rows ``[shard * r, (shard +
    1) * r)``."""
    if global_batch % (num_shards * microbatches):
        raise ValueError(
            f"a batch of {global_batch} rows does not deal into "
            f"{microbatches} microbatches over {num_shards} shards")
    mb = global_batch // microbatches
    r = mb // num_shards
    return [(j // r) * mb + shard * r + j % r
            for j in range(global_batch // num_shards)]


class SyntheticLMDataset:
    """Deterministic synthetic LM batches, shardable by data-parallel rank
    (rows dealt as :func:`shard_rows` deals them)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 prefetch: int = 2, microbatches: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.rows = shard_rows(cfg.global_batch, shard, num_shards,
                               microbatches)
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32)
        # Zipf over a shuffled alphabet so token ids don't correlate w/ rank.
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab).astype(np.int32)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- deterministic batch synthesis --------------------------------------

    def batch_at(self, step: int) -> np.ndarray:
        """[local_batch, seq_len] int32 for this shard at this step."""
        cfg = self.cfg
        out = np.empty((self.local_batch, cfg.seq_len), np.int32)
        for i, grow in enumerate(self.rows):
            # seed by GLOBAL row index so shards tile the global batch
            # exactly (straggler reassignment depends on this).
            row_seed = cfg.seed * 1_000_003 + step * 131 + grow * 977
            rng = np.random.default_rng(row_seed)
            seq = self._perm[
                rng.choice(cfg.vocab, size=cfg.seq_len, p=self._probs)]
            # Splice motifs: learnable repeated structure.
            pos = 0
            while pos + cfg.motif_len < cfg.seq_len:
                if rng.random() < cfg.motif_prob:
                    m = self._motifs[rng.integers(cfg.n_motifs)]
                    seq[pos: pos + cfg.motif_len] = m
                    pos += cfg.motif_len
                else:
                    pos += rng.integers(4, 32)
            out[i] = seq
        return out

    # -- prefetch ------------------------------------------------------------

    def start_prefetch(self, start_step: int = 0):
        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._queue.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        self._stop.clear()
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_batch(self):
        return self._queue.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

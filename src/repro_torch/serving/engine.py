"""Paged continuous-batching engine with BitStopper decode.

Counterpart of the ``PagedEngine`` core of ``repro/serving/engine.py``: a
refcounted block-pool KV cache (``kv_pool.KVBlockPool`` owns the host-side
allocation), admission bounded by pool capacity, copy-on-write sharing of
full prompt-prefix blocks, chunked prefill interleaved with decode ticks,
seeded schedule-invariant sampling, and oversubscribed admission with
victim preemption, lossless resume, deadlines, SLO classes and load
shedding.

Sampling (``serving/sampling.py``): token n of request rid draws under
``fold_in(fold_in(seed, rid), n)`` with the reference's threefry keys, so a
sampled trace does not depend on slot assignment, prefill chunking,
preemption or speculative acceptance.

Oversubscription (``ServeConfig.oversubscribe``): admission reserves the
context blocks plus one decode block instead of the worst case; a
mid-decode claim that finds the pool dry preempts a victim (SLO class,
then deadline slack, then ``preempt_policy``), frees its exclusive blocks,
drops a reference on its shared ones and requeues it.  The victim resumes
by prefilling its context (prompt plus generated tokens) and replays its
last sampled token.  Deadlines (``deadline_ticks``, per request or by
default) truncate a started request and shed a queued one that never
started; past ``shed_watermark`` queued besteffort requests are shed.

Decode runs the paged BESF decode once per layer per tick: the CUDA kernel
``kernels/csrc/paged_decode.cu`` when ``fused_decode`` resolves True (the
default on a CUDA device), else the plain torch oracle.  Both compute the
same integer observables, so the switch does not change served tokens.

Speculative decoding (``ServeConfig.speculative``): a drafter proposes up
to ``draft_k`` tokens per slot, one Sq=k+1 verify forward scores the draft
blocks (per layer the paged BESF verify, the CUDA kernel
``kernels/csrc/paged_verify.cu`` when ``fused_decode``), the longest
prefix of drafts equal to the greedy tokens is accepted and the rejected
tail's blocks are rolled back.  A draft write that grows a pool-wide quant
scale is undone and the tick replayed plain, so traces equal
non-speculative serving.

A page size that is not a multiple of 8 gives a planeless pool (no scales,
no plane pool): its decode gathers each slot's view for the single-query
BESF, and ``fused_decode`` (auto only where ``page_size % 8 == 0``) and
speculative serving are refused there, as in the reference.

Crash snapshots and chaos (``serving/chaos.py``): :meth:`PagedEngine.snapshot`
is the engine's host state as JSON (requests, queue, slots, counters, tick,
seed, allocator state and the pool-wide quant scales; never device KV), and
:meth:`PagedEngine.restore` rebuilds a fresh engine from it: the scales are
written back first, then every in-flight request requeues through the
resume path, so the recompute runs under the crash-time scales.  With a
``FaultInjector`` attached (``self.chaos``) the engine consults it, keyed on
its tick counter, at a mid-decode block claim (``pool_dry``), at the head
of a speculative tick (``drafter_fail``) and before each decode or verify
forward on the kernel (``kernel_fail``): the circuit breaker then switches
the engine to the plain oracle for the rest of its life and runs the same
tick there.  The breaker catches only the injected ``KernelFault``; an
error raised by a kernel propagates.

The KV memory hierarchy (``swap_host_bytes``, ``prefix_store_dir``,
``prefix_host_bytes``): a preemption victim's exclusive blocks copy to a
budgeted host pool (``kv_pool.SwapPool``) and its resume splices them back
instead of recomputing them; registered prefix blocks that the pool's LRU
evicts spill to a host tier and on to a disk store
(``checkpoint/store.py``), from which a fresh engine warms its prefix cache,
replaying the write rule's scale updates chunk group by chunk group.  A
refused put, a ``swap_fail``, a victim whose exclusive blocks are not one
run, and a record that no longer matches its admission fall back to
recompute (``swap_fallbacks``).  :meth:`PagedEngine.memory_report` gives the
bytes of each tier.  Host tiers are not snapshotted: a restored engine
resumes by recompute.

The engine API (:meth:`PagedEngine.prefill`, :meth:`~PagedEngine.extract`,
:meth:`~PagedEngine.insert`, :meth:`~PagedEngine.generate_step`): prefill
hands a fresh request's blocks and first token to a :class:`Prefix`;
extract copies its rows and the quant scales to host arrays (a detached
Prefix another engine can take); insert mounts a Prefix into a free slot as
a post-preemption resume, merging a detached Prefix's scales by elementwise
max and rebuilding the plane pools; generate_step is one tick reported as
per-request token events.  ``serving/frontdoor`` builds the async door and
prefill/decode disaggregation on it.  :meth:`PagedEngine.sparsity_report`
measures a prompt's BitStopper traffic at the first attention layer, and
:meth:`PagedEngine.kv_bytes_contiguous_equiv` what a contiguous cache of
the same configuration would hold.

Every attention impl serves: BitStopper decodes through the paged BESF
above, ``xla`` and ``flash`` through each slot's gathered view and the
dense masked softmax (speculative ticks too, with no scales and so no
growth bailout).  :class:`ContinuousBatchingEngine` is the contiguous
per-slot baseline the paged engine equals token for token, and
:class:`StaticBucketEngine` the static length-bucketed batcher.

Not ported yet (each is a queue A item in ROADMAP.md): mesh sharding and
the bf16 cache.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core.block_adaptation import block_bitstopper_attention
from repro_torch.kernels import paged_decode
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.attention import (POS_SENTINEL, PagedLayout,
                                          apply_inject_amax_rule,
                                          attention_block_shape,
                                          extract_block_rows,
                                          paged_layer_groups,
                                          repack_block_planes,
                                          requant_plane_pools,
                                          splice_block_rows,
                                          undo_paged_write)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed, linear, rope
from repro_torch.serving.chaos import CheckpointInterrupted, KernelFault
from repro_torch.serving.kv_pool import KVBlockPool, SwapPool
from repro_torch.serving.sampling import (categorical_block, fold_in,
                                         prng_key, sample_tokens)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512                # default sizing of the paged pool
    max_slots: int = 4                # concurrent decode batch width
    prefill_bucket: int = 16          # prefill chunks pad up to a multiple
    temperature: float = 0.0          # 0 = greedy
    cache_dtype: str = "float32"
    eos_id: int | None = None         # optional early stop token
    page_size: int = 16               # tokens per KV block
    pool_blocks: int | None = None    # physical blocks incl. the null block
                                      # (default 1 + slots * max_blocks)
    max_blocks_per_req: int | None = None  # block-table width per slot
                                      # (default ceil(max_len / page_size))
    prefill_chunk: int | None = None  # prompt tokens per prefill tick
                                      # (default 4 * prefill_bucket)
    prefix_sharing: bool = True       # share full prompt-prefix blocks
    oversubscribe: bool = False       # admit against context-sized
                                      # reservations instead of the worst
                                      # case; a dry pool mid-decode preempts
                                      # a victim (freed, requeued, resumed
                                      # losslessly by prefill recompute)
    preempt_policy: str = "fewest_tokens"  # victim choice: "fewest_tokens"
                                      # (least generated) | "lifo" (newest
                                      # admitted)
    fused_decode: bool | None = None  # BitStopper decode through the CUDA
                                      # kernel (True), the plain oracle
                                      # (False), or auto: kernel iff the
                                      # engine runs on a CUDA device and
                                      # page_size % 8 == 0
    speculative: str = "off"          # "off" | "ngram" (prompt-lookup
                                      # self-drafter) | "draft" (draft
                                      # transformer; defaults to self-draft)
    draft_k: int = 4                  # draft tokens proposed per tick
    deadline_ticks: int | None = None # default per-request deadline in
                                      # scheduler ticks from submission
                                      # (Request.deadline_ticks overrides);
                                      # expiry truncates a started request
                                      # and sheds a never-started one
    shed_watermark: float | None = None  # pool saturation past which queued
                                      # besteffort requests are shed
                                      # (needs oversubscribe=True)
    snapshot_every: int = 0           # crash-snapshot cadence in ticks for
                                      # serving/chaos.serve_with_chaos and
                                      # launch/serve --snapshot-every
                                      # (0 = only the initial snapshot)
    swap_host_bytes: int = 0          # host-RAM budget for swap-to-host
                                      # preemption: a victim's exclusive
                                      # blocks copy to host and resume by
                                      # splice instead of prefill recompute
                                      # (0 = recompute only)
    prefix_store_dir: str | None = None  # persistent prefix store: cold
                                      # registered prefix blocks spill to
                                      # disk and a (re)started engine warms
                                      # its prefix cache from it
    prefix_host_bytes: int = 0        # host-RAM tier between the pool's
                                      # prefix LRU and the disk store
                                      # (evictions cascade downward; 0 =
                                      # spill straight to disk)

    def __post_init__(self):
        for name in ("max_len", "max_slots", "prefill_bucket", "page_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"cache_dtype must be float32|bfloat16, got "
                             f"{self.cache_dtype!r}")
        if self.cache_dtype != "float32":
            raise NotImplementedError(
                f"cache_dtype {self.cache_dtype!r}: the port's paged decode "
                f"kernel takes an f32 V pool; only float32 is ported "
                f"(ROADMAP A10)")
        if self.pool_blocks is not None and self.pool_blocks < 2:
            raise ValueError("pool_blocks must be >= 2 (block 0 is the "
                             f"null block), got {self.pool_blocks}")
        if self.max_blocks_per_req is not None and self.max_blocks_per_req < 1:
            raise ValueError(f"max_blocks_per_req must be >= 1, got "
                             f"{self.max_blocks_per_req}")
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{self.prefill_chunk}")
            if self.prefill_chunk % self.prefill_bucket:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"multiple of prefill_bucket ({self.prefill_bucket})")
        if self.fused_decode and self.page_size % 8:
            raise ValueError(
                f"fused_decode needs page_size % 8 == 0 (bit planes pack 8 "
                f"tokens/byte along the page axis), got page_size="
                f"{self.page_size}")
        if self.preempt_policy not in ("fewest_tokens", "lifo"):
            raise ValueError(
                f"preempt_policy must be fewest_tokens|lifo, got "
                f"{self.preempt_policy!r}")
        if self.speculative not in ("off", "ngram", "draft"):
            raise ValueError(
                f"speculative must be off|ngram|draft, got "
                f"{self.speculative!r}")
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if self.deadline_ticks is not None and self.deadline_ticks < 1:
            raise ValueError(f"deadline_ticks must be >= 1, got "
                             f"{self.deadline_ticks}")
        if self.shed_watermark is not None:
            if not 0.0 < self.shed_watermark < 1.0:
                raise ValueError(
                    f"shed_watermark must be in (0, 1), got "
                    f"{self.shed_watermark}")
            if not self.oversubscribe:
                raise ValueError(
                    "shed_watermark requires oversubscribe=True: worst-case"
                    "-reserved admission blocks the head of line instead of "
                    "overcommitting the pool, so saturation-based shedding "
                    "could never relieve preemption pressure")
        if self.snapshot_every < 0:
            raise ValueError(f"snapshot_every must be >= 0, got "
                             f"{self.snapshot_every}")
        if self.swap_host_bytes < 0:
            raise ValueError(f"swap_host_bytes must be >= 0, got "
                             f"{self.swap_host_bytes}")
        if self.prefix_host_bytes < 0:
            raise ValueError(f"prefix_host_bytes must be >= 0, got "
                             f"{self.prefix_host_bytes}")
        if self.swap_host_bytes and not self.oversubscribe:
            raise ValueError(
                "swap_host_bytes requires oversubscribe=True: swap-to-host "
                "captures preemption victims, and only oversubscribed "
                "admission ever preempts")
        if ((self.prefix_store_dir is not None or self.prefix_host_bytes)
                and not self.prefix_sharing):
            raise ValueError(
                "the prefix store extends the registered-prefix LRU tier "
                "downward; it needs prefix_sharing=True")

    def resolved_max_blocks(self) -> int:
        return self.max_blocks_per_req or -(-self.max_len // self.page_size)

    def resolved_pool_blocks(self) -> int:
        return (self.pool_blocks
                or 1 + self.max_slots * self.resolved_max_blocks())

    def resolved_chunk(self) -> int:
        return self.prefill_chunk or 4 * self.prefill_bucket


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                # [S] int32
    max_new_tokens: int = 32
    generated: list = dataclasses.field(default_factory=list)
    rid: int = -1                     # assigned at submit()
    deadline_ticks: int | None = None # per-request deadline in scheduler
                                      # ticks from submission (overrides
                                      # ServeConfig.deadline_ticks)
    slo: str = "standard"             # "besteffort" (sheddable past the
                                      # watermark, victimized first) |
                                      # "standard" | "strict" (victimized
                                      # last)
    # per-request accounting, filled by the engine
    prefill_len: int = 0
    admitted_step: int = -1
    finished_step: int = -1
    preemptions: int = 0              # times this request was victimized
    submitted_tick: int = -1          # engine tick at submit()
    shed_reason: str | None = None    # "watermark" | "deadline" when the
                                      # engine rejected it (no tokens)
    deadline_hit: bool = False        # finished by deadline truncation
                                      # (generated is a prefix of the
                                      # undisturbed stream)


class InsufficientBlocks(RuntimeError):
    """The pool cannot cover an engine-API ``prefill()`` or ``insert()``
    right now.  Retryable: capacity returns as requests finish, so callers
    (the disaggregation controller, the async door) back off a tick
    instead of failing the request."""


@dataclasses.dataclass
class Prefix:
    """Handle to a prefilled context: paged block handles plus sampling
    state, the currency of the engine API (``PagedEngine.prefill() ->
    insert() -> generate_step()``).

    Two forms:

    * **attached** (``pool`` is the source engine's pool): ``blocks`` holds
      physical block ids whose references the Prefix owns; insert into the
      same engine is a block-table splice and moves no KV.
    * **detached** (``payload`` set, ``pool``/``blocks`` cleared by
      ``extract()``): the blocks' rows copied through the pool to host
      arrays, so a different engine instance (its own pool, its own block
      numbering) can ``insert()`` it: the prefill/decode disaggregation
      handoff.
    """
    req: Request
    chain: np.ndarray          # cached context tokens [L] int32
    length: int                # tokens cached (== len(chain))
    last_token: int            # next decode input (already appended to
                               # req.generated by the prefill sample)
    blocks: list               # attached: block ids, refs owned here
    pool: Any = None           # the pool the blocks live in
    payload: Any = None        # detached: {"layers": [...], "amax": [...]}
    finished: bool = False     # the request completed during prefill (eos,
                               # max_new_tokens == 1, deadline): nothing to
                               # insert, its tokens are in req.generated


@dataclasses.dataclass
class _PagedSlot:
    """Scheduler-side state of one occupied serving slot."""
    req: Request
    next_prefill: int          # ctx tokens [0, next_prefill) are cached
    blocks_reserved: int       # reservation units not yet turned into allocs
    ctx: np.ndarray            # prefill tokens: the prompt, or on resume
                               # the prompt plus every generated token but
                               # the last (the next decode input)
    resumed: bool = False      # resuming after preemption: the last
                               # generated token is replayed, not re-sampled
    seq: int = 0               # admission order (LIFO victim policy)

    def prefilled(self) -> bool:
        return self.next_prefill >= len(self.ctx)


def _attach_tables(caches, table: torch.Tensor, length: torch.Tensor):
    """The cache tree with the engine's block table and fill levels set on
    every layer (the pool tensors are shared, not copied)."""
    return {seg: [{b: dict(c, table=table, length=length)
                   for b, c in unit.items()} for unit in units]
            for seg, units in caches.items()}


def _layers(caches) -> list[dict]:
    """Every layer's cache dict, in a fixed order."""
    return [unit[b] for seg in sorted(caches) for unit in caches[seg]
            for b in sorted(unit)]


def _amax_groups(caches, scan_layers: bool) -> list[list[torch.Tensor]]:
    """The reference's ``k_amax``/``v_amax`` leaves in its sorted-key
    traversal of the cache tree, each as the per-layer tensors it holds: a
    segment the reference stacks (``scan_layers`` and more than one rep)
    has one leaf per block and key, stacked over its reps; any other
    segment has one leaf per layer."""
    return [[c[key] for c in group]
            for group in paged_layer_groups(caches, scan_layers)
            for key in ("k_amax", "v_amax") if key in group[0]]


def _amax_leaves(caches, scan_layers: bool = True) -> list[torch.Tensor]:
    """Every layer's ``k_amax``/``v_amax``, in the order of
    :func:`_amax_groups` (the growth probe of a speculative draft-block
    write, and the snapshot's scales)."""
    return [t for g in _amax_groups(caches, scan_layers) for t in g]


def _amax_arrays(caches, scan_layers: bool) -> list[np.ndarray]:
    """The scales as the reference's leaves hold them: one f32 host array
    per leaf of :func:`_amax_groups` (``[reps, Hkv]`` where it stacks)."""
    out = []
    for g in _amax_groups(caches, scan_layers):
        a = np.stack([t.cpu().numpy() for t in g]).astype(np.float32)
        out.append(a if len(g) > 1 else a[0])
    return out


def _amax_state(caches, scan_layers: bool) -> list:
    """The scales as the reference's snapshot holds them: one f32 list per
    leaf of :func:`_amax_groups` (nested over reps where it stacks)."""
    return [a.tolist() for a in _amax_arrays(caches, scan_layers)]


def _set_amax_leaves(caches, values: list, scan_layers: bool) -> None:
    """Write a snapshot's scales back, in place and on the caches' device,
    in the order :func:`_amax_state` reads them: the restore half of engine
    snapshotting.  The running scales are monotone and depend on the order
    of writes (growth overshoots by ``AMAX_HEADROOM``), so a restored
    engine inherits the crash-time scales instead of re-deriving them from
    recomputed tokens: the recompute's writes then grow no scale, and every
    later growth happens as in the undisturbed run."""
    groups = _amax_groups(caches, scan_layers)
    if len(values) != len(groups):
        extra = len(values) - len(groups)
        raise ValueError(
            f"snapshot carries {extra} extra quant-scale leaves the cache "
            f"has no home for" if extra > 0 else
            f"snapshot carries {len(values)} quant-scale leaves, the cache "
            f"has {len(groups)}")
    for g, val in zip(groups, values):
        a = np.asarray(val, np.float32).reshape((len(g),) + tuple(g[0].shape))
        for t, row in zip(g, a):
            t.copy_(torch.as_tensor(row, device=t.device))


def _supported(cfg: ModelConfig) -> None:
    mixers = {spec.mixer for unit, _ in cfg.segments for spec in unit}
    bad = mixers - {"attn", "local_attn"}
    if bad:
        raise ValueError(
            f"continuous batching serves attention models only "
            f"(per-slot KV cache); config has mixers {sorted(bad)}")


def _attn_configs(cfg: ModelConfig):
    """(reps, is local_attn, AttnConfig) of every attention block."""
    for unit, reps in cfg.segments:
        for spec in unit:
            if spec.mixer in ("attn", "local_attn"):
                local = spec.mixer == "local_attn"
                yield reps, local, cfg.attn_config(local)


def _kv_bytes_per_token(cfg: ModelConfig) -> int:
    """f32 K/V bytes one cached token costs across all attention layers."""
    return sum(reps * 2 * a.n_kv_heads * a.head_dim * 4
               for reps, _, a in _attn_configs(cfg))


def _plane_bytes_per_token(cfg: ModelConfig) -> int:
    """Packed plane-pool bytes one cached token costs across the BitStopper
    layers whose fused kernel keeps ``kq``: bits x Hkv x D bits."""
    return sum((reps * a.bitstopper.bits * a.n_kv_heads * a.head_dim) // 8
               for reps, _, a in _attn_configs(cfg)
               if a.impl in ("bitstopper", "bitstopper_xla")
               and a.fused_decode)


def _amax_static_bytes(cfg: ModelConfig) -> int:
    """The f32 ``k_amax``/``v_amax`` per KV head of every BitStopper
    layer's paged cache."""
    return sum(reps * 2 * a.n_kv_heads * 4
               for reps, _, a in _attn_configs(cfg)
               if a.impl in ("bitstopper", "bitstopper_xla"))


def _kv_bytes_contiguous(cfg: ModelConfig, scfg: ServeConfig) -> int:
    """Resident bytes of a contiguous per-slot f32 cache: max_len rows per
    slot per layer, except sliding-window layers, whose ring buffers hold
    min(max_len, window) rows."""
    total = 0
    for reps, local, acfg in _attn_configs(cfg):
        rows = scfg.max_len
        if local and acfg.window:
            rows = min(rows, acfg.window)
        total += reps * rows * 2 * acfg.n_kv_heads * acfg.head_dim * 4
    return total * scfg.max_slots


class _EngineCommon:
    """The tick loop, sampling and traffic reports the serving engines
    share."""

    def begin(self, seed: int = 0) -> None:
        """Fix the sampling seed for a serving run (split out of
        :meth:`run` so a caller, such as ``serve_with_chaos``, can own the
        tick loop; a restored engine derives the same key again)."""
        self._seed = seed
        self._base_key = prng_key(seed).numpy()

    def pending(self) -> bool:
        """True while a submitted request is unfinished (queued or in a
        slot)."""
        return bool(self.queue or any(r is not None for r in self.slots))

    def run(self, seed: int = 0) -> None:
        """Serve queue and slots to completion, deterministically under
        ``seed``."""
        self.begin(seed)
        while self.pending():
            self.step()

    def generate(self, requests: list[Request],
                 seed: int = 0) -> list[Request]:
        """Serve the requests to completion; returns them with
        ``generated`` filled."""
        for r in requests:
            self.submit(r)
        self.run(seed)
        return requests

    def _sample_rows(self, logits: torch.Tensor, rids,
                     counts) -> np.ndarray:
        """Tokens for logits rows ``[R, V]`` under the rows' (rid, token
        index) keys; the one host sync of a tick's sampling."""
        return sample_tokens(self._base_key, logits, rids, counts,
                             self.scfg.temperature).cpu().numpy()

    def _bucketed(self, L: int) -> int:
        b = self.scfg.prefill_bucket
        return min(self.scfg.max_len, -(-L // b) * b)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def sparsity_report(self, prompts) -> dict[str, Any]:
        """Measured BitStopper traffic, per request and aggregated.

        ``prompts``: a 2-D int array [B, S] or a list of 1-D int arrays of
        any lengths.  Each prompt's prefill attention at the first
        attention layer runs through the block-granular model; the report
        gives the mean planes fetched per (q tile, kv block), the plane
        fraction against dense ``bits``-bit keys, the block-level V-fetch
        fraction and the token survivor fraction, aggregated and under
        ``per_request``."""
        if isinstance(prompts, np.ndarray) and prompts.ndim == 2:
            prompts = list(prompts)
        per_request = []
        for p in prompts:
            rep = _prompt_sparsity(self.cfg, self.params, np.asarray(p))
            if rep:
                per_request.append(rep)
        if not per_request:
            return {}
        # Weighted: a long prompt has many more (q tile, kv block) units and
        # (q, k) pairs than a short one, and an unweighted mean over
        # requests would let short prompts skew the aggregate.
        blocks = np.array([r["n_blocks"] for r in per_request], np.float64)
        pairs = np.array([r["n_pairs"] for r in per_request], np.float64)

        def wmean(key, w):
            vals = np.array([r[key] for r in per_request], np.float64)
            return float((vals * w).sum() / w.sum())

        return {
            "mean_rounds": wmean("mean_rounds", blocks),
            "plane_fraction": wmean("plane_fraction", blocks),
            "block_alive_fraction": wmean("block_alive_fraction", blocks),
            "survivor_fraction": wmean("survivor_fraction", pairs),
            "per_request": per_request,
        }


class ContinuousBatchingEngine(_EngineCommon):
    """Request-level continuous batching over a contiguous per-slot KV
    cache: every slot reserves ``max_len`` rows per layer (a ring of the
    window for ``local_attn`` layers).  A request prefills alone,
    bucket-padded, into an empty one-slot cache that is then copied into
    its slot's rows; every tick decodes all slots, each at its own
    position.  The paged engine serves the same tokens (the reference's
    bit-identity baseline).  ``device=None`` serves on the CUDA card and
    raises if there is none."""

    def __init__(self, cfg: ModelConfig, params,
                 scfg: ServeConfig = ServeConfig(), device=None):
        _supported(cfg)
        if scfg.speculative != "off":
            raise ValueError(
                "speculative decoding needs the paged engine (block-table "
                "rollback); use PagedEngine")
        if scfg.oversubscribe:
            raise ValueError(
                "oversubscription needs the paged engine (block-pool "
                "preemption); use PagedEngine")
        if (scfg.deadline_ticks is not None
                or scfg.shed_watermark is not None or scfg.snapshot_every):
            raise ValueError(
                "deadlines / load shedding / crash snapshots are "
                "PagedEngine features (docs/robustness.md); use PagedEngine")
        if (scfg.swap_host_bytes or scfg.prefix_host_bytes
                or scfg.prefix_store_dir is not None):
            raise ValueError(
                "the KV memory hierarchy (swap_host_bytes / "
                "prefix_store_dir / prefix_host_bytes) is a PagedEngine "
                "feature (docs/serving.md); use PagedEngine")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        B = scfg.max_slots
        self.caches = T.init_caches(cfg, B, scfg.max_len, per_slot=True,
                                    device=self.device)
        self.slots: list[Request | None] = [None] * B
        self.queue: collections.deque[Request] = collections.deque()
        self.lengths = np.zeros((B,), np.int32)       # tokens in each slot
        self.last_token = np.zeros((B,), np.int32)    # next decode input
        self._next_rid = 0
        self._step = 0
        self._seed = None
        self._base_key = prng_key(0).numpy()
        self.counters = {"prefill_tokens": 0, "decode_tokens": 0,
                         "decode_steps": 0, "decode_slot_steps": 0,
                         "requests_finished": 0}

    def kv_bytes_resident(self) -> int:
        """KV memory the cache keeps resident: contiguous slots reserve
        their full capacity (ring buffers: the window) whatever the
        occupancy."""
        return _kv_bytes_contiguous(self.cfg, self.scfg)

    def submit(self, req: Request) -> Request:
        L = len(req.prompt)
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if L + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"request needs {L}+{req.max_new_tokens} tokens, "
                f"max_len={self.scfg.max_len}")
        req.rid = self._next_rid
        self._next_rid += 1
        self.queue.append(req)
        return req

    def _insert(self, small, slot: int) -> None:
        """Copy a one-slot cache tree into row ``slot`` of every leaf."""
        for seg, units in small.items():
            for u, unit in enumerate(units):
                for b, layer in unit.items():
                    big = self.caches[seg][u][b]
                    for key, val in layer.items():
                        big[key][slot] = val[0]

    @torch.no_grad()
    def _admit(self) -> None:
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            req = self.queue.popleft()
            L = len(req.prompt)
            Sp = self._bucketed(L)
            tokens = np.zeros((1, Sp), np.int32)
            tokens[0, :L] = np.asarray(req.prompt, np.int32)
            positions = np.full((1, Sp), POS_SENTINEL, np.int32)
            positions[0, :L] = np.arange(L, dtype=np.int32)
            small = T.init_caches(self.cfg, 1, self.scfg.max_len,
                                  per_slot=True, device=self.device)
            logits, small, _ = T.forward(
                self.params, self._tensor(tokens), self.cfg, caches=small,
                positions=self._tensor(positions))
            self._insert(small, slot)
            tok = int(self._sample_rows(logits[:, L - 1], [req.rid], [0])[0])
            req.generated.append(tok)
            req.prefill_len = L
            req.admitted_step = self._step
            self.counters["prefill_tokens"] += L
            self.slots[slot] = req
            self.lengths[slot] = L
            self.last_token[slot] = tok
            self._maybe_evict(slot, tok)

    def _maybe_evict(self, slot: int, tok: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        done = len(req.generated) >= req.max_new_tokens
        if self.scfg.eos_id is not None and tok == self.scfg.eos_id:
            done = True
        if done:
            req.finished_step = self._step
            self.counters["requests_finished"] += 1
            self.slots[slot] = None

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler tick: admit from the queue, then one decode step
        over every slot.  Returns False when there is no work."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return bool(self.queue)
        self._step += 1
        logits, self.caches, _ = T.forward(
            self.params, self._tensor(self.last_token[:, None]), self.cfg,
            caches=self.caches, positions=self._tensor(self.lengths[:, None]))
        rids = [r.rid if r is not None else 0 for r in self.slots]
        counts = [len(r.generated) if r is not None else 0
                  for r in self.slots]
        toks = self._sample_rows(logits[:, -1], rids, counts)
        self.counters["decode_steps"] += 1
        self.counters["decode_slot_steps"] += len(self.slots)
        for i in active:
            req = self.slots[i]
            req.generated.append(int(toks[i]))
            self.counters["decode_tokens"] += 1
            self.lengths[i] += 1
            self.last_token[i] = toks[i]
            self._maybe_evict(i, int(toks[i]))
        return True


class PagedEngine(_EngineCommon):
    """Continuous batching over a paged block-pool KV cache.

    ``device=None`` serves on the CUDA card and raises if there is none;
    tests pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params,
                 scfg: ServeConfig = ServeConfig(), device=None,
                 drafter=None):
        _supported(cfg)
        self.device = resolve_device(device)
        fused = scfg.fused_decode
        if fused is None:
            fused = self.device.type == "cuda" and scfg.page_size % 8 == 0
        if fused and cfg.attn_impl in ("bitstopper", "bitstopper_xla"):
            # The pool's V width is head_dim (models/attention.py).
            reason = paged_decode.kernel_refusal(
                scfg.page_size, cfg.head_dim, cfg.head_dim,
                cfg.bitstopper.bits)
            if reason is not None:
                raise ValueError(
                    f"fused_decode: the decode and verify kernels take "
                    f"{reason}; serve with fused_decode=False")
        self.cfg = cfg.replace(fused_decode=bool(fused))
        self.params = params
        self.scfg = scfg
        # Deterministic fault injection (serving/chaos.py): an attached
        # FaultInjector is consulted at the pool claim, the kernel forwards
        # and the drafter, keyed on self.ticks.
        self.chaos = None
        self._drafter = None
        if scfg.speculative != "off":
            if (cfg.attn_impl in ("bitstopper", "bitstopper_xla")
                    and scfg.page_size % 8):
                raise ValueError(
                    "speculative BitStopper serving needs page_size % 8 == "
                    "0 (the paged verify shares the pool-wide quant state; "
                    f"got page_size={scfg.page_size})")
            from repro_torch.serving.speculative import make_drafter
            self._drafter = (drafter if drafter is not None else
                             make_drafter(scfg.speculative, cfg, params))
        elif drafter is not None:
            raise ValueError(
                "drafter passed but ServeConfig.speculative == 'off'")
        self._page = scfg.page_size
        self._mb = scfg.resolved_max_blocks()
        self._chunk = scfg.resolved_chunk()
        self.layout = PagedLayout(scfg.resolved_pool_blocks(), self._page,
                                  self._mb)
        # The KV memory hierarchy: host swap records of preemption victims,
        # and a host-RAM to disk cascade for registered prefix blocks that
        # the pool's LRU evicts.  The pool calls evict_cb inside alloc,
        # before the block's new owner writes it, so the spilled copy is
        # the block's content.
        self._swap = (SwapPool(scfg.swap_host_bytes)
                      if scfg.swap_host_bytes else None)
        self._prefix_host = (
            SwapPool(scfg.prefix_host_bytes,
                     evict_cb=self._spill_prefix_record)
            if scfg.prefix_host_bytes else None)
        evict_cb = (self._on_prefix_evict
                    if (self._prefix_host is not None
                        or scfg.prefix_store_dir is not None) else None)
        self.pool = KVBlockPool(self.layout.pool_blocks, self._page,
                                prefix_sharing=scfg.prefix_sharing,
                                evict_cb=evict_cb)
        B = scfg.max_slots
        self.caches = T.init_caches(self.cfg, B, paged=self.layout,
                                    device=self.device)
        self.slots: list[_PagedSlot | None] = [None] * B
        self.queue: collections.deque[Request] = collections.deque()
        self.table = np.zeros((B, self._mb), np.int32)
        self.lengths = np.zeros((B,), np.int32)
        self.last_token = np.zeros((B,), np.int32)
        self._prefill_fifo: collections.deque[int] = collections.deque()
        self._next_rid = 0
        self._admit_seq = 0
        self._step = 0
        self._seed = None
        self._base_key = prng_key(0).numpy()  # host words, like the rids
        # The engine's only clock: deadlines key on it, never on wall time.
        self.ticks = 0
        self.requests: dict[int, Request] = {}
        self.counters = {"prefill_tokens": 0, "prefix_hit_tokens": 0,
                         "prefill_chunks": 0, "decode_tokens": 0,
                         "decode_steps": 0, "decode_slot_steps": 0,
                         "decode_kv_tokens": 0, "requests_finished": 0,
                         "spec_ticks": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "spec_bailouts": 0,
                         "preemptions": 0, "preempt_freed_blocks": 0,
                         "preempt_dropped_tokens": 0,
                         "requests_shed": 0, "shed_watermark": 0,
                         "shed_deadline": 0, "deadline_truncated": 0,
                         "degradations": 0, "drafter_failures": 0,
                         "forced_preemptions": 0,
                         "prefixes_prefilled": 0, "prefixes_inserted": 0,
                         "prefix_transfers": 0,
                         "swap_outs": 0, "swap_ins": 0,
                         "swap_fallbacks": 0, "swap_in_tokens": 0,
                         "prefix_spills": 0, "prefix_store_hits": 0,
                         "prefix_store_tokens": 0,
                         "prefix_store_interrupts": 0}

    # ------------------------------------------------------------------
    # forwards
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _forward(self, tokens: np.ndarray, positions: np.ndarray,
                 rows: slice):
        caches = _attach_tables(self.caches, self._tensor(self.table[rows]),
                                self._tensor(self.lengths[rows]))
        logits, caches, _ = T.forward(self.params, self._tensor(tokens),
                                      self.cfg, caches=caches,
                                      positions=self._tensor(positions))
        self.caches = caches
        return logits

    @torch.no_grad()
    def _verify_forward(self, tokens: np.ndarray, positions: np.ndarray):
        """The Sq=k+1 verify forward over every slot.  Returns ``(logits,
        new_caches, grew, undo)``: ``grew`` says whether the draft-block
        write grew any pool-wide quant scale (K or V), and ``undo`` puts the
        pools back as they were before the write.  ``self.caches`` is left
        to the caller."""
        caches = _attach_tables(self.caches, self._tensor(self.table),
                                self._tensor(self.lengths))
        for c in _layers(caches):
            c["undo"] = []              # the write's undo records
        logits, new, _ = T.forward(self.params, self._tensor(tokens),
                                   self.cfg.replace(spec_verify=True),
                                   caches=caches,
                                   positions=self._tensor(positions))
        for c in _layers(new):
            del c["undo"]
        before, after = _amax_leaves(self.caches), _amax_leaves(new)
        # A dense impl's pool has no scales to grow.
        grew = bool(before) and bool(torch.stack([
            (n > o).any() for o, n in zip(before, after)]).any())

        def undo():
            for c in _layers(caches):
                for record in reversed(c["undo"]):
                    undo_paged_write(c, record)

        return logits, new, grew, undo

    # ------------------------------------------------------------------
    # the kernel circuit breaker
    # ------------------------------------------------------------------

    def _degrade(self, why: str) -> None:
        """Per-engine circuit breaker: a kernel fault switches the engine to
        the plain oracle for the rest of its life.  The oracle computes the
        kernels' integer observables and reads the same caches (the write
        path keeps the f32 pool and the plane pool either way), so the
        served tokens do not change.  Counted in ``degradations``."""
        if not self.cfg.fused_decode:
            raise RuntimeError(
                f"kernel fault on the plain oracle path ({why}): the "
                f"breaker has nothing simpler to fall back to")
        self.cfg = self.cfg.replace(fused_decode=False)
        self.counters["degradations"] += 1

    def _consult_kernel_fault(self, what: str) -> None:
        """The ``kernel_fail`` consult: raises :class:`KernelFault` when an
        injected fault is due, before the forward writes anything."""
        if (self.chaos is not None and self.cfg.fused_decode
                and self.chaos.fire("kernel_fail", self.ticks)):
            raise KernelFault(
                f"injected fused-{what} fault at tick {self.ticks}")

    def _guarded_decode(self, *args):
        """The decode forward behind the circuit breaker.  The fault is
        raised before the forward runs, so the caches are untouched and the
        tick runs once, on the plain oracle.  Only the consult's
        ``KernelFault`` is caught: an error the kernel raises propagates."""
        try:
            self._consult_kernel_fault("decode")
        except KernelFault as e:
            self._degrade(str(e))
        return self._forward(*args)

    def _guarded_verify(self, *args):
        """The verify forward behind the circuit breaker (see
        :meth:`_guarded_decode`); no undo record exists yet when the fault
        is raised."""
        try:
            self._consult_kernel_fault("verify")
        except KernelFault as e:
            self._degrade(str(e))
        return self._verify_forward(*args)

    # ------------------------------------------------------------------
    # capacity accounting
    # ------------------------------------------------------------------

    def _blocks_for(self, req: Request) -> int:
        """Worst-case block need: the final sampled token is never written
        back, so at most prompt + max_new_tokens - 1 slots are cached."""
        tokens = len(req.prompt) + req.max_new_tokens - 1
        return max(1, -(-tokens // self._page))

    def kv_bytes_resident(self, peak: bool = True) -> int:
        """KV memory backed by live blocks (peak over the run by default):
        f32 K/V rows, the packed plane pool when the kernel is on, and the
        static per-layer ``k_amax``/``v_amax`` scales."""
        blocks = (self.pool.peak_live_blocks if peak
                  else self.pool.live_blocks())
        per_tok = _kv_bytes_per_token(self.cfg)
        extra = 0
        if self._page % 8 == 0:          # a planeless pool keeps no scales
            per_tok += _plane_bytes_per_token(self.cfg)
            extra = _amax_static_bytes(self.cfg)
        return blocks * self._page * per_tok + extra

    def kv_bytes_contiguous_equiv(self) -> int:
        """What a contiguous per-slot cache of the same ServeConfig would
        keep resident (window layers: ring-buffer rows), for comparison
        with :meth:`kv_bytes_resident`."""
        return _kv_bytes_contiguous(self.cfg, self.scfg)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _validate_request(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = self._blocks_for(req)
        if need > self._mb:
            raise ValueError(
                f"request needs {need} KV blocks, block table holds "
                f"{self._mb} (raise max_blocks_per_req or max_len)")
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} KV blocks, pool has "
                f"{self.pool.capacity} (raise pool_blocks)")
        if req.slo not in ("besteffort", "standard", "strict"):
            raise ValueError(
                f"slo must be besteffort|standard|strict, got {req.slo!r}")
        if req.deadline_ticks is not None and req.deadline_ticks < 1:
            raise ValueError(
                f"deadline_ticks must be >= 1, got {req.deadline_ticks}")

    def _register(self, req: Request) -> None:
        """Record the request under its rid, assigning one if unset.  A
        pre-assigned rid fixes the request's sampling identity, so the
        order of submission cannot change a served token."""
        if req.rid < 0:
            req.rid = self._next_rid
        elif (req.rid in self.requests
              and self.requests[req.rid] is not req):
            raise ValueError(
                f"rid {req.rid} already belongs to another request")
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.requests[req.rid] = req

    def submit(self, req: Request) -> Request:
        self._validate_request(req)
        self._register(req)
        req.submitted_tick = self.ticks
        self.queue.append(req)
        return req

    def _deadline_of(self, req: Request) -> int | None:
        """Effective deadline in ticks from submission: a request submitted
        at tick t is expired once ``ticks > t + deadline``."""
        return (req.deadline_ticks if req.deadline_ticks is not None
                else self.scfg.deadline_ticks)

    def _expired(self, req: Request) -> bool:
        ddl = self._deadline_of(req)
        return ddl is not None and self.ticks > req.submitted_tick + ddl

    def _match_prefix(self, tokens: np.ndarray,
                      keep_last: bool = True) -> list[int]:
        """Longest chain of already-cached full blocks of ``tokens`` (refs
        taken).  With ``keep_last`` at least one token is left to prefill:
        its forward gives the logits of the first new token.  A resumed
        request knows its next input (``generated[-1]``), so a fully cached
        context needs no prefill."""
        bs = self._page
        matched: list[int] = []
        for j in range((len(tokens) - (1 if keep_last else 0)) // bs):
            bid = self.pool.lookup(tuple(int(t) for t in
                                         tokens[:(j + 1) * bs]))
            if bid is None:
                break
            matched.append(bid)
        return matched

    def _reserve_goal(self, total: int, n_ctx: int) -> int:
        """Blocks admission must secure: the worst case, or oversubscribed
        the context blocks plus one decode block."""
        if not self.scfg.oversubscribe:
            return total
        return min(total, n_ctx + 1)

    def _finish_queued(self, req: Request, shed_reason: str | None) -> None:
        """Retire the head of the queue without serving it: shed with the
        reason, or with ``None`` finish truncated (a preempted request
        whose deadline lapsed in the queue)."""
        self.queue.popleft()
        req.finished_step = self._step
        if shed_reason is None:
            req.deadline_hit = True
            self.counters["deadline_truncated"] += 1
            self.counters["requests_finished"] += 1
        else:
            req.shed_reason = shed_reason
            self.counters["requests_shed"] += 1
            self.counters[f"shed_{shed_reason}"] += 1

    def _admit(self) -> None:
        while self.queue and None in self.slots:
            req = self.queue[0]
            # Expired in the queue: a preempted request that already
            # produced tokens finishes truncated (a prefix of its stream);
            # one that never started is shed.
            if self._expired(req):
                self._finish_queued(req, None if req.generated
                                    else "deadline")
                continue
            # Past the watermark, never-started besteffort requests are
            # shed instead of admitted into a preemption storm.
            if (self.scfg.shed_watermark is not None
                    and req.slo == "besteffort" and not req.generated
                    and self.pool.saturation() > self.scfg.shed_watermark):
                self._finish_queued(req, "watermark")
                continue
            resumed = len(req.generated) > 0
            ctx = np.asarray(req.prompt, np.int32)
            if resumed:
                ctx = np.concatenate(
                    [ctx, np.asarray(req.generated[:-1], np.int32)])
            Lc = len(ctx)
            total = self._blocks_for(req)
            n_ctx = -(-Lc // self._page)
            goal = self._reserve_goal(total, n_ctx)
            # Cheap pre-check before building O(L^2/page) prefix keys.
            max_match = (Lc - (0 if resumed else 1)) // self._page
            if goal - max_match > self.pool.available():
                break
            matched = self._match_prefix(ctx, keep_last=not resumed)
            need = goal - len(matched)
            if need > self.pool.available():
                for bid in matched:
                    self.pool.decref(bid)
                break
            self.queue.popleft()
            self.pool.reserve(need)
            slot = self.slots.index(None)
            row = np.zeros((self._mb,), np.int32)
            row[:len(matched)] = matched
            for j in range(len(matched), n_ctx):
                row[j] = self.pool.alloc(reserved=True)
            hit_len = len(matched) * self._page
            # Fill the claimed context blocks from the memory hierarchy (a
            # host swap record, else the prefix store) instead of
            # recomputing them; without a tier the prefix hit is all.
            cached_len = self._rehydrate(req, row, ctx, len(matched),
                                         hit_len, resumed)
            self.table[slot] = row
            self.lengths[slot] = cached_len
            self.slots[slot] = _PagedSlot(req, next_prefill=cached_len,
                                          blocks_reserved=goal - n_ctx,
                                          ctx=ctx, resumed=resumed,
                                          seq=self._admit_seq)
            self._admit_seq += 1
            if cached_len < Lc:
                self._prefill_fifo.append(slot)
            else:
                # Fully cached resume: decode continues from the last
                # sampled token.
                self.last_token[slot] = int(req.generated[-1])
            if not resumed:
                req.prefill_len = Lc
                req.admitted_step = self._step
            self.counters["prefix_hit_tokens"] += hit_len

    def _prefill_tick(self) -> None:
        """One bucket-padded chunk of the oldest admitted-but-unprefilled
        request; a resumed request prefills its context the same way."""
        if not self._prefill_fifo:
            return
        slot = self._prefill_fifo[0]
        st = self.slots[slot]
        req = st.req
        L = len(st.ctx)
        s = st.next_prefill
        e = min(s + self._chunk, L)
        n = e - s
        Sp = min(self._chunk, -(-n // self.scfg.prefill_bucket)
                 * self.scfg.prefill_bucket)
        tokens = np.zeros((1, Sp), np.int32)
        tokens[0, :n] = st.ctx[s:e]
        positions = np.full((1, Sp), POS_SENTINEL, np.int32)
        positions[0, :n] = np.arange(s, e, dtype=np.int32)
        logits = self._forward(tokens, positions, slice(slot, slot + 1))
        self.lengths[slot] += n
        st.next_prefill = e
        self.counters["prefill_tokens"] += n
        self.counters["prefill_chunks"] += 1

        # Publish newly completed full context blocks for prefix sharing
        # (generated-region blocks of a resumed request share like prompt
        # blocks).
        bs = self._page
        for j in range(s // bs, e // bs):
            key = tuple(int(t) for t in st.ctx[:(j + 1) * bs])
            self.pool.register(key, int(self.table[slot, j]))

        if e == L:
            self._prefill_fifo.popleft()
            if st.resumed:
                # The context's successor was sampled before the preemption:
                # replay it as the next decode input.
                self.last_token[slot] = int(req.generated[-1])
            else:
                tok = int(self._sample_rows(logits[0, n - 1:n], [req.rid],
                                            [0])[0])
                req.generated.append(tok)
                self.last_token[slot] = tok
                self._maybe_evict(slot, tok)

    def _maybe_evict(self, slot: int, tok: int) -> None:
        st = self.slots[slot]
        if st is None:
            return
        req = st.req
        done = len(req.generated) >= req.max_new_tokens
        if self.scfg.eos_id is not None and tok == self.scfg.eos_id:
            done = True
        # Mid-decode deadline: finish truncated after this tick's token.
        if not done and self._expired(req):
            req.deadline_hit = True
            self.counters["deadline_truncated"] += 1
            done = True
        if not done:
            return
        req.finished_step = self._step
        self.counters["requests_finished"] += 1
        for j in range(self._mb):
            bid = int(self.table[slot, j])
            if bid:
                self.pool.decref(bid)
        self.pool.cancel_reservation(st.blocks_reserved)
        self.table[slot] = 0
        self.lengths[slot] = 0
        self.last_token[slot] = 0
        self.slots[slot] = None

    def _decoding(self) -> list[int]:
        return [i for i, st in enumerate(self.slots)
                if st is not None and st.prefilled()]

    def step(self) -> bool:
        """One scheduler tick: admit, one prefill chunk, one decode step
        over every prefilled slot.  Returns False when there is no work."""
        self.ticks += 1
        self._admit()
        self._prefill_tick()
        active = self._decoding()
        if not active:
            return self.pending()
        self._step += 1
        # Materialize the block behind each decoding row's next write.
        # Oversubscribed, a claim may preempt a victim, possibly a row of
        # this tick, which then drops out (requeued, not lost).  Mandatory
        # claims all happen here, so a speculative tick never preempts.
        for i in active:
            if self.slots[i] is None:
                continue
            j = int(self.lengths[i]) // self._page
            if self.table[i, j] == 0:
                self._claim_block(i, j)
        active = self._decoding()
        if not active:
            return True
        if self._drafter is not None:
            self._spec_decode_tick(active)
        else:
            self._plain_decode_tick(active)
        return True

    # ------------------------------------------------------------------
    # the engine API: prefill -> insert -> generate_step (serving/frontdoor
    # builds the async door and prefill/decode disaggregation on it)
    # ------------------------------------------------------------------

    def prefill(self, req: Request) -> Prefix:
        """Engine API step 1: prefill a fresh request's prompt to the end
        and return a :class:`Prefix`: the prompt's paged blocks (their
        references move to the Prefix) and the first sampled token.  It runs
        the ordinary chunked prefill (prefix-registry CoW hits, block
        publication, the first-token sample), so a later ``insert()`` and
        decode give the tokens of serving the request through ``submit()``.

        The slot used for prefilling frees on return; only the blocks stay
        live.  Raises :class:`InsufficientBlocks` (retryable) when the pool
        cannot cover the prompt right now."""
        if req.generated:
            raise ValueError(
                "prefill() takes a fresh request; preemption resume runs "
                "through the scheduler (submit()/step())")
        self._validate_request(req)
        if None not in self.slots:
            raise RuntimeError("prefill() needs a free slot")
        self._register(req)
        req.submitted_tick = self.ticks
        ctx = np.asarray(req.prompt, np.int32)
        L = len(ctx)
        n_ctx = -(-L // self._page)
        matched = self._match_prefix(ctx, keep_last=True)
        need = n_ctx - len(matched)
        if need > self.pool.available():
            for bid in matched:
                self.pool.decref(bid)
            raise InsufficientBlocks(
                f"prompt needs {need} blocks beyond its prefix hits, pool "
                f"has {self.pool.available()}")
        self.pool.reserve(need)
        slot = self.slots.index(None)
        row = np.zeros((self._mb,), np.int32)
        row[:len(matched)] = matched
        for j in range(len(matched), n_ctx):
            row[j] = self.pool.alloc(reserved=True)
        cached = len(matched) * self._page
        self.table[slot] = row
        self.lengths[slot] = cached
        # blocks_reserved=0: prefill writes only the context blocks, all
        # allocated above; the decode tail is reserved at insert() against
        # the decoding engine's pool.
        self.slots[slot] = _PagedSlot(req, next_prefill=cached,
                                      blocks_reserved=0, ctx=ctx,
                                      seq=self._admit_seq)
        self._admit_seq += 1
        req.prefill_len = L
        req.admitted_step = self._step
        self.counters["prefix_hit_tokens"] += cached
        # keep_last leaves at least one token to prefill, so the loop runs
        # and the first token samples in _prefill_tick.
        self._prefill_fifo.appendleft(slot)
        while (self.slots[slot] is not None
               and not self.slots[slot].prefilled()):
            self.ticks += 1
            self._prefill_tick()
        if self.slots[slot] is None:
            # Finished during prefill (max_new_tokens == 1, eos or a
            # deadline): _maybe_evict released every block and the tokens
            # are in req.generated; nothing to hand off.
            last = int(req.generated[-1]) if req.generated else 0
            return Prefix(req=req, chain=ctx, length=0, last_token=last,
                          blocks=[], pool=self.pool, finished=True)
        # Detach: block ownership moves from the slot to the Prefix (the
        # references taken above are kept); the slot frees.
        bids = [int(self.table[slot, j]) for j in range(n_ctx)]
        last = int(self.last_token[slot])
        self.table[slot] = 0
        self.lengths[slot] = 0
        self.last_token[slot] = 0
        self.slots[slot] = None
        self.counters["prefixes_prefilled"] += 1
        return Prefix(req=req, chain=ctx, length=L, last_token=last,
                      blocks=bids, pool=self.pool)

    def extract(self, prefix: Prefix) -> Prefix:
        """Detach a prefix from this engine: copy its blocks' K/V/pos rows
        and the pool-wide quant scales (f32, in the reference's leaf order)
        to host arrays, then drop the block references.  The payload is
        independent of the pool's layout, so a decoding engine with its own
        pool and block numbering can ``insert()`` it.  Registered source
        blocks park in the LRU on decref, so this engine's prefix cache
        stays warm for repeated prompts."""
        if prefix.finished or prefix.payload is not None:
            return prefix
        if prefix.pool is not self.pool:
            raise ValueError(
                "extract() must run on the engine owning the prefix")
        layers = extract_block_rows(self.caches, prefix.blocks,
                                    scan_layers=self.cfg.scan_layers)
        amax = _amax_arrays(self.caches, self.cfg.scan_layers)
        for bid in prefix.blocks:
            self.pool.decref(bid)
        self.counters["prefix_transfers"] += 1
        return dataclasses.replace(prefix, blocks=[], pool=None,
                                   payload={"layers": layers, "amax": amax})

    def release(self, prefix: Prefix) -> None:
        """Drop an attached prefix without inserting it (the client went
        away between prefill and insert).  Detached and finished prefixes
        hold no pool state."""
        if prefix.pool is not self.pool or not prefix.blocks:
            return
        for bid in prefix.blocks:
            self.pool.decref(bid)
        prefix.blocks = []
        prefix.pool = None

    def insert(self, prefix: Prefix, slot: int) -> None:
        """Engine API step 2: mount a prefilled context into a free slot
        and arm it for decode.  An attached (same-pool) prefix splices by
        block handle and moves no KV; a detached one CoW-matches its chain
        against this pool's registry, scatters only the unmatched blocks
        from the payload, and merges the source's quant scales (elementwise
        max) with a rebuild of the packed plane pools, so that every
        resident page means the same integers under the merged grid.

        The slot then holds the post-preemption resume state
        (``resumed=True``, next decode input ``prefix.last_token``), so
        decode, speculation, oversubscription and deadlines behave as if
        the request had always lived here."""
        if not 0 <= slot < len(self.slots):
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {len(self.slots)})")
        if self.slots[slot] is not None:
            raise RuntimeError(
                f"insert into occupied slot {slot} (rid "
                f"{self.slots[slot].req.rid} is live there)")
        if prefix.finished:
            raise ValueError(
                "prefix finished during prefill: nothing to insert")
        req = prefix.req
        if req.rid < 0:
            raise ValueError("prefix carries an unregistered request")
        chain = np.asarray(prefix.chain, np.int32)
        n_ctx = -(-prefix.length // self._page)
        goal = self._reserve_goal(self._blocks_for(req), n_ctx)
        if prefix.pool is self.pool:
            # Attached: the references taken at prefill() move to the slot.
            need = goal - n_ctx
            if need > self.pool.available():
                raise InsufficientBlocks(
                    f"decode tail needs {need} reserved blocks, pool has "
                    f"{self.pool.available()}")
            self.pool.reserve(need)
            row_bids = [int(b) for b in prefix.blocks]
            prefix.blocks = []
            prefix.pool = None
            cached_hit = 0
        else:
            if prefix.payload is None:
                raise ValueError(
                    "cross-engine insert needs a detached prefix: call "
                    "extract() on the source engine first")
            matched = self._match_prefix(chain, keep_last=False)
            need = goal - len(matched)
            if need > self.pool.available():
                for bid in matched:
                    self.pool.decref(bid)
                raise InsufficientBlocks(
                    f"prefix needs {need} blocks beyond its local CoW "
                    f"hits, pool has {self.pool.available()}")
            self.pool.reserve(need)
            sel = list(range(len(matched), n_ctx))
            fresh = [self.pool.alloc(reserved=True) for _ in sel]
            row_bids = [int(b) for b in matched] + fresh
            if fresh:
                splice_block_rows(self.caches, fresh,
                                  prefix.payload["layers"], sel,
                                  scan_layers=self.cfg.scan_layers)
            self._merge_amax(prefix.payload["amax"])
            # Full transferred blocks register under their chain keys; the
            # partial tail block stays exclusively owned and unregistered.
            for j in range(len(matched), prefix.length // self._page):
                key = tuple(int(t) for t in chain[:(j + 1) * self._page])
                self.pool.register(key, row_bids[j])
            cached_hit = len(matched) * self._page
        self._register(req)
        # Deadlines re-anchor at insert: the prefill and decode engines'
        # tick clocks are unrelated when disaggregated, so deadline_ticks
        # bounds decode-side service from here.
        req.submitted_tick = self.ticks
        row = np.zeros((self._mb,), np.int32)
        row[:n_ctx] = row_bids
        self.table[slot] = row
        self.lengths[slot] = prefix.length
        self.last_token[slot] = int(prefix.last_token)
        self.slots[slot] = _PagedSlot(req, next_prefill=prefix.length,
                                      blocks_reserved=goal - n_ctx,
                                      ctx=chain, resumed=True,
                                      seq=self._admit_seq)
        self._admit_seq += 1
        self.counters["prefix_hit_tokens"] += cached_hit
        self.counters["prefixes_inserted"] += 1

    def _merge_amax(self, incoming: list) -> None:
        """Fold another engine's quant-scale leaves into this one's
        (elementwise max) and rebuild the packed plane pools.  It runs on
        every detached insert even when nothing grew: the spliced pages
        carry no plane rows until the requant writes them.  A planeless
        pool has no scales and nothing to do."""
        cur = _amax_arrays(self.caches, self.cfg.scan_layers)
        if len(cur) != len(incoming):
            raise ValueError(
                f"prefix payload carries {len(incoming)} quant-scale "
                f"leaves, cache has {len(cur)}")
        if not cur:
            return
        merged = [np.maximum(c, np.asarray(p, np.float32).reshape(c.shape))
                  for c, p in zip(cur, incoming)]
        _set_amax_leaves(self.caches, merged, self.cfg.scan_layers)
        requant_plane_pools(self.caches)

    def generate_step(self) -> list[dict]:
        """Engine API step 3: one scheduler tick, returning the tokens it
        committed as per-request events ``{"rid", "slot", "tokens",
        "finished"}`` sorted by rid (``slot`` is -1 once the request has
        left its slot).  A preemption emits no event (the requeued
        request's tokens stand); an expiry or a shed emits a terminal event
        with no tokens.  The tokens are ``step()``'s: this is a diff of the
        request registry, not another decode path."""
        before = {rid: (len(r.generated),
                        r.finished_step >= 0 or r.shed_reason is not None)
                  for rid, r in self.requests.items()}
        self.step()
        slot_of = {st.req.rid: i for i, st in enumerate(self.slots)
                   if st is not None}
        events = []
        for rid in sorted(before):
            n0, was_done = before[rid]
            req = self.requests[rid]
            done = req.finished_step >= 0 or req.shed_reason is not None
            toks = [int(t) for t in req.generated[n0:]]
            if toks or (done and not was_done):
                events.append({"rid": rid, "slot": slot_of.get(rid, -1),
                               "tokens": toks, "finished": done})
        return events

    def free_slots(self) -> list[int]:
        """Indices of the unoccupied slots (insert targets)."""
        return [i for i, st in enumerate(self.slots) if st is None]

    # ------------------------------------------------------------------
    # crash-consistent snapshot and restore
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """The engine's host state as plain JSON data, with the reference's
        keys and layout: every request (prompt, tokens, QoS and accounting
        fields), queue and slot occupancy, counters, tick counter, sampling
        seed, the allocator's state and the pool-wide quant scales.  For
        the same trace at the same tick it equals the reference's, but for
        the scales' last bits, which come from each package's own K/V
        projections.

        Device KV is not kept.  Restore rebuilds it through the resume
        path: in-flight requests requeue with their tokens and recompute
        their context by chunked prefill under the restored scales."""
        active = sorted(
            (st.seq, st.req.rid) for st in self.slots if st is not None)
        reqs = []
        for rid in sorted(self.requests):
            r = self.requests[rid]
            reqs.append({
                "rid": rid,
                "prompt": [int(t) for t in r.prompt],
                "max_new_tokens": int(r.max_new_tokens),
                "generated": [int(t) for t in r.generated],
                "deadline_ticks": r.deadline_ticks,
                "slo": r.slo,
                "prefill_len": int(r.prefill_len),
                "admitted_step": int(r.admitted_step),
                "finished_step": int(r.finished_step),
                "preemptions": int(r.preemptions),
                "submitted_tick": int(r.submitted_tick),
                "shed_reason": r.shed_reason,
                "deadline_hit": bool(r.deadline_hit),
            })
        return {
            "version": 1,
            "ticks": int(self.ticks),
            "step": int(self._step),
            "seed": self._seed,
            "next_rid": int(self._next_rid),
            "admit_seq": int(self._admit_seq),
            "counters": {k: int(v) for k, v in self.counters.items()},
            "requests": reqs,
            "queue": [r.rid for r in self.queue],
            "active": [rid for _, rid in active],
            "amax": _amax_state(self.caches, self.cfg.scan_layers),
            "pool": self.pool.snapshot(),
        }

    def restore(self, state: dict) -> None:
        """Rebuild scheduler state from a snapshot (this package's or the
        reference's) into this engine, which must be freshly built: a crash
        took the old one's device KV, so restore starts from a clean pool.

        The quant scales are written back before anything is recomputed
        (:func:`_set_amax_leaves`).  Then the requests that held a slot
        requeue in admission order, followed by the snapshot's queue; the
        ordinary resume path recomputes each context and replays its last
        sampled token."""
        if self.requests or self.ticks or self.pool.live_blocks():
            raise RuntimeError(
                "restore() needs a freshly constructed engine (the crash "
                "destroyed the old one; device KV is recomputed, not "
                "re-mapped)")
        if state.get("version") != 1:
            raise ValueError(f"unknown snapshot version "
                             f"{state.get('version')!r}")
        self.ticks = int(state["ticks"])
        self._step = int(state["step"])
        self._next_rid = int(state["next_rid"])
        self._admit_seq = int(state["admit_seq"])
        if state["seed"] is not None:
            self.begin(int(state["seed"]))
        self.counters.update(state["counters"])
        # The allocator restarts empty; its bookkeeping counters carry over.
        self.pool.peak_live_blocks = int(state["pool"]["peak_live_blocks"])
        self.pool.alloc_count = int(state["pool"]["alloc_count"])
        self.requests = {}
        for d in state["requests"]:
            self.requests[d["rid"]] = Request(
                prompt=np.asarray(d["prompt"], np.int32),
                max_new_tokens=d["max_new_tokens"],
                generated=list(d["generated"]),
                rid=d["rid"],
                deadline_ticks=d["deadline_ticks"],
                slo=d["slo"],
                prefill_len=d["prefill_len"],
                admitted_step=d["admitted_step"],
                finished_step=d["finished_step"],
                preemptions=d["preemptions"],
                submitted_tick=d["submitted_tick"],
                shed_reason=d["shed_reason"],
                deadline_hit=d["deadline_hit"],
            )
        _set_amax_leaves(self.caches, state["amax"], self.cfg.scan_layers)
        for rid in list(state["active"]) + list(state["queue"]):
            self.queue.append(self.requests[rid])

    # ------------------------------------------------------------------
    # KV memory hierarchy: swap-to-host preemption and the prefix store
    # ------------------------------------------------------------------

    def _swap_out(self, slot: int, exclusive: list[int], L: int,
                  req: Request) -> None:
        """Device-to-host copy of a preemption victim's exclusive blocks
        into the swap pool, under its rid.  The record holds the f32
        K/V/pos rows, the packed ``kq`` rows and the scales at swap time:
        what :meth:`_swap_in` needs to splice the context back with no
        recompute.  An injected ``swap_fail``, exclusive blocks that are
        not one run up to the fill level, and a refused put skip the
        record: the victim then resumes by recompute."""
        if (self.chaos is not None
                and self.chaos.fire("swap_fail", self.ticks)):
            # The host copy died in flight: the victim recomputes.
            self.counters["swap_fallbacks"] += 1
            return
        excl = set(exclusive)
        n_used = -(-L // self._page)
        pairs = [(j, int(self.table[slot, j])) for j in range(n_used)
                 if int(self.table[slot, j]) in excl]
        if not pairs:
            return        # every block with tokens is shared: the resume
                          # maps them again from the registry
        js = [j for j, _ in pairs]
        if js != list(range(js[0], n_used)):
            # Shared blocks past the first exclusive one: the record could
            # not splice back as one tail.
            self.counters["swap_fallbacks"] += 1
            return
        bids = [b for _, b in pairs]
        layers = extract_block_rows(self.caches, bids, planes=True,
                                    scan_layers=self.cfg.scan_layers)
        amax = _amax_arrays(self.caches, self.cfg.scan_layers)
        rec = {"js": js, "length": int(L), "layers": layers, "amax": amax}
        nbytes = (sum(int(a.nbytes) for lay in layers for a in lay.values())
                  + sum(int(a.nbytes) for a in amax))
        if self._swap.put(req.rid, rec, nbytes):
            self.counters["swap_outs"] += 1
        else:
            self.counters["swap_fallbacks"] += 1

    def _rehydrate(self, req: Request, row: np.ndarray, ctx: np.ndarray,
                   m: int, cached_len: int, resumed: bool) -> int:
        """After admission claims the context blocks, fill them from a host
        swap record, else from the host or disk prefix store.  Returns the
        new cached length (``cached_len`` when neither applies)."""
        new_len = None
        if self._swap is not None:
            new_len = self._swap_in(req, row, ctx, m, resumed)
        if new_len is None and (self._prefix_host is not None
                                or self.scfg.prefix_store_dir is not None):
            new_len = self._store_inject(req, row, ctx, m, resumed)
        return cached_len if new_len is None else new_len

    def _swap_in(self, req: Request, row: np.ndarray, ctx: np.ndarray,
                 m: int, resumed: bool) -> int | None:
        """Splice a swapped-out victim's record into its freshly claimed
        blocks.

        This engine wrote every swapped value, so the current (monotone)
        scales already cover it: recompute would grow no scale, and the
        splice applies no scale rule.  If no scale grew since the swap-out,
        the stored ``kq`` rows are what incremental packing holds and
        splice as they are; if one grew, recompute's growth requantized the
        whole pool, so repacking the spliced blocks under the current
        scales gives its bytes."""
        rec = self._swap.take(req.rid)
        if rec is None:
            return None
        L, js = rec["length"], rec["js"]
        if not resumed or js[0] != m or L > len(ctx):
            # The registry changed under the record (prefix blocks it
            # relied on were evicted): recompute instead.
            self.counters["swap_fallbacks"] += 1
            return None
        bids = [int(row[j]) for j in range(m, m + len(js))]
        layers = rec["layers"]
        cur = _amax_arrays(self.caches, self.cfg.scan_layers)
        same_scales = (len(cur) == len(rec["amax"]) and all(
            np.array_equal(a, b) for a, b in zip(cur, rec["amax"])))
        if same_scales:
            splice_block_rows(self.caches, bids, layers,
                              scan_layers=self.cfg.scan_layers)
        else:
            stripped = [{k: v for k, v in lay.items() if k != "kq"}
                        for lay in layers]
            splice_block_rows(self.caches, bids, stripped,
                              scan_layers=self.cfg.scan_layers)
            repack_block_planes(self.caches, bids)
        # Full blocks register under their chain keys, as the prefill of
        # [m * page, L) would have registered them.
        bs = self._page
        for j in range(m, L // bs):
            key = tuple(int(t) for t in ctx[:(j + 1) * bs])
            self.pool.register(key, int(row[j]))
        self.counters["swap_ins"] += 1
        self.counters["swap_in_tokens"] += L - m * bs
        return L

    def _store_inject(self, req: Request, row: np.ndarray, ctx: np.ndarray,
                      m: int, resumed: bool) -> int | None:
        """Warm a request's context from the prefix store: walk the chain
        of full context blocks past the registry match, taking host-tier
        records, then disk records; splice the covered rows and replay the
        scale rule on the host with the chunk boundaries chunked prefill
        would use.  Injection stops at the largest chunk boundary that
        stored blocks cover; a fresh request keeps at least one token to
        prefill (its forward samples the first new token)."""
        bs = self._page
        Lc = len(ctx)
        tier, sdir = self._prefix_host, self.scfg.prefix_store_dir
        recs = []
        j = m
        while (j + 1) * bs <= Lc:
            key = tuple(int(t) for t in ctx[:(j + 1) * bs])
            rec = None
            if tier is not None:
                got = tier.get(key)
                if got is not None:
                    rec = got["layers"]
            if rec is None and sdir is not None:
                rec = store.load_prefix_record(sdir, key)
            if rec is None:
                break
            recs.append(rec)
            j += 1
        if not recs:
            return None
        base = m * bs
        cov = (m + len(recs)) * bs
        # The largest chunk boundary min(base + k * chunk, Lc) the records
        # cover; a resumed request may reach Lc (no prefill chunk at all).
        if resumed and cov >= Lc:
            inject_end = Lc
        else:
            hi = min(cov, Lc - 1)
            inject_end = base + ((hi - base) // self._chunk) * self._chunk
        if inject_end <= base:
            return None
        jend = -(-inject_end // bs)
        recs = recs[:jend - m]
        # One record of all blocks: the rows axis is 1 in a stacked entry
        # and 0 otherwise (pos is two ranks slimmer than k and v).
        merged = []
        for li in range(len(recs[0])):
            merged.append({
                f: np.concatenate(
                    [np.asarray(r[li][f]) for r in recs],
                    axis=np.asarray(recs[0][li][f]).ndim
                    - (2 if f == "pos" else 4))
                for f in ("k", "v", "pos")})
        bids = [int(row[jj]) for jj in range(m, jend)]
        splice_block_rows(self.caches, bids, merged,
                          scan_layers=self.cfg.scan_layers)
        # The stored values may be new to this engine and growth depends on
        # the order of writes, so the scale rule replays per chunk group.
        groups = []
        s = base
        while s < inject_end:
            e = min(s + self._chunk, inject_end)
            groups.append([(jj - m, max(s, jj * bs) - jj * bs,
                            min(e, (jj + 1) * bs) - jj * bs)
                           for jj in range(s // bs, -(-e // bs))])
            s = e
        _, k_grew = apply_inject_amax_rule(self.caches, merged, groups,
                                           scan_layers=self.cfg.scan_layers)
        if k_grew:
            # Recompute's last growth requantizes the whole pool.
            requant_plane_pools(self.caches)
        else:
            repack_block_planes(self.caches, bids)
        for jj in range(m, inject_end // bs):
            key = tuple(int(t) for t in ctx[:(jj + 1) * bs])
            self.pool.register(key, int(row[jj]))
        self.counters["prefix_store_hits"] += len(recs)
        self.counters["prefix_store_tokens"] += inject_end - base
        return inject_end

    def _on_prefix_evict(self, key: tuple, bid: int) -> None:
        """The pool's evict hook: a parked registered block is taken for
        reuse, so its rows copy down the hierarchy (the host tier, which
        cascades to disk) before the new owner writes them."""
        if getattr(self, "caches", None) is None:
            return
        layers = extract_block_rows(self.caches, [bid],
                                    scan_layers=self.cfg.scan_layers)
        rec = {"chain": key, "layers": layers}
        nbytes = sum(int(a.nbytes) for lay in layers for a in lay.values())
        self.counters["prefix_spills"] += 1
        if self._prefix_host is not None:
            self._prefix_host.put(key, rec, nbytes)
        else:
            self._spill_prefix_record(key, rec, nbytes)

    def _spill_prefix_record(self, key, rec, nbytes) -> None:
        """The bottom of the cascade: persist a prefix record to the disk
        store.  An injected ``checkpoint_interrupt`` drops the record and
        leaves a staging orphan for GC; any other error propagates."""
        if self.scfg.prefix_store_dir is not None:
            self._persist(key, rec["layers"])

    def _persist(self, key, layers) -> bool:
        """Save one prefix record to the disk store; False when an injected
        ``checkpoint_interrupt`` killed the write (counted)."""
        try:
            store.save_prefix_record(self.scfg.prefix_store_dir, list(key),
                                     layers, interrupt=self._store_interrupt)
            return True
        except CheckpointInterrupted:
            self.counters["prefix_store_interrupts"] += 1
            return False

    def _store_interrupt(self) -> None:
        if (self.chaos is not None
                and self.chaos.fire("checkpoint_interrupt", self.ticks)):
            raise CheckpointInterrupted(
                f"prefix-store write killed at tick {self.ticks}")

    def flush_prefixes(self) -> int:
        """Persist every registered prefix block and every host-tier record
        to the prefix store: the graceful-shutdown half of warm restarts.
        Chains already stored are left as they are.  Returns the number of
        records written or found present."""
        if self.scfg.prefix_store_dir is None:
            raise RuntimeError(
                "flush_prefixes() needs ServeConfig.prefix_store_dir")
        n = 0
        for key, bid in self.pool.registered_items():
            n += self._persist(key, extract_block_rows(
                self.caches, [bid], scan_layers=self.cfg.scan_layers))
        if self._prefix_host is not None:
            for key, rec in self._prefix_host.items():
                n += self._persist(key, rec["layers"])
        return n

    def memory_report(self) -> dict:
        """Bytes held at each tier of the KV memory hierarchy.
        :meth:`kv_bytes_resident` counts the device alone; the host and
        disk tiers report on their own, so no token's bytes count twice."""
        def tier(pool, field):
            return int(getattr(pool, field)) if pool is not None else 0

        rep = {
            "device_bytes": int(self.kv_bytes_resident(peak=False)),
            "device_bytes_peak": int(self.kv_bytes_resident(peak=True)),
            "host_swap_bytes": tier(self._swap, "bytes_used"),
            "host_swap_bytes_peak": tier(self._swap, "peak_bytes"),
            "host_prefix_bytes": tier(self._prefix_host, "bytes_used"),
            "host_prefix_bytes_peak": tier(self._prefix_host, "peak_bytes"),
            "disk_prefix_bytes": 0,
        }
        if self.scfg.prefix_store_dir is not None:
            rep["disk_prefix_bytes"] = int(
                store.prefix_store_bytes(self.scfg.prefix_store_dir))
        return rep

    # ------------------------------------------------------------------
    # oversubscription: victim preemption and lossless requeue
    # ------------------------------------------------------------------

    def _freeable_blocks(self, slot: int) -> int:
        """Capacity preempting this slot would release: its exclusively
        held table entries plus its unclaimed reservation units."""
        st = self.slots[slot]
        n = st.blocks_reserved
        for j in range(self._mb):
            bid = int(self.table[slot, j])
            if bid and self.pool.refcount(bid) == 1:
                n += 1
        return n

    _SLO_RANK = {"besteffort": 0, "standard": 1, "strict": 2}

    def _select_victim(self, needy: int) -> int | None:
        """The slot to preempt so ``needy`` can claim a block: the lowest
        SLO class, then the most deadline slack, then ``preempt_policy``
        (fewest generated tokens, or the newest admission).  Slots whose
        preemption would free nothing are never chosen."""
        cands = [i for i, st in enumerate(self.slots)
                 if st is not None and i != needy
                 and self._freeable_blocks(i) > 0]
        if not cands:
            return None

        def vkey(i):
            st = self.slots[i]
            req = st.req
            ddl = self._deadline_of(req)
            slack = (float("inf") if ddl is None
                     else req.submitted_tick + ddl - self.ticks)
            if self.scfg.preempt_policy == "lifo":
                pol = (-st.seq,)
            else:
                pol = (len(req.generated), -st.seq)
            return (self._SLO_RANK.get(req.slo, 1), -slack) + pol

        return min(cands, key=vkey)

    def _preempt(self, slot: int) -> None:
        """Evict a running request and requeue it.  Exclusive blocks free
        outright; shared or registered blocks drop a reference and stay
        mapped or park in the LRU, so the resume re-maps them and
        recomputes only the unshared tail.  ``generated`` is kept: its keys
        are a pure function of (seed, rid, token index)."""
        st = self.slots[slot]
        req = st.req
        L = int(self.lengths[slot])
        exclusive, shared, dropped = [], [], 0
        for j in range(self._mb):
            bid = int(self.table[slot, j])
            if not bid:
                continue
            if (self.pool.refcount(bid) == 1
                    and not self.pool.is_registered(bid)):
                exclusive.append(bid)
                dropped += max(0, min(L - j * self._page, self._page))
            else:
                shared.append(bid)
        # Swap-to-host: copy the exclusive blocks to a host record before
        # they free, so that the resume splices instead of recomputing.  A
        # victim still in its first prefill resumes as a fresh admission.
        if self._swap is not None and req.generated and exclusive:
            self._swap_out(slot, exclusive, L, req)
        self.pool.preempt(exclusive)
        for bid in shared:
            self.pool.decref(bid)
        self.pool.cancel_reservation(st.blocks_reserved)
        self.table[slot] = 0
        self.counters["preempt_dropped_tokens"] += dropped
        self.lengths[slot] = 0
        self.last_token[slot] = 0
        self.slots[slot] = None
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        req.preemptions += 1
        self.counters["preemptions"] += 1
        self.counters["preempt_freed_blocks"] += len(exclusive)
        # Preempted requests resume ahead of never-admitted ones, in rid
        # order among themselves.
        pos = 0
        for r in self.queue:
            if r.preemptions > 0 and r.rid < req.rid:
                pos += 1
            else:
                break
        self.queue.insert(pos, req)

    def _claim_block(self, slot: int, j: int, optional: bool = False) -> int:
        """Materialize table entry j: out of the slot's reservation while
        one remains, else (oversubscribed only) from spare capacity,
        preempting victims until a block is free.  ``optional`` marks a
        speculative draft-block claim; its caller has checked that a block
        is free, so it never preempts."""
        st = self.slots[slot]
        if st.blocks_reserved > 0:
            bid = self.pool.alloc(reserved=True)
            st.blocks_reserved -= 1
        else:
            if not self.scfg.oversubscribe:
                raise RuntimeError(
                    "paged scheduler invariant violated: slot "
                    f"{slot} needs a decode block but has no reservation")
            # Injected pool-dry: force one preemption although the pool has
            # room.  With no victim the forced dryness is dropped rather
            # than wedging a healthy pool.  A draft-block claim skips the
            # consult: the speculative tick consults it itself.
            if (not optional and self.chaos is not None
                    and self.chaos.fire("pool_dry", self.ticks)):
                victim = self._select_victim(needy=slot)
                if victim is not None:
                    self._preempt(victim)
                    self.counters["forced_preemptions"] += 1
            while self.pool.available() < 1:
                victim = self._select_victim(needy=slot)
                if victim is None:
                    raise RuntimeError(
                        "oversubscribed pool wedged: no preemptable victim "
                        f"can free a block for slot {slot}")
                self._preempt(victim)
            bid = self.pool.alloc()
        self.table[slot, j] = bid
        return bid

    def _plain_decode_tick(self, active: list[int]) -> None:
        """One decode step over every prefilled slot; rows still
        prefilling (or empty) decode at the pad sentinel and their cache
        writes are dropped.  Every active row's next-write block was
        claimed in :meth:`step`."""
        positions = np.full((len(self.slots), 1), POS_SENTINEL, np.int32)
        for i in active:
            positions[i, 0] = self.lengths[i]
        logits = self._guarded_decode(self.last_token[:, None], positions,
                                      slice(None))
        rids = [st.req.rid if st is not None else 0 for st in self.slots]
        counts = [len(st.req.generated) if st is not None else 0
                  for st in self.slots]
        toks = self._sample_rows(logits[:, -1], rids, counts)
        self.counters["decode_steps"] += 1
        self.counters["decode_slot_steps"] += len(self.slots)
        self.counters["decode_kv_tokens"] += sum(
            int(self.lengths[i]) + 1 for i in active)
        for i in active:
            req = self.slots[i].req
            req.generated.append(int(toks[i]))
            self.counters["decode_tokens"] += 1
            self.lengths[i] += 1
            self.last_token[i] = toks[i]
            self._maybe_evict(i, int(toks[i]))

    def _return_draft_blocks(self, slot: int,
                             blocks: list[tuple[int, int, bool]]) -> None:
        """Return unused speculative blocks ``(table index, block,
        reserved)`` the way they came: one claimed from the slot's
        reservation rolls back with its unit re-credited to the slot; one
        claimed from oversubscribed spare capacity frees outright."""
        reserved = [bid for _, bid, r in blocks if r]
        spare = [bid for _, bid, r in blocks if not r]
        if reserved:
            self.pool.rollback(reserved)
            self.slots[slot].blocks_reserved += len(reserved)
        if spare:
            self.pool.rollback(spare, reserve=False)

    def _spec_decode_tick(self, active: list[int]) -> None:
        """One speculative decode step: draft, verify, accept, roll back.

        Query i of slot b runs at position ``lengths[b] + i`` against
        exactly the KV set and quant scales the non-speculative engine
        would have there (a write that grows a scale bails out), and its
        token is sampled under the same (seed, rid, token index) key.
        Token i+1 is kept only if draft i+1 equals the token just sampled,
        i.e. iff plain decoding would have fed the same input.  So the
        first divergence ends acceptance and the rest is rolled back."""
        k = self.scfg.draft_k
        # An injected drafter death costs the tick its drafts, never the
        # trace: with no draft anywhere the tick decodes plain.
        drafter_down = (self.chaos is not None
                        and self.chaos.fire("drafter_fail", self.ticks))
        if drafter_down:
            self.counters["drafter_failures"] += 1
        drafts: dict[int, list[int]] = {}
        for i in active:
            req = self.slots[i].req
            # Stay within the request's worst-case footprint.
            cap = min(k, req.max_new_tokens - len(req.generated) - 1)
            if drafter_down or cap <= 0:
                drafts[i] = []
                continue
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.generated, np.int32)])
            try:
                drafts[i] = [int(t)
                             for t in self._drafter.propose(ctx, cap)][:cap]
            except Exception:
                # A failing drafter costs this slot its drafts for the tick,
                # never the engine.
                self.counters["drafter_failures"] += 1
                drafts[i] = []
        if not any(drafts[i] for i in active):
            self._plain_decode_tick(active)
            return
        self.counters["spec_ticks"] += 1
        table_snap = self.table.copy()

        Sq = k + 1
        B = len(self.slots)
        tokens = np.zeros((B, Sq), np.int32)
        positions = np.full((B, Sq), POS_SENTINEL, np.int32)
        new_blocks: dict[int, list[tuple[int, int, bool]]] = {}
        for i in active:
            st = self.slots[i]
            row = [int(self.last_token[i])] + drafts[i]
            base = int(self.lengths[i])
            new_blocks[i] = []
            # Blocks past the row's first only hold draft tokens: claim them
            # from the reservation or, oversubscribed, from spare capacity,
            # never by preemption; truncate the draft when none is left.  An
            # injected pool-dry on an unreserved claim truncates it too.
            for j in range(base // self._page + 1,
                           (base + len(row) - 1) // self._page + 1):
                if self.table[i, j] != 0:
                    continue
                reserved = st.blocks_reserved > 0
                forced_dry = (not reserved and self.chaos is not None
                              and self.chaos.fire("pool_dry", self.ticks))
                if not forced_dry and (
                        reserved or (self.scfg.oversubscribe
                                     and self.pool.available() >= 1)):
                    new_blocks[i].append(
                        (j, self._claim_block(i, j, optional=True),
                         reserved))
                else:
                    keep = j * self._page - base
                    row = row[:keep]
                    drafts[i] = drafts[i][:keep - 1]
                    break
            tokens[i, :len(row)] = row
            positions[i, :len(row)] = base + np.arange(len(row))

        logits, new_caches, grew, undo = self._guarded_verify(tokens,
                                                              positions)
        if grew:
            # A draft token grew a pool-wide quant scale: earlier queries
            # were scored under a scale plain decoding would not have had
            # yet.  Put the pools back and replay the tick plain.
            undo()
            self.table = table_snap
            for i in active:
                self._return_draft_blocks(i, new_blocks[i])
            self.counters["spec_bailouts"] += 1
            self._plain_decode_tick(active)
            return

        self.caches = new_caches
        # Row (i, x) samples under token index len(generated_i) + x.
        rids = np.zeros((B, Sq), np.int32)
        counts = np.zeros((B, Sq), np.int32)
        for i in active:
            rids[i, :] = self.slots[i].req.rid
            counts[i, :] = len(self.slots[i].req.generated) + np.arange(Sq)
        toks = self._sample_rows(logits.reshape(B * Sq, -1),
                                 rids.reshape(-1),
                                 counts.reshape(-1)).reshape(B, Sq)
        self.counters["decode_steps"] += 1
        self.counters["decode_slot_steps"] += len(self.slots)
        self.counters["decode_kv_tokens"] += sum(
            int(self.lengths[i]) + 1 + len(drafts[i]) for i in active)
        for i in active:
            req = self.slots[i].req
            d, t = drafts[i], toks[i]
            a = 0
            while a < len(d) and d[a] == int(t[a]):
                a += 1
            emitted = [int(t[x]) for x in range(a + 1)]
            if self.scfg.eos_id is not None and self.scfg.eos_id in emitted:
                emitted = emitted[:emitted.index(self.scfg.eos_id) + 1]
            emitted = emitted[:req.max_new_tokens - len(req.generated)]
            req.generated.extend(emitted)
            self.counters["decode_tokens"] += len(emitted)
            self.counters["spec_proposed"] += len(d)
            self.counters["spec_accepted"] += a
            self.lengths[i] += len(emitted)
            self.last_token[i] = emitted[-1]
            # Blocks wholly past the new fill level hold no live token.
            # Only this tick's claims can lie there, so prompt and shared
            # prefix blocks are out of reach (kv_pool.rollback checks it).
            last_j = (int(self.lengths[i]) - 1) // self._page
            stale = [blk for blk in new_blocks[i] if blk[0] > last_j]
            for j, _, _ in stale:
                self.table[i, j] = 0
            self._return_draft_blocks(i, stale)
            self._maybe_evict(i, emitted[-1])


class StaticBucketEngine:
    """The static batcher: prompts bucketed by exact length, one batch per
    bucket on a shared-cursor cache.  Kept as the baseline that the
    reference's ``benchmarks/serve_throughput.py`` compares against.
    Bucket ``bi`` (in order of length) samples under ``fold_in(seed,
    bi)``, step i under ``fold_in(that, i)``, one key for the whole batch.
    ``device=None`` serves on the CUDA card and raises if there is
    none."""

    def __init__(self, cfg: ModelConfig, params,
                 scfg: ServeConfig = ServeConfig(), device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg

    def init_caches(self, batch: int):
        return T.init_caches(self.cfg, batch, self.scfg.max_len,
                             device=self.device)

    def _sample(self, logits: torch.Tensor, key) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return categorical_block(key, logits, self.scfg.temperature)

    def generate(self, requests: list[Request], seed: int = 0):
        """Serve requests bucketed by prompt length, one batch at a time."""
        base_key = prng_key(seed).numpy()
        buckets: dict[int, list[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        for bi, (_, batch) in enumerate(sorted(buckets.items())):
            self._generate_batch(batch, fold_in(base_key, bi))
        return requests

    @torch.no_grad()
    def _generate_batch(self, requests: list[Request], key):
        prompts = torch.as_tensor(np.stack([r.prompt for r in requests]),
                                  device=self.device)
        B, S = prompts.shape
        caches = self.init_caches(B)
        logits, caches, _ = T.forward(
            self.params, prompts, self.cfg, caches=caches,
            positions=torch.arange(S, device=self.device))
        max_new = max(r.max_new_tokens for r in requests)
        token = self._sample(logits[:, -1], fold_in(key, 0))
        for r, t in zip(requests, token.tolist()):
            r.generated.append(int(t))
        for i in range(1, max_new):
            logits, caches, _ = T.forward(
                self.params, token[:, None], self.cfg, caches=caches,
                positions=torch.tensor([S + i - 1], dtype=torch.int32,
                                       device=self.device))
            token = self._sample(logits[:, -1], fold_in(key, i))
            for r, t in zip(requests, token.tolist()):
                if len(r.generated) < r.max_new_tokens:
                    r.generated.append(int(t))
        return requests


# ---------------------------------------------------------------------------
# measured sparsity of one prompt's prefill attention (layer 0)
# ---------------------------------------------------------------------------


@torch.no_grad()
def _prompt_sparsity(cfg: ModelConfig, params, prompt: np.ndarray):
    p0 = _first_attn_params(params, cfg)
    if p0 is None:
        return {}
    dev = params["embed"]["table"].device
    ids = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)[None]
    x = embed(params["embed"], ids).to(cfg.activation_dtype)
    acfg = cfg.attn_config(False)
    pos = torch.arange(x.shape[1], device=dev)
    q = rope(linear(p0["wq"], x), pos[None], acfg.rope_theta)
    k = rope(linear(p0["wk"], x), pos[None], acfg.rope_theta)
    v = linear(p0["wv"], x)
    G = acfg.n_heads // acfg.n_kv_heads
    kr = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vr = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    S = qt.shape[-2]
    # Small q tiles: a kv block stops fetching planes only when every query
    # row of the tile agrees, so tall tiles cannot terminate.  The serving
    # forward's pad-to-tile rule; padding is masked out, and blocks with no
    # unmasked pair are left out of the means rather than counted as free.
    bq, pad_q = attention_block_shape(S, 8)
    bk, pad_k = attention_block_shape(S, 16)
    mask2d = torch.zeros((S + pad_q, S + pad_k), dtype=torch.bool,
                         device=dev)
    mask2d[:S, :S] = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                           device=dev))
    if pad_q:
        qt = torch.nn.functional.pad(qt, (0, 0, 0, pad_q))
    if pad_k:
        kr = torch.nn.functional.pad(kr, (0, 0, 0, pad_k))
        vr = torch.nn.functional.pad(vr, (0, 0, 0, pad_k))
    res = block_bitstopper_attention(qt, kr, vr, cfg=cfg.bitstopper,
                                     block_q=bq, block_k=bk, mask=mask2d)
    rounds = res.stats.rounds_per_block.cpu().numpy().astype(np.float64)
    alive = res.stats.block_alive.cpu().numpy()
    surv = res.stats.survivors.cpu().numpy()[..., :S, :S]
    n_qt, n_kb = rounds.shape[-2], rounds.shape[-1]
    live = mask2d.cpu().numpy().reshape(n_qt, bq, n_kb, bk).any((1, 3))
    live = np.broadcast_to(live, rounds.shape)
    return {
        "prompt_len": int(prompt.shape[0]),
        "mean_rounds": float(rounds[live].mean()),
        "plane_fraction": float(rounds[live].mean() / cfg.bitstopper.bits),
        "block_alive_fraction": float(alive[live].mean()),
        "survivor_fraction": float(surv.mean()),
        "n_blocks": int(live.sum()),
        "n_pairs": int(surv.size),
    }


def _first_attn_params(params, cfg: ModelConfig):
    """The first attention layer's parameters (the port keeps one dict per
    rep of a segment, so no stacked axis to index)."""
    for si, (unit, _) in enumerate(cfg.segments):
        for i, spec in enumerate(unit):
            if spec.mixer in ("attn", "local_attn"):
                return params[f"seg{si}"][0][f"b{i}"]["attn"]
    return None

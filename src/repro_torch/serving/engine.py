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

Not ported yet (each is a queue A item in ROADMAP.md): the swap and
prefix-store tiers, ``memory_report``, the engine API, mesh sharding, the
bf16 cache, and the contiguous and static engines.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import paged_decode
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.attention import (POS_SENTINEL, PagedLayout,
                                          undo_paged_write)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.chaos import KernelFault
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.sampling import prng_key, sample_tokens


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
    groups = []
    for seg in sorted(caches):
        units = caches[seg]
        stacked = scan_layers and len(units) > 1
        for reps in ([units] if stacked else [[u] for u in units]):
            for b in sorted(reps[0]):
                for key in ("k_amax", "v_amax"):
                    if key in reps[0][b]:
                        groups.append([u[b][key] for u in reps])
    return groups


def _amax_leaves(caches, scan_layers: bool = True) -> list[torch.Tensor]:
    """Every layer's ``k_amax``/``v_amax``, in the order of
    :func:`_amax_groups` (the growth probe of a speculative draft-block
    write, and the snapshot's scales)."""
    return [t for g in _amax_groups(caches, scan_layers) for t in g]


def _amax_state(caches, scan_layers: bool) -> list:
    """The scales as the reference's snapshot holds them: one f32 list per
    leaf of :func:`_amax_groups` (nested over reps where it stacks)."""
    out = []
    for g in _amax_groups(caches, scan_layers):
        a = np.stack([t.cpu().numpy() for t in g])
        out.append(np.asarray(a if len(g) > 1 else a[0],
                              np.float32).tolist())
    return out


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


def _kv_bytes_per_token(cfg: ModelConfig) -> int:
    """f32 K/V bytes plus, with the fused kernel, packed plane bytes that
    one cached token costs across all attention layers."""
    total = 0
    for unit, reps in cfg.segments:
        for spec in unit:
            acfg = cfg.attn_config(spec.mixer == "local_attn")
            total += reps * 2 * acfg.n_kv_heads * acfg.head_dim * 4
            if acfg.fused_decode:
                total += (reps * acfg.bitstopper.bits * acfg.n_kv_heads
                          * acfg.head_dim) // 8
    return total


class PagedEngine:
    """Continuous batching over a paged block-pool KV cache.

    ``device=None`` serves on the CUDA card and raises if there is none;
    tests pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params,
                 scfg: ServeConfig = ServeConfig(), device=None,
                 drafter=None):
        mixers = {spec.mixer for unit, _ in cfg.segments for spec in unit}
        if mixers - {"attn", "local_attn"}:
            raise ValueError(f"paged serving needs attention mixers, got "
                             f"{sorted(mixers)}")
        if cfg.attn_impl not in ("bitstopper", "bitstopper_xla"):
            raise NotImplementedError(
                f"attn_impl {cfg.attn_impl!r}: the port serves the "
                f"BitStopper score path only (ROADMAP A10)")
        self.device = resolve_device(device)
        fused = scfg.fused_decode
        if fused is None:
            fused = self.device.type == "cuda" and scfg.page_size % 8 == 0
        if fused:
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
            if scfg.page_size % 8:
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
        self.pool = KVBlockPool(self.layout.pool_blocks, self._page,
                                prefix_sharing=scfg.prefix_sharing)
        B = scfg.max_slots
        self.caches = T.init_caches(self.cfg, B, self.layout,
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
                         # The tiers of the engine API, swap and the prefix
                         # store are not ported (ROADMAP A7.3, A8): their
                         # counters stay 0, and a snapshot carries the
                         # reference's keys.
                         "prefixes_prefilled": 0, "prefixes_inserted": 0,
                         "prefix_transfers": 0,
                         "swap_outs": 0, "swap_ins": 0,
                         "swap_fallbacks": 0, "swap_in_tokens": 0,
                         "prefix_spills": 0, "prefix_store_hits": 0,
                         "prefix_store_tokens": 0,
                         "prefix_store_interrupts": 0}

    # ------------------------------------------------------------------
    # tick loop
    # ------------------------------------------------------------------

    def begin(self, seed: int = 0) -> None:
        """Fix the sampling seed for a serving run (split out of
        :meth:`run` so a caller, such as ``serve_with_chaos``, can own the
        tick loop; a restored engine derives the same key again)."""
        self._seed = seed
        self._base_key = prng_key(seed).numpy()

    def pending(self) -> bool:
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

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

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
        grew = bool(torch.stack([
            (n > o).any() for o, n in zip(_amax_leaves(self.caches),
                                          _amax_leaves(new))]).any())

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
        amax = 0
        if self._page % 8 == 0:          # a planeless pool keeps no scales
            amax = sum(reps * 2 * self.cfg.n_kv_heads * 4 * len(unit)
                       for unit, reps in self.cfg.segments)
        return blocks * self._page * _kv_bytes_per_token(self.cfg) + amax

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
            # No swap or prefix-store tier is ported: the cached context is
            # the prefix hit.
            hit_len = len(matched) * self._page
            self.table[slot] = row
            self.lengths[slot] = hit_len
            self.slots[slot] = _PagedSlot(req, next_prefill=hit_len,
                                          blocks_reserved=goal - n_ctx,
                                          ctx=ctx, resumed=resumed,
                                          seq=self._admit_seq)
            self._admit_seq += 1
            if hit_len < Lc:
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

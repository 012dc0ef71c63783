#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

``python3 chip_smoke.py`` from the root of a checkout.  It builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` (into
``build/``, one ``nvcc`` per source, all started together), then:

1. device: requires CUDA, prints the card and its power limit, turns TF32
   off for matmuls and convolutions;
2. kernels: runs every kernel of the served paths against its plain
   PyTorch version at their shapes (integer observables exactly equal,
   float output within a stated tolerance), each real query of the verify
   kernel against the decode kernel at its position, and times them (the
   decode and verify kernels also alone, on operands prepared once; the
   plane and V bytes each counts as requested are held to its design);
3. main path: serves greedy requests with full-width ``stablelm-1.6b``
   (seeded random weights, built once) through
   ``repro_torch.serving.PagedEngine``, checks that every decode tick
   launched the decode kernel once per layer, and that a short trace gives
   the same tokens with the kernel and with the plain oracle;
4. speculative path: serves the main path's trace again with speculative
   decoding (a drafter that replays the recorded tokens) and a
   repeated-pattern trace with the n-gram drafter; both must give the
   plain run's tokens, and every verify forward must launch the verify
   kernel once per layer.  A short trace at cut depth gives the same tokens
   with the kernels and with the plain oracles;
5. uncached kernels: ``bitstopper_qk`` and ``flash_attention`` against
   their plain versions at one layer's shapes of the cache-free forward
   (B=2 x 32 heads, S=1024, d=64), timed beside their bounds and, for
   flash, beside ``scaled_dot_product_attention``; ``bitstopper_qk`` on
   hot inputs (LATS prunes) and unpruned ones, with the plane and V bytes
   it counted as requested held to its design's figure;
6. forward path: full-width, full-depth ``stablelm-1.6b``
   ``transformer.forward`` with no caches over 2 prompts of 1024 tokens at
   every attention impl; each kernel impl must launch its kernel once per
   layer, and its logits must agree with the plain impl's (same argmax at
   every position);
7. sampled path: (a) the seeded sampler on the card against the CPU on
   [20, 100352] logits (key words, random bits and uniforms bit-equal,
   tokens equal); (b) the main path's trace sampled at temperature 0.7,
   uncontended and oversubscribed on a pool too small for the worst-case
   reservations: at least one preemption, the uncontended run's tokens,
   one decode launch per layer per decode tick in both runs; (c)
   speculative serving at temperature 0.7 with drafts replaying (b)'s
   tokens, and with the n-gram drafter on the speculative phase's
   repeated-pattern trace, gives the plain sampled tokens.  Prints tokens/s, the sampled and greedy decode
   ticks, preemptions and recomputed tokens, and the sampler's ms and
   launches per tick;
8. chaos path: (a) the main trace, greedy, through
   ``serving.serve_with_chaos`` on an oversubscribed engine with a snapshot
   every 8 ticks, under a crash mid-prefill, a forced pool-dry preemption,
   an interrupted snapshot write, a kernel fault (the circuit breaker
   switches that engine to the plain oracle) and a crash three ticks
   later: the main path's tokens, the plan fired whole, one degradation,
   decode launches 24 x the decode forwards of engines on the kernel;
   (b) the speculative phase's n-gram trace at the cut depth (4) of its
   fused-vs-plain check, drafted as there by replaying the plain tokens,
   under a drafter failure and a crash among its verify ticks: its plain
   tokens at that depth; (c) a short serve at
   page_size=12, a planeless pool, with no paged kernel launched.  Prints
   the wall time of each restore and what it recomputed, snapshot bytes
   and ms per write, and degraded against fused tick times;
9. memory path: (a) the sampled path's oversubscribed run again with a
   swap tier (``swap_host_bytes``): the victim swaps out and back in, with
   the uncontended tokens, fewer prefill chunks than the recompute run, the
   swap pool empty at the end and one decode launch per layer per tick;
   (b) a 256-token system prompt with four tails, greedy at one slot: a
   cold engine on an empty prefix store flushes its registered blocks, and
   a fresh warm engine on that store gives the cold tokens, every scale and
   every plane byte equal, with fewer prefill chunks; (b') the same at four
   slots, measured only (tokens equal or not, the largest relative gap
   between the grids); (c) at cut depth 4, a snug pool with a host prefix
   tier of about one record spills to disk, and a warm engine on the store
   gives a cold one's tokens.  Prints ms and bytes per swap-out and
   swap-in and per prefix record written and loaded, and
   ``memory_report()`` after (a) and (c);
10. front door path: (a) the main trace submitted to an
   ``AsyncFrontDoor`` over a paged engine and streamed: the main path's
   tokens, admission in arrival order, the pool drained, one decode launch
   per layer per tick; (b) the same through a ``DisaggController`` (a
   one-slot prefill engine hands detached prefixes to a four-slot decode
   engine): the main path's tokens, 8 prefixes of 147 blocks and 147 x
   6,292,992 payload bytes, both pools drained, decode launches 24 x the
   decode engine's ticks and none by the prefill engine; (c) at cut depth
   4, the ``prefill -> insert -> generate_step`` loop gives
   ``generate()``'s tokens, and a door stopped by ``shutdown("snapshot")``
   restores in a fresh door whose streams replay to the undisturbed
   tokens; (d) ``sparsity_report`` of the 8 prompts (measured).  Prints
   the ticks, first-token and finish ticks per request, ms per
   ``prefill``/``extract``/``insert`` and ``kv_bytes_contiguous_equiv``;
11. wide kernels (C1): ``bitstopper_qk`` and ``flash_attention`` at head
   widths 256/256 and 192/128 (recurrentgemma-2b, deepseek-v3's MLA)
   against their plain versions (``bitstopper_qk`` bit-equal on rounds,
   survivors and out, its byte counts as designed; flash within
   UNCACHED_TOL), each timed beside its bound; large pages (C3): the
   decode and verify kernels at pages of 512 and 1024 tokens (their
   striped walk) against their plain versions (rounds, survivors and
   v_fetched equal, each verify query equal to the decode, byte counts as
   designed, and on pages that die whole 50 launches each equal to
   plain), timed; these two run right after the kernel phases; after the
   main path, ``PagedEngine`` at pages of 512 (cut depth 4) serves the
   same tokens with the kernel and with the plain oracle, one launch per
   layer per decode tick;
12. dense path (last): the main trace at full width and depth through (a)
   ``PagedEngine`` on ``attn_impl="xla"``, (b) ``ContinuousBatchingEngine``
   on ``xla`` (its tokens equal (a)'s, or first differ at a near-tie of
   (a)'s logits: a gap of at most 1e-3 of max |logit|), (c)
   ``ContinuousBatchingEngine`` on ``bitstopper_xla`` (agreement with the
   main path printed), (d) ``StaticBucketEngine`` on ``xla`` sampled at
   0.7 (its sampler's first key, bits and tokens equal to the CPU's) and
   (e) the contiguous cache's resident bytes against the paged pool's
   peak; no kernel of the port launches on it;
13. prints one JSON line describing each kernel, then the device line
   last.

Any failed check exits non-zero.  Without a card it exits non-zero and
prints no result.  ``--profile`` instead profiles decode ticks, a prefill
chunk, verify ticks and one cache-free forward with each attention kernel
(device time by kernel, busy share).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 tensor-core peak
FP16_OPS_PER_S = 9.89e14         # dense fp16 tensor cores: the cheapest
                                 # type that keeps an INT12 x 1-bit dot exact
F32_OPS_PER_S = 6.7e13           # f32 CUDA cores
TF32_OPS_PER_S = 4.947e14        # dense TF32 tensor cores: one TF32 product
                                 # breaks the reference's f32 tolerance,
SPLIT_TF32_OPS_PER_S = TF32_OPS_PER_S / 3   # the three-product split
                                 # (hi*hi + hi*lo + lo*hi) keeps it
OUT_TOL = 1e-5                   # kernel vs plain output: expf and the sum
                                 # order differ, integers are exact
L2_FLUSH_BYTES = 128 * 2**20     # written before each timed call (L2: 50 MB)
SPEC_K = 4                       # drafts per slot and tick
UNCACHED_TOL = 2e-5              # bitstopper_qk / flash vs plain output
FWD_B, FWD_S = 2, 1024           # the forward path's prompts
KERNELS = ("paged_decode", "paged_verify", "bitstopper_qk",
           "flash_attention")
TEMPERATURE, SAMPLE_SEED = 0.7, 7  # the sampled path's
# Physical blocks of the sampled path's oversubscribed run (null block
# included).  The schedule depends only on the prompt lengths (no eos), so
# it was sized on the CPU with the reduced model: the main trace's four
# largest worst-case footprints need 100 blocks, and at 92 one decoding
# request (13 tokens generated) is preempted and recomputes 16 tokens.
OVERSUB_POOL_BLOCKS = 92
# The chaos path's plan on the main trace, against its schedule (which
# depends on the prompt lengths alone, so it was read on the CPU with the
# reduced model): ticks 1-5 only prefill; the first decode claim past a
# reservation comes at tick 36; ticks 59-88 only decode.  So the first
# crash lands mid-prefill and restores the initial snapshot, the pool-dry
# fires at tick 36, the write of the tick-24 snapshot dies, and the kernel
# fault at tick 62 degrades the engine, whose tick-64 snapshot (taken
# degraded) the crash after tick 65 restores.
CHAOS_SNAPSHOT_EVERY = 8
# The memory path: a swap budget that never refuses, and the prefix-store
# trace of (b), a system prompt of whole 64-token prefill chunks.
SWAP_HOST_BYTES = 1 << 30
STORE_PREFIX, STORE_NEW, STORE_POOL_BLOCKS = 256, 8, 1 + 4 * 32
CHAOS_PLAN = (("crash", 3), ("checkpoint_interrupt", 24), ("pool_dry", 30),
              ("kernel_fail", 62), ("crash", 65))


def phase(name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            print(f"[chip_smoke] phase {name}: "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            return res
        return run
    return deco


def cuda_ms(torch, fn, iters, warmup):
    """Mean ms of one call, each started with a cold L2: a decode tick
    reads 24 layers' pools, so the serving path never finds one cached."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


@phase("device")
def device_phase(torch):
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: the smoke run needs the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[chip_smoke] device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return name, smi.splitlines()[0]


@phase("build")
def build_phase():
    from repro_torch.kernels import runtime
    runtime.build_libraries(KERNELS)
    print(f"[chip_smoke] built {', '.join(KERNELS)} with "
          f"{' '.join(runtime.NVCC_FLAGS)}")


def decode_case(torch, seed, B, Hq, Hkv, D, bs, MB, P, Sq=1, bits=12,
                dev="cuda"):
    """A pool and block tables with mixed fill levels (one ending mid-page),
    a prefix page shared by two slots, an inactive slot and recycled pages
    holding stale data.  ``Sq`` > 1 gives verify operands: a draft block of
    Sq queries per slot, padding queries included."""
    import numpy as np
    from repro_torch.core import quantization as qlib
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    # a few hot directions so that LATS has something to prune
    hot = rng.normal(size=(8, Hkv, D)).astype(np.float32) * 4.0
    idx = rng.integers(0, P * bs, size=P * bs // 6)
    k.reshape(P * bs, Hkv, D)[idx] += hot[rng.integers(0, 8, size=idx.size)]
    v = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    lengths = np.array([MB * bs - 11 - Sq, 7 * bs + 3, 0, 77][:B], np.int32)
    table = np.zeros((B, MB), np.int32)
    used = 0
    for b in range(B):
        n = -(-(int(lengths[b]) + Sq - 1) // bs)
        table[b, :n] = perm[used:used + n]
        used += n
    table[1, :3] = table[0, :3]                    # shared prefix pages
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    q += hot[0].repeat(Hq // Hkv, axis=0)[None, None] * 0.5
    k_amax = np.abs(k).max(axis=(0, 1, 3)) * 1.25
    v_amax = np.abs(v).max(axis=(0, 1, 3)) * 1.25
    t = lambda a: torch.as_tensor(a, device=dev)
    kt = t(k)
    kq = qlib.pack_pool_planes(kt, t(k_amax), bits)
    if Sq == 1:
        q_pos = np.maximum(lengths - 1, 0).astype(np.int32)
        return (t(q[:, 0]), kq, t(v), t(table), t(lengths), t(q_pos),
                t(k_amax), t(v_amax))
    # Draft block: query s at fill level + s; slot 1 drafted 2 tokens only
    # (the rest are padding queries), slot 2 is idle (all padding).
    q_pos = lengths[:, None] + np.arange(Sq, dtype=np.int32)[None]
    real = np.ones((B, Sq), bool)
    real[1, 3:] = False
    real[2] = False
    q_pos = np.where(real, q_pos, 0).astype(np.int32)
    q_len = np.where(real, q_pos + 1, 0).astype(np.int32)
    return (t(q), kq, t(v), t(table), t(q_len), t(q_pos), t(k_amax),
            t(v_amax))


def decode_bytes_ops(args, rounds_h, surv, stats):
    """Bytes and integer ops one call needs on this data: the planes LATS
    kept alive per (slot, KV head, page), the V pages with a survivor, the
    small operands once, the outputs once."""
    q, kq, v, table, lengths, q_pos = args[:6]
    B, Hq, D = q.shape
    P, bits, bs8, Hkv, _ = kq.shape
    bs, MB, Dv = bs8 * 8, table.shape[1], v.shape[-1]
    G = Hq // Hkv
    planes = int(rounds_h.sum())
    live_v = int(surv.reshape(B, Hkv, G, MB, bs).any(4).any(2).sum())
    small = (B * Hq * D * 4 + 2 * bits * B * Hq * 4 + 2 * B * Hq * 4
             + Hkv * 4 + B * MB * 4 + 2 * B * 4)
    outs = B * Hq * Dv * 4 + B * MB * 4 + (B * Hq * MB * bs if stats else 0)
    nbytes = planes * bs8 * D + live_v * bs * Dv * 4 + small + outs
    ops = planes * G * bs * D * 2 + live_v * G * bs * Dv * 2
    return nbytes, ops


def decode_plane_bytes(args, rounds_h, window):
    """Logical plane bytes of one decode call, the planes LATS kept alive
    (per KV head and page, from ``rounds_h``), and the plane bytes the
    design copies: every plane of every reachable page, ahead of LATS."""
    q, kq, v, table, lengths, q_pos = args[:6]
    P, bits, bs8, Hkv, D = kq.shape
    bs, MB = bs8 * 8, table.shape[1]
    pages = 0
    for length, qp in zip(lengths.tolist(), q_pos.tolist()):
        lo = max(0, qp - window + 1) if window is not None else 0
        hi = min(qp, length - 1)
        if hi >= lo:
            pages += min(hi // bs, MB - 1) - lo // bs + 1
    return (int(rounds_h.sum()) * bs8 * D,
            pages * Hkv * bits * bs8 * D)


@phase("kernels")
def kernel_phase(torch):
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    shapes = dict(B=4, Hq=32, D=64, bs=16, MB=32, P=129)
    cases = [("mha a=0.6", 0.6, 32, None), ("mha a=0.8", 0.8, 32, None),
             ("gqa Hkv=8", 0.6, 8, None), ("window 100", 0.8, 32, 100)]
    worst = 0.0
    for i, (label, alpha, hkv, window) in enumerate(cases):
        cfg = BitStopperConfig(alpha=alpha)
        args = decode_case(torch, 100 + i, Hkv=hkv, **shapes)
        ker = pd.paged_bitstopper_decode(*args, cfg=cfg, window=window)
        ref = pd.paged_bitstopper_decode_plain(*args, cfg=cfg, window=window)
        torch.cuda.synchronize()
        for field in ("rounds", "survivors", "v_fetched"):
            a, b = getattr(ker, field), getattr(ref, field)
            if not torch.equal(a, b):
                n = int((a != b).sum())
                raise SystemExit(f"[chip_smoke] paged_decode {label}: "
                                 f"{field} differs in {n} entries")
        err = float((ker.out - ref.out).abs().max())
        worst = max(worst, err)
        live = int((args[4] > 0).sum())
        print(f"[chip_smoke] paged_decode {label}: rounds/survivors/"
              f"v_fetched equal; max|out diff| {err:.3e}; planes "
              f"{int(ker.rounds.sum())}/{live * shapes['MB'] * 12} "
              f"slot-page rounds; survivors {int(ker.survivors.sum())}")
        if not err <= OUT_TOL:
            raise SystemExit(f"[chip_smoke] paged_decode {label}: out "
                             f"differs by {err} > {OUT_TOL}")

    # Time the serving shape (stats=False) on the first case.  One launch
    # with stats counts the bytes the kernel requested: the planes of every
    # reachable page and V only of pages with a survivor.
    cfg = BitStopperConfig(alpha=0.6)
    args = decode_case(torch, 100, Hkv=32, **shapes)
    pd.copied_bytes()
    _, rounds_h, surv = pd.launch_kernel(*args, cfg=cfg, stats=True)
    physical, v_copied = pd.copied_bytes()
    nbytes, ops = decode_bytes_ops(args, rounds_h, surv, stats=False)
    logical, design = decode_plane_bytes(args, rounds_h, None)
    B, Hq, D = args[0].shape
    bs, Hkv, Dv = shapes["bs"], args[1].shape[3], args[2].shape[-1]
    live_v = int(surv.reshape(B, Hkv, Hq // Hkv, -1, bs).any(4).any(2).sum())
    if physical != design or v_copied != live_v * bs * Dv * 4:
        raise SystemExit(f"[chip_smoke] paged_decode copied {physical} plane "
                         f"bytes and {v_copied} V bytes; the design copies "
                         f"{design} and {live_v * bs * Dv * 4}")
    ms = cuda_ms(torch, lambda: pd.paged_bitstopper_decode(
        *args, cfg=cfg, stats=False), iters=50, warmup=5)
    kargs, *held = pd.kernel_args(*args, cfg=cfg, stats=False)
    kernel_ms = cuda_ms(torch, lambda: pd.launch_c(*kargs), iters=50,
                        warmup=5)
    plain_ms = cuda_ms(torch, lambda: pd.paged_bitstopper_decode_plain(
        *args, cfg=cfg, stats=False), iters=3, warmup=1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / INT8_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    print(f"[chip_smoke] paged_decode timing (B=4, H=32, D=64, bs=16, "
          f"MB=32): wrapper {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({nbytes} "
          f"bytes, {ops} ops); plane bytes logical {logical}, physical "
          f"{physical} (measured); V bytes physical {v_copied} (measured)")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:314",
            "max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "physical_bytes": physical}


def verify_bytes_ops(args, rounds_h, surv):
    """Bytes and integer ops one verify call needs on this data: per (slot,
    KV head, page) the planes of the query that kept the page alive longest
    (one load serves the whole draft block) and the V page when any query
    has a survivor, the small operands once, the outputs once; the ops are
    the dots of every live query.  Also returns the plane loads the block
    shares and the sum of the per-query counts (Sq separate decodes)."""
    q, kq, v, table = args[:4]
    B, Sq, Hq, D = q.shape
    P, bits, bs8, Hkv, _ = kq.shape
    bs, MB, Dv = bs8 * 8, table.shape[1], v.shape[-1]
    G = Hq // Hkv
    union = int(rounds_h.amax(2).sum())          # rounds_h [B, Hkv, Sq, MB]
    per_query = int(rounds_h.sum())
    sv = surv.reshape(B, Sq, Hkv, G, MB, bs).any(5).any(3)   # [B,Sq,Hkv,MB]
    v_union, v_per_query = int(sv.any(1).sum()), int(sv.sum())
    small = (B * Sq * Hq * D * 4 + 2 * bits * B * Sq * Hq * 4
             + 2 * B * Sq * Hq * 4 + Hkv * 4 + B * MB * 4 + 2 * B * Sq * 4)
    outs = B * Sq * Hq * Dv * 4 + B * Sq * MB * 4
    nbytes = union * bs8 * D + v_union * bs * Dv * 4 + small + outs
    ops = per_query * G * bs * D * 2 + v_per_query * G * bs * Dv * 2
    return nbytes, ops, union, per_query


def verify_copy_bytes(args, surv, window):
    """The plane and V bytes the verify kernel's design copies: per (slot,
    KV head, group of max(1, 4 // G) queries) block, every plane of every
    page some query of the group reaches, and V of each (block, page) where
    some row of the block has a survivor."""
    q, kq, v, table, lengths, q_pos = args[:6]
    B, Sq, Hq, D = q.shape
    P, bits, bs8, Hkv, _ = kq.shape
    bs, MB, Dv = bs8 * 8, table.shape[1], v.shape[-1]
    G = Hq // Hkv
    QG = max(1, 4 // G)
    sv = surv.reshape(B, Sq, Hkv, G, MB, bs).any(5).any(3).cpu()
    fill, pos = lengths.tolist(), q_pos.tolist()
    pages = live = 0
    for b in range(B):
        for s0 in range(0, Sq, QG):
            reach = set()
            for s in range(s0, min(s0 + QG, Sq)):
                lo = max(0, pos[b][s] - window + 1) if window else 0
                hi = min(pos[b][s], fill[b][s] - 1)
                if hi >= lo:
                    reach.update(range(lo // bs, min(hi // bs, MB - 1) + 1))
            pages += len(reach)
            if reach:
                live += int(sv[b, s0:s0 + QG][:, :, sorted(reach)]
                            .any(0).sum())
    return pages * Hkv * bits * bs8 * D, live * bs * Dv * 4


@phase("verify kernel")
def verify_kernel_phase(torch):
    """paged_verify against its plain version on draft blocks (padding
    queries, a row ending mid-page, an idle slot) at G = 1, 3, 4, 5 and 8,
    query by query against the paged_decode kernel at the query's position,
    and its own count of the bytes it copied against the design's."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    shapes = dict(B=4, Sq=SPEC_K + 1, D=64, bs=16, MB=32, P=129)
    cases = [("mha a=0.6", 0.6, 32, 32, None), ("gqa Hkv=8", 0.6, 32, 8, None),
             ("window 100", 0.8, 32, 32, 100), ("G=3", 0.6, 24, 8, None),
             ("G=5", 0.6, 40, 8, None), ("G=8", 0.6, 32, 4, None)]
    worst, physical = 0.0, None
    for i, (label, alpha, hq, hkv, window) in enumerate(cases):
        cfg = BitStopperConfig(alpha=alpha)
        args = decode_case(torch, 200 + i, Hq=hq, Hkv=hkv, **shapes)
        ker = pv.paged_bitstopper_verify(*args, cfg=cfg, window=window)
        ref = pv.paged_bitstopper_verify_plain(*args, cfg=cfg, window=window)
        torch.cuda.synchronize()
        for field in ("rounds", "survivors", "v_fetched"):
            a, b = getattr(ker, field), getattr(ref, field)
            if not torch.equal(a, b):
                n = int((a != b).sum())
                raise SystemExit(f"[chip_smoke] paged_verify {label}: "
                                 f"{field} differs in {n} entries")
        err = float((ker.out - ref.out).abs().max())
        worst = max(worst, err)
        if not err <= OUT_TOL:
            raise SystemExit(f"[chip_smoke] paged_verify {label}: out "
                             f"differs by {err} > {OUT_TOL}")
        q, kq, v, table, lengths, q_pos, k_amax, v_amax = args
        for s in range(shapes["Sq"]):
            dec = pd.paged_bitstopper_decode(
                q[:, s], kq, v, table, lengths[:, s].contiguous(),
                q_pos[:, s].contiguous(), k_amax, v_amax, cfg=cfg,
                window=window)
            real = lengths[:, s] > 0
            for field in ("out", "rounds", "survivors", "v_fetched"):
                a = getattr(dec, field)[real]
                b = getattr(ker, field)[:, s][real]
                if not torch.equal(a, b):
                    raise SystemExit(
                        f"[chip_smoke] paged_verify {label}: query {s} "
                        f"{field} differs from paged_decode at its position")
        # One launch with stats counts the bytes the kernel requested.
        pv.copied_bytes()
        _, rounds_h, surv = pv.launch_kernel(*args, cfg=cfg, window=window)
        planes, v_copied = pv.copied_bytes()
        design = verify_copy_bytes(args, surv, window)
        if (planes, v_copied) != design:
            raise SystemExit(f"[chip_smoke] paged_verify {label} copied "
                             f"{planes} plane bytes and {v_copied} V bytes; "
                             f"the design copies {design[0]} and {design[1]}")
        physical = planes if physical is None else physical
        _, _, union, per_query = verify_bytes_ops(args, rounds_h, surv)
        print(f"[chip_smoke] paged_verify {label} (Hq={hq}, Hkv={hkv}): "
              f"rounds/survivors/v_fetched equal to plain; max|out diff| "
              f"{err:.3e}; every real query equal to paged_decode at its "
              f"position; plane loads {union} for the block vs {per_query} "
              f"for {int((lengths > 0).sum())} separate decodes; copied "
              f"{planes} plane and {v_copied} V bytes (measured, as "
              f"designed); survivors {int(ker.survivors.sum())}")

    cfg = BitStopperConfig(alpha=0.6)
    args = decode_case(torch, 200, Hq=32, Hkv=32, **shapes)
    _, rounds_h, surv = pv.launch_kernel(*args, cfg=cfg)
    nbytes, ops, _, _ = verify_bytes_ops(args, rounds_h, surv)
    ms = cuda_ms(torch, lambda: pv.paged_bitstopper_verify(
        *args, cfg=cfg, stats=False), iters=50, warmup=5)
    kargs, *held = pv.kernel_args(*args, cfg=cfg, stats=False)
    kernel_ms = cuda_ms(torch, lambda: pv.launch_c(*kargs), iters=50,
                        warmup=5)
    plain_ms = cuda_ms(torch, lambda: pv.paged_bitstopper_verify_plain(
        *args, cfg=cfg, stats=False), iters=3, warmup=1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / INT8_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    print(f"[chip_smoke] paged_verify timing (B=4, Sq={shapes['Sq']}, H=32, "
          f"D=64, bs=16, MB=32): wrapper {ms:.4f} ms, kernel alone "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({nbytes} bytes, {ops} ops); plane bytes "
          f"physical {physical} (measured)")
    return {"name": "paged_verify", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_verify.cu",
            "replaces": "src/repro/kernels/paged_verify.py:335",
            "max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "physical_bytes": physical}


def uncached_case(torch, seed, N=FWD_B * 32, S=FWD_S, d=64, blk=128,
                  hot=True, dv=None):
    """q, k, v [N, S, d] on the card.  Hot (the default): every query of a
    slice leans on the slice's hot direction, and so do the keys of every
    other kv block (blocks 0, 2, ...): a hot pair scores about 8 logits
    above a cold one, so LATS ends the cold blocks early, as in the
    reference's ``test_bitstopper_kernel_skips_planes``.  Not hot: q and k
    are small and random, their logits within about one of each other, so
    LATS prunes as little as it does on random weights.  V is [N, S, dv]
    (dv defaults to d)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dv = d if dv is None else dv
    if not hot:
        q, k = (rng.normal(size=(N, S, d)).astype(np.float32)
                for _ in range(2))
        v = rng.normal(size=(N, S, dv)).astype(np.float32)
        return tuple(torch.as_tensor(x, device="cuda")
                     for x in (0.5 * q, 0.5 * k, v))
    hot = rng.normal(size=(N, 1, d)).astype(np.float32)
    hot *= 8.0 / np.linalg.norm(hot, axis=-1, keepdims=True)
    q = hot + 0.5 * rng.normal(size=(N, S, d)).astype(np.float32)
    k = 0.5 * rng.normal(size=(N, S, d)).astype(np.float32)
    k += hot * ((np.arange(S) // blk) % 2 == 0)[None, :, None]
    v = rng.normal(size=(N, S, dv)).astype(np.float32)
    return tuple(torch.as_tensor(x, device="cuda") for x in (q, k, v))


def qk_bytes_ops(ops, res, bq, bk):
    """Bytes and operations one ``bitstopper_qk`` launch needs on this
    data: q_int, margins and scalars once, the planes of every live round,
    V of every block with a survivor, the outputs once; the plane dots of
    every live round (fp16 tensor-core rate) and P x V of every surviving
    block (f32)."""
    N, S, d = ops.q_int.shape
    bits = ops.k_packed.shape[1]
    dv = ops.v_eff.shape[-1]
    n_qt, n_kb = res.rounds.shape[1:]
    planes = int(res.rounds.sum())
    live_v = int(res.survivors.reshape(N, n_qt, bq, n_kb, bk)
                 .any(4).any(2).sum())
    nbytes = (N * S * d * 4 + 2 * N * bits * S * 4 + N * 8
              + planes * (bk // 8) * d + live_v * bk * dv * 4
              + N * S * dv * 4 + res.rounds.numel() * 4
              + res.survivors.numel())
    plane_ops = planes * 2 * bq * bk * d
    pv_ops = live_v * 2 * bq * bk * dv
    return nbytes, plane_ops, pv_ops, planes


@phase("qk kernel")
def qk_kernel_phase(torch):
    """bitstopper_qk against its plain version at one layer's shapes of the
    forward path, on hot inputs (LATS prunes) and unpruned ones, causal and
    not: rounds and survivors exactly equal, out within UNCACHED_TOL; the
    plane and V bytes the kernel counted as requested equal its design's
    figure; the kernel timed alone on both inputs."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import bitstopper_qk as bq
    cfg = BitStopperConfig(alpha=0.6)
    worst, timed, copied = 0.0, {}, {}
    for label, seed, hot in (("hot", 300, True), ("unpruned", 302, False)):
        q, k, v = uncached_case(torch, seed, hot=hot)
        N, S, d = q.shape
        dv = v.shape[-1]
        blk = min(128, S)
        ops = bq.prep(q, k, v, cfg)
        for causal in (False, True):
            bq.count_copies(True)
            try:
                bq.copied_bytes()
                ker = bq.launch_kernel(ops, cfg, blk, blk, causal)
                planes, v_bytes = bq.copied_bytes()
            finally:
                bq.count_copies(False)
            ref = bq.bitstopper_qk_plain(ops, cfg, blk, blk, causal)
            torch.cuda.synchronize()
            for field in ("rounds", "survivors"):
                a, b = getattr(ker, field), getattr(ref, field)
                if not torch.equal(a, b):
                    raise SystemExit(f"[chip_smoke] bitstopper_qk {label} "
                                     f"causal={causal}: {field} differs in "
                                     f"{int((a != b).sum())} entries")
            err = float((ker.out - ref.out).abs().max())
            worst = max(worst, err)
            if not err <= UNCACHED_TOL:
                raise SystemExit(f"[chip_smoke] bitstopper_qk {label} "
                                 f"causal={causal}: out differs by {err} > "
                                 f"{UNCACHED_TOL}")
            n_qt, n_kb = ker.rounds.shape[1:]
            live_v = int(ker.survivors.reshape(N, n_qt, blk, n_kb, blk)
                         .any(4).any(2).sum())
            design = bq.design_plane_bytes(ker.rounds, cfg.bits, blk, d)
            if planes != design or v_bytes != live_v * blk * dv * 4:
                raise SystemExit(f"[chip_smoke] bitstopper_qk {label} "
                                 f"causal={causal} copied {planes} plane "
                                 f"bytes and {v_bytes} V bytes; the design "
                                 f"copies {design} and "
                                 f"{live_v * blk * dv * 4}")
            reach = n_kb * (n_kb + 1) // 2 if causal else n_kb * n_kb
            print(f"[chip_smoke] bitstopper_qk {label} causal={causal} "
                  f"(N={N}, S={S}, d={d}, blocks {blk}, alpha 0.6): "
                  f"rounds/survivors equal; max|out diff| {err:.3e}; rounds "
                  f"{int(ker.rounds.sum())} vs dense {N * reach * cfg.bits} "
                  f"(12 per reachable block); survivors "
                  f"{int(ker.survivors.sum())}; copied {planes} plane bytes "
                  f"and {v_bytes} V bytes (measured, as designed)")
        # The forward path runs causal: time and bound that launch.
        kargs, held = bq.kernel_args(ops, cfg, blk, blk, True)
        kernel_ms = cuda_ms(torch, lambda: bq.launch_c(*kargs), iters=10,
                            warmup=2)
        timed[label] = (q, k, v, ops, ker, kernel_ms)
        copied[label] = planes
    q, k, v, ops, ker, kernel_ms = timed["hot"]
    N, S, d = q.shape
    blk = min(128, S)
    nbytes, plane_ops, pv_ops, planes = qk_bytes_ops(ops, ker, blk, blk)
    ms = cuda_ms(torch, lambda: bq.bitstopper_attention_kernel(
        q, k, v, cfg, causal=True), iters=10, warmup=2)
    prep_ms = cuda_ms(torch, lambda: bq.prep(q, k, v, cfg), iters=10,
                      warmup=2)
    plain_ms = cuda_ms(torch, lambda: bq.bitstopper_qk_plain(
        ops, cfg, blk, blk, True), iters=2, warmup=1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = (plane_ops / FP16_OPS_PER_S + pv_ops / F32_OPS_PER_S) * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    un_ms = timed["unpruned"][5]
    un_bytes, un_plane_ops, un_pv_ops, un_planes = qk_bytes_ops(
        timed["unpruned"][3], timed["unpruned"][4], blk, blk)
    un_bound = max(un_bytes / HBM_BYTES_PER_S,
                   un_plane_ops / FP16_OPS_PER_S + un_pv_ops / F32_OPS_PER_S
                   ) * 1e3
    print(f"[chip_smoke] bitstopper_qk timing (causal, N={N}, S={S}, d={d}):"
          f" hot: wrapper {ms:.4f} ms (prep {prep_ms:.4f} ms), kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f}"
          f" ms ({nbytes} bytes, {plane_ops} plane-dot ops over {planes} "
          f"live rounds, {pv_ops} P x V ops); unpruned: kernel {un_ms:.4f} "
          f"ms, bound {un_bound:.5f} ms ({un_planes} live rounds, "
          f"{un_pv_ops} P x V ops)")
    return {"name": "bitstopper_qk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitstopper_qk.cu",
            "replaces": "src/repro/kernels/bitstopper_qk.py:257",
            "max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
            "kernel_ms_unpruned": un_ms, "prep_ms": prep_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "physical_bytes": copied["hot"]}


@phase("flash kernel")
def flash_kernel_phase(torch):
    """flash_attention against its plain version (dense softmax) at the
    same shapes, causal, within UNCACHED_TOL; timed beside one call of
    scaled_dot_product_attention on the same f32 inputs, the library
    yardstick the port never calls."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = uncached_case(torch, 301)
    N, S, d = q.shape
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= UNCACHED_TOL:
        raise SystemExit(f"[chip_smoke] flash_attention: out differs by "
                         f"{err} > {UNCACHED_TOL}")
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=True), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True),
                         iters=10, warmup=2)
    lib_err = float((sdpa(q, k, v, is_causal=True) - want).abs().max())
    nbytes = 4 * N * S * d * 4                 # q, k, v read, out written
    ops = N * S * (S + 1) // 2 * 2 * (d + d)   # QK^T and P V, visible pairs
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # The kernel's f32 products run as split TF32 (three tensor-core
    # products each); the f32 CUDA-core bound is printed beside it.
    bound_ops = ops / SPLIT_TF32_OPS_PER_S * 1e3
    bound_f32 = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    print(f"[chip_smoke] flash_attention causal (N={N}, S={S}, d={d}, "
          f"blocks 128): max|out diff| {err:.3e} vs plain; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms (max|diff| {lib_err:.3e}); bounds "
          f"{bound_ops:.5f} ms at the split-TF32 rate, {bound_f32:.5f} ms at "
          f"the f32 CUDA-core rate, {bound_bytes:.5f} ms for the bytes "
          f"({nbytes} bytes, {ops} f32 ops)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:114",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bound_rate": "split TF32: 3 TF32 tensor-core products an f32 "
                          "product",
            "library_ms": library_ms}


# C1 and C3: the widths and pages the kernels took on beside their main
# shapes.  Wide heads: recurrentgemma-2b's 256 and deepseek-v3's MLA
# 192 / 128 (configs/registry.py); 8 slices of S=1024.  Large pages: 512
# and 1024 tokens at the serving widths (B=4, H=32, D=64).
WIDE_WIDTHS = ((256, 256), (192, 128))
WIDE_N = 8
LARGE_PAGES = ((512, 8, 24), (1024, 8, 20))      # (bs, MB, P)


@phase("wide kernels")
def wide_kernel_phase(torch):
    """flash_attention and bitstopper_qk at the wide head widths against
    their plain versions: bitstopper_qk's rounds, survivors and out equal
    bit for bit on hot inputs, causal and not (its byte counts held to the
    design), flash within UNCACHED_TOL; each timed alone, causal, beside its
    bound (and flash beside scaled_dot_product_attention)."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import bitstopper_qk as bq
    from repro_torch.kernels import flash_attention as fa
    cfg = BitStopperConfig(alpha=0.6)
    rows = []
    for i, (d, dv) in enumerate(WIDE_WIDTHS):
        q, k, v = uncached_case(torch, 320 + i, N=WIDE_N, d=d, dv=dv)
        N, S, _ = q.shape
        blk = min(128, S)
        ops = bq.prep(q, k, v, cfg)
        for causal in (False, True):
            bq.count_copies(True)
            try:
                bq.copied_bytes()
                ker = bq.launch_kernel(ops, cfg, blk, blk, causal)
                planes, v_bytes = bq.copied_bytes()
            finally:
                bq.count_copies(False)
            ref = bq.bitstopper_qk_plain(ops, cfg, blk, blk, causal)
            torch.cuda.synchronize()
            for field in ("rounds", "survivors", "out"):
                a, b = getattr(ker, field), getattr(ref, field)
                if not torch.equal(a, b):
                    raise SystemExit(
                        f"[chip_smoke] bitstopper_qk d={d} dv={dv} causal="
                        f"{causal}: {field} differs in "
                        f"{int((a != b).sum())} entries")
            n_qt, n_kb = ker.rounds.shape[1:]
            live_v = int(ker.survivors.reshape(N, n_qt, blk, n_kb, blk)
                         .any(4).any(2).sum())
            design = bq.design_plane_bytes(ker.rounds, cfg.bits, blk, d)
            if planes != design or v_bytes != live_v * blk * dv * 4:
                raise SystemExit(f"[chip_smoke] bitstopper_qk d={d} dv={dv}"
                                 f" copied {planes} plane and {v_bytes} V "
                                 f"bytes; the design copies {design} and "
                                 f"{live_v * blk * dv * 4}")
        kargs, held = bq.kernel_args(ops, cfg, blk, blk, True)
        qk_ms = cuda_ms(torch, lambda: bq.launch_c(*kargs), iters=5,
                        warmup=1)
        qk_plain_ms = cuda_ms(torch, lambda: bq.bitstopper_qk_plain(
            ops, cfg, blk, blk, True), iters=1, warmup=1)
        nbytes, plane_ops, pv_ops, live = qk_bytes_ops(ops, ker, blk, blk)
        qk_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        qk_ops_ms = (plane_ops / FP16_OPS_PER_S + pv_ops / F32_OPS_PER_S) \
            * 1e3
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= UNCACHED_TOL:
            raise SystemExit(f"[chip_smoke] flash_attention d={d} dv={dv}: "
                             f"out differs by {err} > {UNCACHED_TOL}")
        fl_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                          causal=True),
                        iters=5, warmup=1)
        fl_plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True), iters=2, warmup=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True),
                         iters=5, warmup=1)
        fl_bytes = N * S * (2 * d + 2 * dv) * 4
        fl_ops = N * S * (S + 1) // 2 * 2 * (d + dv)
        # The bound of the function is the narrow row's: f32-accurate
        # products at the split-TF32 rate.  The wide form runs on the CUDA
        # cores, whose f32 bound is printed beside it.
        fl_bound = max(fl_bytes / HBM_BYTES_PER_S,
                       fl_ops / SPLIT_TF32_OPS_PER_S) * 1e3
        fl_bound_f32 = fl_ops / F32_OPS_PER_S * 1e3
        print(f"[chip_smoke] wide d={d} dv={dv} (N={N}, S={S}, causal): "
              f"bitstopper_qk rounds/survivors/out equal to plain, copies "
              f"as designed ({planes} plane, {v_bytes} V bytes), kernel "
              f"{qk_ms:.4f} ms, plain {qk_plain_ms:.3f} ms, bound "
              f"{max(qk_bytes_ms, qk_ops_ms):.5f} ms ({live} live rounds); "
              f"flash max|out diff| {err:.3e}, kernel {fl_ms:.4f} ms, plain "
              f"{fl_plain_ms:.3f} ms, scaled_dot_product_attention "
              f"{lib_ms:.4f} ms, bound {fl_bound:.5f} ms at the split-TF32 "
              f"rate ({fl_bound_f32:.5f} ms at the f32 CUDA-core rate)")
        rows.append({"d": d, "dv": dv, "qk_ms": qk_ms,
                     "qk_plain_ms": qk_plain_ms,
                     "qk_bound_ms": max(qk_bytes_ms, qk_ops_ms),
                     "flash_ms": fl_ms, "flash_plain_ms": fl_plain_ms,
                     "flash_bound_ms": fl_bound,
                     "flash_bound_f32_ms": fl_bound_f32,
                     "flash_library_ms": lib_ms,
                     "flash_max_abs_err": err})
    return rows


@phase("large pages")
def large_page_phase(torch):
    """paged_decode and paged_verify at pages of 512 and 1024 tokens (the
    striped walk) against their plain versions: rounds, survivors and
    v_fetched equal, out within OUT_TOL, every real verify query equal to
    the decode at its position, the bytes each counted as requested equal
    to its design's; each kernel timed alone beside its bound."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    cfg = BitStopperConfig(alpha=0.6)
    rows = []
    for i, (bs, MB, P) in enumerate(LARGE_PAGES):
        shapes = dict(B=4, Hq=32, Hkv=32, D=64, bs=bs, MB=MB, P=P)
        row = {"bs": bs}
        for name, mod, Sq in (("paged_decode", pd, 1),
                              ("paged_verify", pv, SPEC_K + 1)):
            args = decode_case(torch, 400 + i, Sq=Sq, **shapes)
            plain_fn = (pd.paged_bitstopper_decode_plain if Sq == 1
                        else pv.paged_bitstopper_verify_plain)
            kern_fn = (pd.paged_bitstopper_decode if Sq == 1
                       else pv.paged_bitstopper_verify)
            mod.copied_bytes()
            _, rounds_h, surv = mod.launch_kernel(*args, cfg=cfg)
            physical, v_copied = mod.copied_bytes()
            ker = kern_fn(*args, cfg=cfg)
            ref = plain_fn(*args, cfg=cfg)
            torch.cuda.synchronize()
            for field in ("rounds", "survivors", "v_fetched"):
                a, b = getattr(ker, field), getattr(ref, field)
                if not torch.equal(a, b):
                    raise SystemExit(f"[chip_smoke] {name} bs={bs}: {field} "
                                     f"differs in {int((a != b).sum())} "
                                     f"entries")
            err = float((ker.out - ref.out).abs().max())
            if not err <= OUT_TOL:
                raise SystemExit(f"[chip_smoke] {name} bs={bs}: out differs "
                                 f"by {err} > {OUT_TOL}")
            if Sq == 1:
                B, Hq = args[0].shape[:2]
                live_v = int(surv.reshape(B, 32, Hq // 32, MB, bs)
                             .any(4).any(2).sum())
                design = (decode_plane_bytes(args, rounds_h, None)[1],
                          live_v * bs * args[2].shape[-1] * 4)
                nbytes, ops = decode_bytes_ops(args, rounds_h, surv, False)
            else:
                design = verify_copy_bytes(args, surv, None)
                nbytes, ops, _, _ = verify_bytes_ops(args, rounds_h, surv)
                q, kq, v, table, lengths, q_pos, k_amax, v_amax = args
                for s in range(Sq):
                    dec = pd.paged_bitstopper_decode(
                        q[:, s], kq, v, table, lengths[:, s].contiguous(),
                        q_pos[:, s].contiguous(), k_amax, v_amax, cfg=cfg)
                    real = lengths[:, s] > 0
                    for field in ("out", "rounds", "survivors", "v_fetched"):
                        if not torch.equal(getattr(dec, field)[real],
                                           getattr(ker, field)[:, s][real]):
                            raise SystemExit(
                                f"[chip_smoke] paged_verify bs={bs}: query "
                                f"{s} {field} differs from paged_decode at "
                                f"its position")
            if (physical, v_copied) != design:
                raise SystemExit(f"[chip_smoke] {name} bs={bs} copied "
                                 f"{physical} plane and {v_copied} V bytes; "
                                 f"the design copies {design}")
            kargs, *held = mod.kernel_args(*args, cfg=cfg, stats=False)
            kernel_ms = cuda_ms(torch, lambda: mod.launch_c(*kargs),
                                iters=20, warmup=3)
            plain_ms = cuda_ms(torch, lambda: plain_fn(*args, cfg=cfg,
                                                       stats=False),
                               iters=1, warmup=1)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / INT8_OPS_PER_S) * 1e3
            print(f"[chip_smoke] {name} bs={bs} (B=4, Sq={Sq}, H=32, D=64, "
                  f"MB={MB}): rounds/survivors/v_fetched equal to plain; "
                  f"max|out diff| {err:.3e}; copied {physical} plane and "
                  f"{v_copied} V bytes (measured, as designed); kernel "
                  f"alone {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.5f} ms ({nbytes} bytes, {ops} ops)"
                  + ("; every real query equal to paged_decode" if Sq > 1
                     else ""))
            row[name] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "max_abs_err": err}
        dead_page_repeats(torch, bs, cfg)
        rows.append(row)
    return rows


def dead_page_case(torch, bs, Hkv=8, G=4, D=64, P=9, dev="cuda"):
    """Decode operands where whole pages die: the query heads of every KV
    head point along its hot direction, which only physical pages 1 and 5
    hold, so a cold page after a hot one stops with no survivor in any
    row.  Slot 3 walks hot, cold, hot, cold pages."""
    import numpy as np
    from repro_torch.core import quantization as qlib
    rng = np.random.default_rng(500 + bs)
    u = rng.normal(size=(Hkv, D))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    k = rng.normal(size=(P, bs, Hkv, D)) * 0.04
    k[[1, 5]] += 8.0 * u
    v = rng.normal(size=(P, bs, Hkv, D))
    table = np.array([[1, 2, 3, 4], [1, 5, 6, 0], [7, 3, 0, 0],
                      [1, 2, 5, 3]], np.int32)
    lengths = np.array([4 * bs, 5 * bs // 2, 19 * bs // 16, 4 * bs],
                       np.int32)
    q = 8.0 * np.repeat(u, G, axis=0)[None] + 0.1 * rng.normal(
        size=(4, Hkv * G, D))
    t = lambda a, dt=np.float32: torch.as_tensor(np.asarray(a, dt),
                                                 device=dev)
    k_amax = np.abs(k).max(axis=(0, 1, 3))
    kq = qlib.pack_pool_planes(t(k), t(k_amax), 12)
    return (t(q), kq, t(v), t(table, np.int32), t(lengths, np.int32),
            t(lengths - 1, np.int32), t(k_amax),
            t(np.abs(v).max(axis=(0, 1, 3))))


def dead_page_repeats(torch, bs, cfg, repeats=50):
    """The striped walk on pages where every row of a KV head dies, right
    after a hot page and between live ones (a block that leaves such a page
    early must not race the next page's reset): ``repeats`` launches each
    of the decode and the verify, every one equal to the plain version."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    args = dead_page_case(torch, bs)
    q, kq, v, table, lengths, q_pos, k_amax, v_amax = args
    ref = pd.paged_bitstopper_decode_plain(*args, cfg=cfg)
    B, Hq, _ = q.shape
    Hkv = v.shape[2]
    live = ref.survivors.reshape(B, Hkv, Hq // Hkv, -1, bs).any(4).any(2)
    reach = torch.arange(table.shape[1], device=q.device)[None] * bs \
        < lengths[:, None]
    dead = reach[:, None] & ~live
    # a dead page with a live one after it, in the same (slot, KV head)
    later = live[..., 1:].int().flip(-1).cummax(-1)[0].flip(-1).bool()
    between = dead[..., :-1] & later
    if not bool(between.any()):
        raise SystemExit(f"[chip_smoke] dead pages bs={bs}: no page dies "
                         f"between live ones ({int(dead.sum())} dead)")
    vargs = (q[:, None], kq, v, table, lengths[:, None].contiguous(),
             q_pos[:, None].contiguous(), k_amax, v_amax)
    for i in range(repeats):
        ker = pd.paged_bitstopper_decode(*args, cfg=cfg)
        ver = pv.paged_bitstopper_verify(*vargs, cfg=cfg)
        for field in ("rounds", "survivors", "v_fetched"):
            a = getattr(ker, field)
            if not (torch.equal(a, getattr(ref, field))
                    and torch.equal(getattr(ver, field)[:, 0], a)):
                raise SystemExit(f"[chip_smoke] dead pages bs={bs}, launch "
                                 f"{i}: {field} differs")
        err = float((ker.out - ref.out).abs().max())
        if not (err <= OUT_TOL and torch.equal(ver.out[:, 0], ker.out)):
            raise SystemExit(f"[chip_smoke] dead pages bs={bs}, launch {i}: "
                             f"out differs by {err}")
    print(f"[chip_smoke] dead pages bs={bs} (B=4, H=32/8, D=64): "
          f"{int(dead.sum())} of {int(reach.sum()) * Hkv} reached (slot, KV "
          f"head, page) triples die whole, {int(between.sum())} between live "
          f"ones; {repeats} launches each of decode and verify equal to "
          f"plain")


@phase("forward path")
def forward_path_phase(torch, cfg, params):
    """transformer.forward with no caches over FWD_B prompts of FWD_S
    tokens at full width and depth, for every attention impl.  Returns the
    launches of bitstopper_qk and flash_attention in their impls' runs."""
    import numpy as np
    from repro_torch.kernels import bitstopper_qk as bq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (FWD_B, FWD_S)),
                             device="cuda")
    logits, launches = {}, {}
    for impl in ("bitstopper", "bitstopper_xla", "flash", "xla"):
        c = cfg.replace(attn_impl=impl)
        torch.cuda.synchronize()
        bq.LAUNCHES = fa.LAUNCHES = 0
        t = time.perf_counter()
        out, caches, _ = T.forward(params, tokens, c)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[impl] = (bq.LAUNCHES, fa.LAUNCHES)
        if caches is not None or out.shape != (FWD_B, FWD_S, cfg.vocab) \
                or not bool(torch.isfinite(out).all()):
            raise SystemExit(f"[chip_smoke] forward {impl}: logits "
                             f"{tuple(out.shape)} not finite or caches")
        logits[impl] = out
        print(f"[chip_smoke] forward {impl}: {dt * 1e3:.1f} ms, "
              f"{FWD_B * FWD_S / dt:.1f} prompt tokens/s; launches "
              f"bitstopper_qk {launches[impl][0]}, flash_attention "
              f"{launches[impl][1]}")
    n = cfg.n_layers
    want = {"bitstopper": (n, 0), "bitstopper_xla": (0, 0), "flash": (0, n),
            "xla": (0, 0)}
    if launches != want:
        raise SystemExit(f"[chip_smoke] forward launches {launches}, "
                         f"expected {want} (one per layer)")
    # Each kernel impl against the plain impl it is held to.  Tolerances,
    # relative to the largest |logit|: bitstopper vs bitstopper_xla 1e-3,
    # the CPU forward test's: the kernel equals its plain version in every
    # integer per layer, but an ulp of an output can move an INT12 value of
    # the next layer by one step; flash vs xla 1e-4: f32 sums in another
    # order through 24 layers.
    for ker, plain, rel in (("bitstopper", "bitstopper_xla", 1e-3),
                            ("flash", "xla", 1e-4)):
        a, b = logits[ker], logits[plain]
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"[chip_smoke] forward {ker} vs {plain}: max|diff| "
              f"{diff:.3e} (max|logit| {scale:.3f}, limit {rel:g} of it); "
              f"argmax equal at {same * 100:.2f}% of positions")
        if not diff <= rel * scale or same != 1.0:
            raise SystemExit(f"[chip_smoke] forward {ker} disagrees with "
                             f"{plain}")
    gap = float((logits["bitstopper"] - logits["xla"]).abs().max())
    agree = float((logits["bitstopper"].argmax(-1)
                   == logits["xla"].argmax(-1)).float().mean())
    print(f"[chip_smoke] forward bitstopper vs dense xla (INT12 quantization"
          f" and pruning, reported only): max|diff| {gap:.3e}, argmax equal "
          f"at {agree * 100:.2f}% of positions")
    return launches["bitstopper"][0], launches["flash"][1]


def make_requests(np, Request, seed, n, new_tokens, vocab):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, int(rng.integers(64, 385)),
                                        dtype=np.int32),
                    max_new_tokens=new_tokens) for _ in range(n)]


def build_model(torch):
    """Full-width stablelm-1.6b (f32) with seeded random weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.models import transformer as T
    cfg = get_config("stablelm-1.6b", attn_impl="bitstopper_xla",
                     bitstopper=BitStopperConfig(alpha=0.6))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_model(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[chip_smoke] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
          f"{cfg.vocab}, {n_params} f32 parameters, seeded init "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


class LaunchTimer:
    """CUDA events around every launch of a kernel module's ``launch_c``
    while the context is open."""

    def __init__(self, torch, module):
        self.torch, self.module, self.events = torch, module, []
        self.real = module.launch_c

    def _timed(self, *a):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        self.real(*a)
        end.record()
        self.events.append((start, end))

    def __enter__(self):
        self.module.launch_c = self._timed
        return self

    def __exit__(self, *exc):
        self.module.launch_c = self.real

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


class ReplayDrafter:
    """Drafts the tokens a recorded plain run generated after the same
    context: a perfect draft model of the greedy target."""

    def __init__(self, np, reqs):
        self.np = np
        self.runs = [(np.asarray(r.prompt), list(r.generated)) for r in reqs]

    def propose(self, context, k):
        for prompt, gen in self.runs:
            n = len(context) - len(prompt)
            if (0 < n <= len(gen)
                    and self.np.array_equal(context[:len(prompt)], prompt)
                    and list(context[len(prompt):]) == gen[:n]):
                return gen[n:n + k]
        return []


@phase("main path")
def main_path_phase(torch, cfg, params):
    """Full-width stablelm-1.6b served greedily through the port's
    PagedEngine; returns the decode kernel's launch count of the main run
    and its requests (the recorded plain tokens)."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig

    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)

    # Warm-up (cuBLAS handles, allocator) on a throwaway engine.
    PagedEngine(cfg, params, scfg).generate(
        make_requests(np, Request, 99, 1, 2, cfg.vocab))
    torch.cuda.synchronize()

    eng = PagedEngine(cfg, params, scfg)
    if not eng.cfg.fused_decode:
        raise SystemExit("[chip_smoke] fused_decode did not resolve to the "
                         "kernel on the card")
    tick_ms = {"prefill": [], "decode": []}
    real_tick = eng.step

    def timed_step():
        chunks = eng.counters["prefill_chunks"]
        steps = eng.counters["decode_steps"]
        t = time.perf_counter()
        out = real_tick()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        kind = ("decode" if eng.counters["decode_steps"] > steps else
                "prefill" if eng.counters["prefill_chunks"] > chunks else None)
        if kind == "decode" and eng.counters["prefill_chunks"] > chunks:
            kind = "mixed"
        if kind in tick_ms:
            tick_ms[kind].append(dt)
        return out

    eng.step = timed_step
    from repro_torch.core import quantization as qlib
    real_pack = qlib.pack_pool_planes
    requants = []

    def counted_pack(*a, **kw):
        requants.append(1)
        return real_pack(*a, **kw)

    qlib.pack_pool_planes = counted_pack
    reqs = make_requests(np, Request, 0, 8, 32, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    with LaunchTimer(torch, pd) as timer:
        pd.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = pd.LAUNCHES
    qlib.pack_pool_planes = real_pack
    ticks = eng.counters["decode_steps"]
    n_tok = sum(len(r.generated) for r in reqs)
    kernel_ms = timer.ms()
    print(f"[chip_smoke] main path: {len(reqs)} requests, prompts "
          f"{[len(r.prompt) for r in reqs]}, {n_tok} new tokens in "
          f"{wall:.3f} s ({n_tok / wall:.2f} tok/s)")
    print(f"[chip_smoke] main path: {ticks} decode ticks, "
          f"{eng.counters['prefill_chunks']} prefill chunks; pure decode "
          f"ticks {len(tick_ms['decode'])} at mean "
          f"{np.mean(tick_ms['decode']):.2f} ms, pure prefill ticks "
          f"{len(tick_ms['prefill'])} at mean "
          f"{np.mean(tick_ms['prefill']):.2f} ms per chunk")
    print(f"[chip_smoke] main path: paged_decode launches {launches}, kernel "
          f"time {kernel_ms:.3f} ms in all ({kernel_ms / max(launches, 1):.4f}"
          f" ms per launch); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[chip_smoke] main path counters: {eng.counters}; plane-pool "
          f"requants on amax growth: {len(requants)} (layer writes: "
          f"{cfg.n_layers * (ticks + eng.counters['prefill_chunks'])})")
    if launches != cfg.n_layers * ticks or ticks == 0:
        raise SystemExit(f"[chip_smoke] {launches} kernel launches for "
                         f"{ticks} decode ticks x {cfg.n_layers} layers")
    for r in reqs:
        if len(r.generated) != 32 or not all(0 <= x < cfg.vocab
                                             for x in r.generated):
            raise SystemExit(f"[chip_smoke] request {r.rid} generated "
                             f"{r.generated}")

    # Fused kernel vs the plain oracle on a short trace: same tokens.
    streams = []
    for fused in (True, False):
        short = make_requests(np, Request, 1, 4, 8, cfg.vocab)
        t = time.perf_counter()
        PagedEngine(cfg, params, ServeConfig(
            max_slots=4, page_size=16, max_len=512,
            fused_decode=fused)).generate(short)
        torch.cuda.synchronize()
        print(f"[chip_smoke] short trace fused_decode={fused}: "
              f"{time.perf_counter() - t:.3f} s")
        streams.append([r.generated for r in short])
    if streams[0] != streams[1]:
        raise SystemExit(f"[chip_smoke] fused and plain decode disagree: "
                         f"{streams[0]} vs {streams[1]}")
    print(f"[chip_smoke] fused and plain decode give identical tokens on "
          f"{len(streams[0])} requests")
    return launches, reqs, float(np.mean(tick_ms["decode"]))


LARGE_PAGE_PROMPTS = (700, 300, 900, 520)       # two pages for three


@phase("large pages (engine)")
def large_page_engine_phase(torch, cfg, params):
    """The striped walk on a served path: PagedEngine at pages of 512
    tokens (full width, cut depth 4), greedy, with the decode kernel and
    with the plain oracle: the same tokens, and one kernel launch per layer
    per decode tick in the kernel's run and none in the oracle's.  Returns
    the kernel run's launches."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    depth = min(4, cfg.n_layers)
    cut = cfg.replace(segments=((cfg.segments[0][0], depth),))
    cut_params = dict(params, seg0=params["seg0"][:depth])
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in LARGE_PAGE_PROMPTS]
    streams, launches = [], []
    for fused in (True, False):
        eng = PagedEngine(cut, cut_params, ServeConfig(
            max_slots=4, page_size=512, max_len=1024, fused_decode=fused))
        reqs = [Request(prompt=p.copy(), max_new_tokens=8) for p in prompts]
        pd.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches.append(pd.LAUNCHES)
        ticks = eng.counters["decode_steps"]
        want = depth * ticks if fused else 0
        if pd.LAUNCHES != want or ticks == 0:
            raise SystemExit(f"[chip_smoke] large pages (engine) fused="
                             f"{fused}: {pd.LAUNCHES} decode launches for "
                             f"{ticks} ticks x {depth} layers")
        streams.append([r.generated for r in reqs])
        print(f"[chip_smoke] large pages (engine) fused_decode={fused}: "
              f"page_size 512, prompts {list(LARGE_PAGE_PROMPTS)}, depth "
              f"{depth}, {ticks} decode ticks, {pd.LAUNCHES} decode "
              f"launches, {wall:.3f} s")
    if streams[0] != streams[1]:
        raise SystemExit(f"[chip_smoke] large pages (engine): kernel and "
                         f"plain oracle disagree: {streams[0]} vs "
                         f"{streams[1]}")
    print(f"[chip_smoke] large pages (engine): kernel and plain oracle give "
          f"identical tokens on {len(prompts)} requests")
    return launches[0]


def serve_speculative(torch, np, cfg, params, prompts, new_tokens,
                      drafter=None, label="", seed=0, **kw):
    """Serve ``prompts`` speculatively (k = SPEC_K) and check the launch
    counts: with the kernels, one verify launch per layer per verify forward
    (bailouts included) and one decode launch per layer per plain decode
    forward; with the plain oracles, none.
    Returns the engine, the token streams, the verify launches and the
    ticks that ran a verify forward."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    eng = PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, draft_k=SPEC_K, **kw),
        drafter=drafter)
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    tick_ms = {"verify": [], "bailout": [], "decode": []}
    verify_ticks = []
    real_tick = eng.step

    def timed_step():
        before = dict(eng.counters)
        t = time.perf_counter()
        out = real_tick()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        d = {k: eng.counters[k] - before[k] for k in before}
        if d["spec_ticks"]:
            verify_ticks.append(eng.ticks)
        if not d["prefill_chunks"] and d["decode_steps"]:
            kind = ("bailout" if d["spec_bailouts"] else
                    "verify" if d["spec_ticks"] else "decode")
            tick_ms[kind].append(dt)
        return out

    eng.step = timed_step
    growth = []                # per bailout: layers whose K / V scale grew
    real_verify = eng._verify_forward

    def probed_verify(*a):
        from repro_torch.serving.engine import _layers
        old = _layers(eng.caches)
        out = real_verify(*a)
        if out[2]:
            grew = {"k_amax": 0, "v_amax": 0}
            ratio = 0.0
            for co, cn in zip(old, _layers(out[1])):
                for key in grew:
                    up = cn[key] > co[key]
                    if bool(up.any()):
                        grew[key] += 1
                        # new max |x| over the old scale (growth stores
                        # the new max times 1.25)
                        r = (cn[key][up] / 1.25 / co[key][up]).max()
                        ratio = max(ratio, float(r))
            growth.append((grew["k_amax"], grew["v_amax"], ratio))
        return out

    eng._verify_forward = probed_verify
    with LaunchTimer(torch, pv) as timer:
        pd.LAUNCHES = pv.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs, seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = (pd.LAUNCHES, pv.LAUNCHES)
    c = eng.counters
    n_tok = sum(len(r.generated) for r in reqs)
    verify_fw = c["spec_ticks"]
    decode_fw = c["decode_steps"] - (c["spec_ticks"] - c["spec_bailouts"])
    mean = lambda xs: f"{np.mean(xs):.2f} ms ({len(xs)})" if xs else "none"
    print(f"[chip_smoke] {label}: {len(reqs)} requests, {n_tok} new tokens "
          f"in {wall:.3f} s ({n_tok / wall:.2f} tok/s); speculative "
          f"counters: spec_ticks {c['spec_ticks']}, accepted "
          f"{c['spec_accepted']}/{c['spec_proposed']}, bailouts "
          f"{c['spec_bailouts']}, drafter_failures {c['drafter_failures']},"
          f" {c['decode_tokens']}/{c['decode_steps']} tokens per decode "
          f"forward")
    print(f"[chip_smoke] {label}: mean tick without prefill: verify "
          f"{mean(tick_ms['verify'])}, bailout {mean(tick_ms['bailout'])}, "
          f"plain decode {mean(tick_ms['decode'])}; paged_verify launches "
          f"{launches[1]} ({timer.ms() / max(launches[1], 1):.4f} ms per "
          f"launch, CUDA events), paged_decode launches {launches[0]}")
    if growth:
        g = np.array(growth)
        print(f"[chip_smoke] {label}: growth bailouts {len(growth)}: layers "
              f"whose K scale grew {g[:, 0].mean():.2f} and V scale "
              f"{g[:, 1].mean():.2f} per bailout (of {cfg.n_layers}); new "
              f"max over old scale: median {np.median(g[:, 2]):.4f}, max "
              f"{g[:, 2].max():.4f}")
    want = ((cfg.n_layers * decode_fw, cfg.n_layers * verify_fw)
            if eng.cfg.fused_decode else (0, 0))
    if launches != want:
        raise SystemExit(f"[chip_smoke] {label}: launches {launches} for "
                         f"{decode_fw} decode and {verify_fw} verify "
                         f"forwards x {cfg.n_layers} layers")
    return eng, [r.generated for r in reqs], launches[1], verify_ticks


def rows_depend_on_batch(torch, params, B=4, Sq=SPEC_K + 1):
    """Does a [B*Sq, d] product give other bits than the same rows as Sq
    products of [B, d] (the decode's shape)?  The reason the verify forward
    runs its dense layers position by position."""
    w = params["unembed"]["w"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, Sq, w.shape[0], device="cuda", generator=gen)
    whole = (x.reshape(-1, w.shape[0]) @ w).reshape(B, Sq, -1)
    cols = torch.stack([x[:, s].contiguous() @ w for s in range(Sq)], 1)
    return float((whole - cols).abs().max())


@phase("speculative path")
def speculative_phase(torch, cfg, params, plain_reqs):
    """(a) the main path's trace with a drafter replaying its tokens, (b) a
    repeated-pattern trace with the n-gram drafter against its plain run,
    (c) at cut depth, the kernels against the plain oracles.  Returns the
    verify kernel's launches in (a) and (b)'s prompts (for the chaos
    path)."""
    import numpy as np
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    diff = rows_depend_on_batch(torch, params)
    print(f"[chip_smoke] unembedding rows of one [{4 * (SPEC_K + 1)}, "
          f"{cfg.d_model}] product vs {SPEC_K + 1} products of [4, "
          f"{cfg.d_model}]: max |diff| {diff:.3e} (the verify forward runs "
          f"its dense layers per position)")
    want = [r.generated for r in plain_reqs]
    eng, got, verify_launches, _ = serve_speculative(
        torch, np, cfg, params, [r.prompt for r in plain_reqs],
        len(want[0]), ReplayDrafter(np, plain_reqs), "speculative (a) replay",
        speculative="draft")
    if got != want:
        raise SystemExit(f"[chip_smoke] speculative (a) serves other tokens "
                         f"than plain greedy: {got} vs {want}")
    if eng.counters["spec_accepted"] == 0:
        raise SystemExit("[chip_smoke] speculative (a) accepted no draft")

    rng = np.random.default_rng(5)
    prompts = [np.resize(rng.integers(0, cfg.vocab, 6 + 5 * i,
                                      dtype=np.int32), 96 + 32 * i)
               for i in range(4)]
    plain = [Request(prompt=p.copy(), max_new_tokens=16) for p in prompts]
    PagedEngine(cfg, params, ServeConfig(max_slots=4, page_size=16,
                                         max_len=512)).generate(plain)
    _, got, _, _ = serve_speculative(
        torch, np, cfg, params, prompts, 16, label="speculative (b) ngram",
        speculative="ngram")
    if got != [r.generated for r in plain]:
        raise SystemExit("[chip_smoke] speculative (b) serves other tokens "
                         "than plain greedy")
    print("[chip_smoke] speculative (a) and (b) serve the plain greedy "
          "tokens")

    # (c) Kernels vs plain oracles, speculative, at cut depth (width kept).
    depth = min(4, cfg.n_layers)
    cut = cfg.replace(segments=((cfg.segments[0][0], depth),))
    cut_params = dict(params, seg0=params["seg0"][:depth])
    short = make_requests(np, Request, 2, 2, 6, cfg.vocab)
    PagedEngine(cut, cut_params, ServeConfig(
        max_slots=4, page_size=16, max_len=512)).generate(short)
    streams = [[r.generated for r in short]]
    for fused in (True, False):
        t = time.perf_counter()
        streams.append(serve_speculative(
            torch, np, cut, cut_params, [r.prompt for r in short], 6,
            ReplayDrafter(np, short), f"cut depth {depth}, fused={fused}",
            speculative="draft", fused_decode=fused)[1])
        print(f"[chip_smoke] cut depth {depth} speculative fused_decode="
              f"{fused}: {time.perf_counter() - t:.3f} s")
    if not streams[0] == streams[1] == streams[2]:
        raise SystemExit(f"[chip_smoke] at cut depth plain greedy, "
                         f"speculative kernels and speculative plain oracles "
                         f"disagree: {streams}")
    print(f"[chip_smoke] at depth {depth}: speculative kernels, speculative "
          f"plain oracles and plain greedy give identical tokens")
    return verify_launches, prompts


def count_ops(torch, fn):
    """Device operations ``fn`` issues: the CUDA kernels and copies
    torch.profiler records, and the aten operators it dispatches (one
    kernel each, bar views)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    with Count():
        fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            if "memcpy" in ev.key.lower() or "memset" in ev.key.lower():
                copies += ev.count
            else:
                kernels += ev.count
    return kernels, copies, Count.n


class SamplerTimer:
    """CUDA events around every call of the engine's sampler while the
    context is open: the device span from the sampler's first kernel to its
    last, idle gaps between launches included."""

    def __init__(self, torch):
        from repro_torch.serving import engine
        self.torch, self.engine, self.events = torch, engine, []
        self.real = engine.sample_tokens

    def _timed(self, *a):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(*a)
        end.record()
        self.events.append((start, end))
        return out

    def __enter__(self):
        self.engine.sample_tokens = self._timed
        return self

    def __exit__(self, *exc):
        self.engine.sample_tokens = self.real

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


def sampler_card_vs_cpu(torch, vocab):
    """(a) The seeded sampler on [20, vocab] logits made from a seed: key
    words, random bits and uniforms bit-equal between the card and the
    CPU, tokens equal at both temperatures.  Returns the kernels and
    copies of one call at a decode tick's shape."""
    import numpy as np
    from repro_torch.serving import sampling as S
    rng = np.random.default_rng(11)
    R = 4 * (SPEC_K + 1)
    logits = torch.as_tensor(rng.normal(size=(R, vocab)).astype(np.float32))
    rids = rng.integers(0, 2**31 - 1, R).astype(np.int32)
    counts = rng.integers(0, 4096, R).astype(np.int32)
    keys = {}
    for dev in ("cuda", "cpu"):
        k = S.fold_in(S.fold_in(S.prng_key(SAMPLE_SEED, dev), rids), counts)
        keys[dev] = (k, S.random_bits(k, vocab),
                     S.uniform(k, vocab, float(np.finfo(np.float32).tiny)))
    for name, a, b in zip(("key words", "random bits", "uniforms"),
                          keys["cuda"], keys["cpu"]):
        a = a.cpu()
        if name == "uniforms":
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise SystemExit(f"[chip_smoke] sampler: {name} differ between "
                             f"the card and the CPU in "
                             f"{int((a != b).sum())} entries")
    noise = (S.gumbel(keys["cuda"][0], vocab).cpu()
             - S.gumbel(keys["cpu"][0], vocab)).abs().max()
    card = logits.cuda()
    for t in (TEMPERATURE, 1.0):
        a = S.sample_tokens(S.prng_key(SAMPLE_SEED), card, rids, counts, t)
        b = S.sample_tokens(S.prng_key(SAMPLE_SEED), logits, rids, counts, t)
        if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
            raise SystemExit(f"[chip_smoke] sampler at temperature {t}: "
                             f"card tokens {a.tolist()} vs CPU {b.tolist()}")
    # Timed and counted as the engine calls it: base key on the host.
    host_key = S.prng_key(SAMPLE_SEED).numpy()
    ms = {}
    for rows in (4, R):
        x = card[:rows].contiguous()
        ms[rows] = cuda_ms(torch, lambda: S.sample_tokens(
            host_key, x, rids[:rows], counts[:rows], TEMPERATURE),
            iters=20, warmup=3)
    kernels, copies, aten = count_ops(torch, lambda: S.sample_tokens(
        host_key, card[:4].contiguous(), rids[:4], counts[:4], TEMPERATURE))
    print(f"[chip_smoke] sampler [{R}, {vocab}] on the card vs the CPU: key "
          f"words, random bits and uniforms bit-equal, tokens equal at "
          f"temperatures {TEMPERATURE} and 1.0; max|gumbel diff| "
          f"{float(noise):.3e}")
    print(f"[chip_smoke] sampler alone (CUDA events): {ms[4]:.4f} ms at [4, "
          f"{vocab}] (a decode tick), {ms[R]:.4f} ms at [{R}, {vocab}] (a "
          f"verify tick); one call at [4, {vocab}]: {kernels} kernels and "
          f"{copies} copies (torch.profiler), {aten} aten operators on "
          f"both devices (keys folded on the host)")
    return kernels, copies


def serve_sampled(torch, np, cfg, params, label, probe=None, **kw):
    """The main path's trace at TEMPERATURE under SAMPLE_SEED; ``probe``, if
    given, is called with the engine before it serves.  Returns the engine,
    the tokens, the decode launches, the mean pure decode tick and the
    sampler's CUDA-event ms over the run."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    eng = PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, temperature=TEMPERATURE,
        **kw))
    if probe is not None:
        probe(eng)
    if not eng.cfg.fused_decode:
        raise SystemExit(f"[chip_smoke] {label}: fused_decode did not "
                         f"resolve to the kernel on the card")
    decode_ms = []
    real_tick = eng.step

    def timed_step():
        before = dict(eng.counters)
        t = time.perf_counter()
        out = real_tick()
        torch.cuda.synchronize()
        if (eng.counters["decode_steps"] > before["decode_steps"]
                and eng.counters["prefill_chunks"] == before["prefill_chunks"]):
            decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng.step = timed_step
    reqs = make_requests(np, Request, 0, 8, 32, cfg.vocab)
    with SamplerTimer(torch) as timer:
        pd.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs, SAMPLE_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = pd.LAUNCHES
    c = eng.counters
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"[chip_smoke] {label}: {n_tok} new tokens in {wall:.3f} s "
          f"({n_tok / wall:.2f} tok/s); {c['decode_steps']} decode ticks, "
          f"pure decode ticks {len(decode_ms)} at mean "
          f"{np.mean(decode_ms):.2f} ms; paged_decode launches {launches}; "
          f"sampler {len(timer.events)} calls, {timer.ms():.3f} ms in all "
          f"(CUDA events)")
    if launches != cfg.n_layers * c["decode_steps"] or not c["decode_steps"]:
        raise SystemExit(f"[chip_smoke] {label}: {launches} decode launches "
                         f"for {c['decode_steps']} ticks x {cfg.n_layers} "
                         f"layers")
    for r in reqs:
        if len(r.generated) != 32 or not all(0 <= x < cfg.vocab
                                             for x in r.generated):
            raise SystemExit(f"[chip_smoke] {label}: request {r.rid} "
                             f"generated {r.generated}")
    return (eng, [r.generated for r in reqs], launches,
            float(np.mean(decode_ms)), timer)


@phase("sampled path")
def sampled_path_phase(torch, cfg, params, greedy_tick_ms):
    """(a) the sampler on the card against the CPU, (b) the main trace
    sampled, uncontended and oversubscribed, (c) sampled speculative
    serving.  Returns the decode kernel's launches in (b), the verify
    kernel's in (c)'s replay run, (b)'s uncontended tokens and the prefill
    chunks of its oversubscribed run (which recomputes on resume)."""
    import numpy as np
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    kernels, copies = sampler_card_vs_cpu(torch, cfg.vocab)

    full, want, l_full, tick_ms, timer = serve_sampled(
        torch, np, cfg, params, "sampled (b) uncontended")
    worst = sum(sorted(-(-(len(p) + 31) // 16) for p in
                       (r.prompt for r in full.requests.values()))[-4:])
    print(f"[chip_smoke] sampled (b): oversubscribed pool {OVERSUB_POOL_BLOCKS}"
          f" blocks (capacity {OVERSUB_POOL_BLOCKS - 1}) against {worst} for "
          f"the four largest worst-case reservations; uncontended pool "
          f"{full.layout.pool_blocks}")
    over, got, l_over, _, _ = serve_sampled(
        torch, np, cfg, params, "sampled (b) oversubscribed",
        oversubscribe=True, pool_blocks=OVERSUB_POOL_BLOCKS)
    c = over.counters
    recomputed = c["prefill_tokens"] - full.counters["prefill_tokens"]
    print(f"[chip_smoke] sampled (b) oversubscribed: {c['preemptions']} "
          f"preemptions ({[r.preemptions for r in over.requests.values()]} "
          f"by request), {c['preempt_freed_blocks']} blocks freed, "
          f"{c['preempt_dropped_tokens']} cached tokens dropped, {recomputed} "
          f"tokens recomputed on resume; peak live blocks "
          f"{over.pool.peak_live_blocks} vs {full.pool.peak_live_blocks}")
    if c["preemptions"] < 1:
        raise SystemExit("[chip_smoke] sampled (b): the oversubscribed run "
                         "preempted nothing")
    if got != want:
        raise SystemExit(f"[chip_smoke] sampled (b): oversubscribed tokens "
                         f"differ from the uncontended run's: {got} vs {want}")
    if over.pool.available() != over.pool.capacity:
        raise SystemExit("[chip_smoke] sampled (b): the pool did not drain")
    per_tick = timer.ms() / len(timer.events)
    print(f"[chip_smoke] sampled (b): oversubscribed tokens equal to the "
          f"uncontended run's; mean pure decode tick sampled {tick_ms:.2f} "
          f"ms vs greedy {greedy_tick_ms:.2f} ms (main path, this call); "
          f"sampler {per_tick:.4f} ms per call on the served path (CUDA "
          f"events), {kernels} kernels + {copies} copies per decode tick")

    # (c) Speculative serving at TEMPERATURE against the plain sampled
    # runs: the main trace with drafts replaying (b)'s tokens, and the
    # speculative phase's repeated-pattern trace with the n-gram drafter.
    reqs = [full.requests[rid] for rid in sorted(full.requests)]
    eng, got, verify_launches, _ = serve_speculative(
        torch, np, cfg, params, [r.prompt for r in reqs], 32,
        ReplayDrafter(np, reqs), "sampled (c) replay", seed=SAMPLE_SEED,
        speculative="draft", temperature=TEMPERATURE)
    if got != want:
        raise SystemExit("[chip_smoke] sampled (c): replay speculative "
                         "tokens differ from plain sampled")
    if eng.counters["spec_accepted"] == 0:
        raise SystemExit("[chip_smoke] sampled (c) replay accepted no draft")
    rng = np.random.default_rng(5)
    prompts = [np.resize(rng.integers(0, cfg.vocab, 6 + 5 * i,
                                      dtype=np.int32), 96 + 32 * i)
               for i in range(4)]
    plain = [Request(prompt=p.copy(), max_new_tokens=16) for p in prompts]
    PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512,
        temperature=TEMPERATURE)).generate(plain, SAMPLE_SEED)
    want = [r.generated for r in plain]
    _, got, _, _ = serve_speculative(
        torch, np, cfg, params, prompts, 16, label="sampled (c) ngram",
        seed=SAMPLE_SEED, speculative="ngram", temperature=TEMPERATURE)
    if got != want:
        raise SystemExit("[chip_smoke] sampled (c): n-gram speculative "
                         "tokens differ from plain sampled")
    print("[chip_smoke] sampled (c): replay and n-gram speculative serving "
          "give the plain sampled tokens")
    return (l_full + l_over, verify_launches, [r.generated for r in reqs],
            c["prefill_chunks"])


class ChaosProbe:
    """Builds the chaos harness's engines and watches them across crashes:
    decode and verify forwards run on the kernel (an engine's
    ``fused_decode`` after the guarded call: a fault degrades before the
    forward runs), decode-only tick times by the engine's state, each
    restore's wall time (engine build and restore) and what it requeued,
    and each snapshot's ``snapshot()`` time."""

    def __init__(self, torch, cfg, params, scfg, drafter=None):
        self.torch, self.cfg, self.params = torch, cfg, params
        self.scfg, self.drafter = scfg, drafter
        self.fused = {"decode": 0, "verify": 0}
        self.tick_ms = {True: [], False: []}
        self.restores, self.snapshot_ms = [], []
        self.engine = None
        self.verified_before_crash = False

    def make(self):
        from repro_torch.serving import PagedEngine
        t0 = time.perf_counter()
        crashed = self.engine
        if crashed is not None and self.fused["verify"]:
            self.verified_before_crash = True
        eng = self.engine = PagedEngine(self.cfg, self.params, self.scfg,
                                        drafter=self.drafter)

        def counted(name):
            real = getattr(eng, f"_guarded_{name}")

            def call(*a):
                out = real(*a)
                self.fused[name] += bool(eng.cfg.fused_decode)
                return out
            setattr(eng, f"_guarded_{name}", call)

        counted("decode")
        counted("verify")
        real_step, real_restore, real_snapshot = (eng.step, eng.restore,
                                                  eng.snapshot)

        def step():
            before = dict(eng.counters)
            t = time.perf_counter()
            out = real_step()
            self.torch.cuda.synchronize()
            if (eng.counters["decode_steps"] > before["decode_steps"]
                    and eng.counters["prefill_chunks"]
                    == before["prefill_chunks"]):
                self.tick_ms[bool(eng.cfg.fused_decode)].append(
                    (time.perf_counter() - t) * 1e3)
            return out

        def restore(state):
            real_restore(state)
            self.torch.cuda.synchronize()
            # Context prefilled again: every request that held a slot, and
            # every queued one that had started (a preemption victim).
            reqs = {d["rid"]: d for d in state["requests"]}
            ctx = sum(len(reqs[rid]["prompt"])
                      + max(len(reqs[rid]["generated"]) - 1, 0)
                      for rid in state["active"] + state["queue"]
                      if rid in state["active"] or reqs[rid]["generated"])
            self.restores.append({
                "s": time.perf_counter() - t0,
                "crash_tick": crashed.ticks, "snapshot_tick": state["ticks"],
                "requeued": len(state["active"]) + len(state["queue"]),
                "context_tokens": ctx})

        def snapshot():
            t = time.perf_counter()
            out = real_snapshot()
            self.snapshot_ms.append((time.perf_counter() - t) * 1e3)
            return out

        eng.step, eng.restore, eng.snapshot = step, restore, snapshot
        return eng

    def report(self, np, label):
        for r in self.restores:
            print(f"[chip_smoke] {label}: restore after the crash at tick "
                  f"{r['crash_tick']} from the tick-{r['snapshot_tick']} "
                  f"snapshot: {r['s']:.3f} s (engine build and restore), "
                  f"{r['crash_tick'] - r['snapshot_tick']} ticks replayed, "
                  f"{r['requeued']} requests requeued, {r['context_tokens']} "
                  f"context tokens to prefill again")
        mean = lambda xs: f"{np.mean(xs):.2f} ms ({len(xs)})" if xs else "none"
        print(f"[chip_smoke] {label}: decode-only ticks on the kernel "
              f"{mean(self.tick_ms[True])}, degraded to the plain oracle "
              f"{mean(self.tick_ms[False])}; engine.snapshot() "
              f"{mean(self.snapshot_ms)}")


@phase("chaos path")
def chaos_path_phase(torch, cfg, params, plain_reqs, ngram_prompts):
    """(a) the main trace under CHAOS_PLAN, (b) the n-gram trace under a
    drafter failure and a crash, (c) a planeless pool.  Returns the decode
    and verify kernels' launches in (a) and (b)."""
    import os
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import store
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import PagedEngine, Request, ServeConfig

    writes = []
    real_save = store.save_snapshot

    def timed_save(obj, directory, step, interrupt=None):
        t = time.perf_counter()
        final = real_save(obj, directory, step, interrupt)
        writes.append(((time.perf_counter() - t) * 1e3, os.path.getsize(
            os.path.join(final, "snapshot.json"))))
        return final

    store.save_snapshot = timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            launches = chaos_main_trace(torch, np, cfg, params, plain_reqs,
                                        f"{tmp}/a", writes)
            ms = [w[0] for w in writes]
            print(f"[chip_smoke] chaos (a): {len(writes)} snapshot writes, "
                  f"{np.mean([w[1] for w in writes]):.0f} bytes and "
                  f"{np.mean(ms):.3f} ms per write on average (max "
                  f"{max(w[1] for w in writes)} bytes, {max(ms):.3f} ms)")
            launches_b = chaos_spec_trace(torch, np, cfg, params,
                                          ngram_prompts, f"{tmp}/b")
    finally:
        store.save_snapshot = real_save

    # (c) A planeless pool (page_size % 8 != 0): no kernel resolves, the
    # decode gathers each slot's view for the single-query BESF.
    pd.LAUNCHES = pv.LAUNCHES = 0
    eng = PagedEngine(cfg, params, ServeConfig(max_slots=4, page_size=12,
                                               max_len=512))
    layer = eng.caches["seg0"][0]["b0"]
    if eng.cfg.fused_decode or {"kq", "k_amax", "v_amax"} & set(layer):
        raise SystemExit("[chip_smoke] chaos (c): page_size=12 resolved "
                         "the kernel or built a plane pool")
    reqs = make_requests(np, Request, 3, 2, 8, cfg.vocab)
    tick_ms = []
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    while eng.pending():
        steps = eng.counters["decode_steps"]
        chunks = eng.counters["prefill_chunks"]
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if (eng.counters["decode_steps"] > steps
                and eng.counters["prefill_chunks"] == chunks):
            tick_ms.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    if pd.LAUNCHES or pv.LAUNCHES:
        raise SystemExit(f"[chip_smoke] chaos (c): paged kernels launched "
                         f"({pd.LAUNCHES}, {pv.LAUNCHES}) on a planeless pool")
    for r in reqs:
        if len(r.generated) != 8 or not all(0 <= x < cfg.vocab
                                            for x in r.generated):
            raise SystemExit(f"[chip_smoke] chaos (c): request {r.rid} "
                             f"generated {r.generated}")
    print(f"[chip_smoke] chaos (c): page_size=12, prompts "
          f"{[len(r.prompt) for r in reqs]}, 16 tokens in {wall:.3f} s; "
          f"{len(tick_ms)} decode-only ticks at {np.mean(tick_ms):.2f} ms "
          f"(dense gather and single-query BESF, no paged kernel launched)")
    return launches[0] + launches_b[0], launches_b[1]


def chaos_main_trace(torch, np, cfg, params, plain_reqs, snap_dir, writes):
    """Chaos (a); returns the decode and verify kernels' launches."""
    import collections
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import (FaultPlan, Request, ServeConfig,
                                     serve_with_chaos)
    probe = ChaosProbe(torch, cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, oversubscribe=True,
        snapshot_every=CHAOS_SNAPSHOT_EVERY))
    reqs = [Request(prompt=r.prompt.copy(), max_new_tokens=32)
            for r in plain_reqs]
    pd.LAUNCHES = pv.LAUNCHES = 0
    t = time.perf_counter()
    out, rep = serve_with_chaos(probe.make, reqs, seed=0,
                                plan=FaultPlan.scripted(CHAOS_PLAN),
                                snapshot_dir=snap_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = (pd.LAUNCHES, pv.LAUNCHES)
    c = rep["engine_counters"]
    n_tok = sum(len(r.generated) for r in out)
    print(f"[chip_smoke] chaos (a): {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.2f} tok/s); {rep['crashes']} crashes, "
          f"{rep['restores']} restores, {rep['snapshots_taken']} snapshots "
          f"({rep['snapshots_interrupted']} interrupted, "
          f"{rep['staging_reclaimed']} reclaimed); fired {rep['fired']}; "
          f"degradations {c['degradations']}, forced preemptions "
          f"{c['forced_preemptions']}, preemptions {c['preemptions']}")
    print(f"[chip_smoke] chaos (a): decode forwards on the kernel "
          f"{probe.fused['decode']} across {len(probe.restores) + 1} "
          f"engines, paged_decode launches {launches[0]}")
    probe.report(np, "chaos (a)")
    want_kinds = dict(collections.Counter(k for k, _ in CHAOS_PLAN))
    checks = {
        "the main path's tokens": ([r.generated for r in out]
                                   == [r.generated for r in plain_reqs]),
        "one degradation": c["degradations"] == 1,
        "the plan fired whole": (rep["fired_by_kind"] == want_kinds
                                 and rep["unfired"] == []),
        "two restores": rep["crashes"] == rep["restores"] == 2,
        "one interrupted write": rep["snapshots_interrupted"] == 1,
        "one forced preemption": c["forced_preemptions"] == 1,
        "decode launches 24 x fused decode forwards": (
            launches == (cfg.n_layers * probe.fused["decode"], 0)
            and probe.fused["decode"] > 0),
        "degraded ticks timed": (len(probe.tick_ms[False]) > 0
                                 and len(probe.tick_ms[True]) > 0),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] chaos (a) failed: {failed}; report "
                         f"{rep}")
    print(f"[chip_smoke] chaos (a): {', '.join(checks)}: all hold")
    return launches


def chaos_spec_trace(torch, np, cfg, params, prompts, snap_dir):
    """Chaos (b): the speculative phase's repeated-pattern trace at the cut
    depth of its fused-vs-plain check, drafted as that check drafts, by
    replaying the plain tokens (at this depth the n-gram drafter finds no
    match on the trace, so it would verify nothing).  An undisturbed run
    gives the verify ticks; the drafter then fails at the first and the
    host crashes after the third.  Returns the decode and verify kernels'
    launches."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import (FaultPlan, PagedEngine, Request,
                                     ServeConfig, serve_with_chaos)
    depth = min(4, cfg.n_layers)
    cfg = cfg.replace(segments=((cfg.segments[0][0], depth),))
    params = dict(params, seg0=params["seg0"][:depth])
    plain = [Request(prompt=p.copy(), max_new_tokens=16) for p in prompts]
    PagedEngine(cfg, params, ServeConfig(max_slots=4, page_size=16,
                                         max_len=512)).generate(plain)
    want = [r.generated for r in plain]
    drafter = ReplayDrafter(np, plain)
    _, got, _, verify_ticks = serve_speculative(
        torch, np, cfg, params, prompts, 16, drafter,
        f"chaos (b) undisturbed, depth {depth}", speculative="draft")
    if got != want or len(verify_ticks) < 3:
        raise SystemExit(f"[chip_smoke] chaos (b): the undisturbed run gave "
                         f"{'other' if got != want else 'the plain'} tokens "
                         f"and verified at ticks {verify_ticks}")
    plan = (("drafter_fail", verify_ticks[0]), ("crash", verify_ticks[2]))
    probe = ChaosProbe(torch, cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, speculative="draft",
        draft_k=SPEC_K, snapshot_every=2), drafter)
    pd.LAUNCHES = pv.LAUNCHES = 0
    t = time.perf_counter()
    out, rep = serve_with_chaos(
        probe.make, [Request(prompt=p.copy(), max_new_tokens=16)
                     for p in prompts],
        seed=0, plan=FaultPlan.scripted(plan), snapshot_dir=snap_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = (pd.LAUNCHES, pv.LAUNCHES)
    c = rep["engine_counters"]
    print(f"[chip_smoke] chaos (b): depth {depth}, plan {plan} (verify "
          f"ticks of the undisturbed run {verify_ticks}); {wall:.3f} s; "
          f"fired {rep['fired']}; drafter_failures "
          f"{c['drafter_failures']}, spec_ticks {c['spec_ticks']}; verify "
          f"forwards on the kernel {probe.fused['verify']}, paged_verify "
          f"launches {launches[1]}, decode forwards {probe.fused['decode']}, "
          f"paged_decode launches {launches[0]}")
    probe.report(np, "chaos (b)")
    checks = {
        "the plain tokens": [r.generated for r in out] == want,
        "a drafter failure": c["drafter_failures"] >= 1,
        "one restore": rep["crashes"] == rep["restores"] == 1,
        "a verify forward before the crash": probe.verified_before_crash,
        "the plan fired whole": rep["unfired"] == [],
        "launches per layer per fused forward": launches == (
            cfg.n_layers * probe.fused["decode"],
            cfg.n_layers * probe.fused["verify"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] chaos (b) failed: {failed}")
    print(f"[chip_smoke] chaos (b): {', '.join(checks)}: all hold")
    return launches


class TierLog:
    """Wall time (the card synchronized on both sides) and bytes of every
    swap-out and swap-in of the engines it watches, and of every prefix
    record written to or loaded from the store while ``store_patch`` is
    open."""

    def __init__(self, torch):
        self.torch = torch
        self.events = {"swap-out": [], "swap-in": [], "record write": [],
                       "record load": []}

    def _timed(self, fn, *a):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        self.torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def watch(self, eng):
        real_out, real_in = eng._swap_out, eng._swap_in

        def swap_out(slot, exclusive, L, req):
            _, ms = self._timed(real_out, slot, exclusive, L, req)
            if req.rid in eng._swap:
                self.events["swap-out"].append(
                    (ms, eng._swap.nbytes_of(req.rid)))

        def swap_in(req, row, ctx, m, resumed):
            nbytes = eng._swap.nbytes_of(req.rid)
            done = eng.counters["swap_ins"]
            out, ms = self._timed(real_in, req, row, ctx, m, resumed)
            if eng.counters["swap_ins"] > done:
                self.events["swap-in"].append((ms, nbytes))
            return out

        eng._swap_out, eng._swap_in = swap_out, swap_in

    def store_patch(self):
        import contextlib
        import os
        from repro_torch.checkpoint import store
        real_save, real_load = store.save_prefix_record, store.load_prefix_record

        def save(directory, chain, layers, interrupt=None):
            fresh = not os.path.isdir(os.path.join(
                directory, store.prefix_record_name(chain)))
            t = time.perf_counter()
            final = real_save(directory, chain, layers, interrupt)
            if fresh:
                self.events["record write"].append((
                    (time.perf_counter() - t) * 1e3,
                    os.path.getsize(os.path.join(final, "record.npz"))))
            return final

        def load(directory, chain):
            t = time.perf_counter()
            layers = real_load(directory, chain)
            if layers is not None:
                self.events["record load"].append((
                    (time.perf_counter() - t) * 1e3,
                    sum(a.nbytes for lay in layers for a in lay.values())))
            return layers

        @contextlib.contextmanager
        def patched():
            store.save_prefix_record, store.load_prefix_record = save, load
            try:
                yield
            finally:
                store.save_prefix_record = real_save
                store.load_prefix_record = real_load
        return patched()

    def report(self, np, label, kinds):
        for kind in kinds:
            ev = self.events[kind]
            if not ev:
                print(f"[chip_smoke] {label}: no {kind}")
                continue
            ms = [e[0] for e in ev]
            print(f"[chip_smoke] {label}: {len(ev)} {kind}(s), "
                  f"{np.mean([e[1] for e in ev]):.0f} bytes and "
                  f"{np.mean(ms):.3f} ms each on average (max "
                  f"{max(e[1] for e in ev)} bytes, {max(ms):.3f} ms)")
            ev.clear()


def serve_counted(torch, cfg, params, scfg, prompts, new_tokens, label):
    """Serve greedily; checks one decode launch per layer per decode tick.
    Returns the engine, the tokens and the wall seconds."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request
    eng = PagedEngine(cfg, params, scfg)
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    pd.LAUNCHES = 0
    t = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    steps = eng.counters["decode_steps"]
    if pd.LAUNCHES != cfg.n_layers * steps or not steps:
        raise SystemExit(f"[chip_smoke] {label}: {pd.LAUNCHES} decode "
                         f"launches for {steps} ticks x {cfg.n_layers} "
                         f"layers")
    for r in reqs:
        if len(r.generated) != new_tokens or not all(
                0 <= x < cfg.vocab for x in r.generated):
            raise SystemExit(f"[chip_smoke] {label}: request {r.rid} "
                             f"generated {r.generated}")
    return eng, [r.generated for r in reqs], wall


def grids_and_planes(np, cold, warm):
    """(every scale equal, every plane byte equal, the largest relative gap
    between the two engines' scales)."""
    from repro_torch.serving.engine import _amax_arrays, _layers
    gap, same = 0.0, True
    for a, b in zip(_amax_arrays(cold.caches, cold.cfg.scan_layers),
                    _amax_arrays(warm.caches, warm.cfg.scan_layers)):
        same &= bool(np.array_equal(a, b))
        gap = max(gap, float(np.max(np.abs(a - b)
                                    / np.maximum(np.abs(a), 1e-30))))
    planes = all(bool((c["kq"] == w["kq"]).all())
                 for c, w in zip(_layers(cold.caches), _layers(warm.caches)))
    return same, planes, gap


def store_warm_start(torch, np, cfg, params, store_dir, max_slots, label):
    """(b): a cold engine on an empty store serves the trace and flushes
    its registered blocks; a fresh engine on the store serves it again.
    Returns the cold and warm engines, their tokens and the records
    flushed."""
    from repro_torch.serving import ServeConfig
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab, STORE_PREFIX, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab, int(rng.integers(16, 81)), dtype=np.int32)])
        for _ in range(4)]
    scfg = ServeConfig(max_slots=max_slots, page_size=16, max_len=512,
                       pool_blocks=STORE_POOL_BLOCKS,
                       prefix_store_dir=store_dir)
    cold, cold_tok, cold_s = serve_counted(
        torch, cfg, params, scfg, prompts, STORE_NEW, f"{label} cold")
    t = time.perf_counter()
    flushed = cold.flush_prefixes()
    flush_s = time.perf_counter() - t
    warm, warm_tok, warm_s = serve_counted(
        torch, cfg, params, scfg, prompts, STORE_NEW, f"{label} warm")
    cc, wc = cold.counters, warm.counters
    print(f"[chip_smoke] {label}: {max_slots} slot(s), prompts "
          f"{[len(p) for p in prompts]} ({STORE_PREFIX}-token system "
          f"prompt); cold {cold_s:.3f} s, {cc['prefill_chunks']} prefill "
          f"chunks, {cc['prefix_spills']} spills; flush_prefixes() "
          f"{flushed} records in {flush_s:.3f} s; warm {warm_s:.3f} s, "
          f"{wc['prefill_chunks']} prefill chunks, "
          f"{wc['prefix_store_hits']} store hits "
          f"({wc['prefix_store_tokens']} tokens), "
          f"{wc['prefix_hit_tokens']} registry-hit tokens")
    return cold, cold_tok, warm, warm_tok, flushed


@phase("memory path")
def memory_path_phase(torch, cfg, params, want_sampled, recompute_chunks):
    """(a) swap-to-host on the sampled oversubscribed run, (b) the prefix
    store at one slot, by construction, (b') at four slots, measured, (c)
    the host prefix tier spilling to disk at cut depth.  Returns the decode
    kernel's launches."""
    import tempfile
    import numpy as np
    tiers = TierLog(torch)
    eng, got, launches, _, _ = serve_sampled(
        torch, np, cfg, params, "memory (a) swap", probe=tiers.watch,
        oversubscribe=True, pool_blocks=OVERSUB_POOL_BLOCKS,
        swap_host_bytes=SWAP_HOST_BYTES)
    c, rep = eng.counters, eng.memory_report()
    print(f"[chip_smoke] memory (a): {c['preemptions']} preemptions, "
          f"{c['swap_outs']} swap-outs, {c['swap_ins']} swap-ins "
          f"({c['swap_in_tokens']} tokens spliced), {c['swap_fallbacks']} "
          f"fallbacks; {c['prefill_chunks']} prefill chunks against "
          f"{recompute_chunks} in the recompute run; memory_report() {rep}")
    tiers.report(np, "memory (a)", ("swap-out", "swap-in"))
    checks = {
        "the uncontended tokens": got == want_sampled,
        "a preemption swapped out and in": (
            c["preemptions"] >= 1 and c["swap_outs"] >= 1
            and c["swap_ins"] >= 1 and c["swap_in_tokens"] > 0),
        "fewer prefill chunks than recompute":
            c["prefill_chunks"] < recompute_chunks,
        "the swap pool empty, its peak above 0": (
            rep["host_swap_bytes"] == 0 and rep["host_swap_bytes_peak"] > 0),
        "the pool drained": eng.pool.available() == eng.pool.capacity,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] memory (a) failed: {failed}")
    print(f"[chip_smoke] memory (a): {', '.join(checks)}, decode launches "
          f"24 x ticks: all hold")

    with tempfile.TemporaryDirectory() as tmp, tiers.store_patch():
        cold, cold_tok, warm, warm_tok, flushed = store_warm_start(
            torch, np, cfg, params, f"{tmp}/b", 1, "memory (b)")
        tiers.report(np, "memory (b)", ("record write", "record load"))
        same, planes, _ = grids_and_planes(np, cold, warm)
        cc, wc = cold.counters, warm.counters
        launches += cfg.n_layers * (cc["decode_steps"] + wc["decode_steps"])
        saved = wc["prefix_store_tokens"] // cold.scfg.resolved_chunk()
        checks = {
            "the cold tokens": warm_tok == cold_tok,
            "every scale equal": same,
            "every plane byte equal": planes,
            "at least 16 records flushed": flushed >= 16,
            "nothing spilled or injected cold": (
                cc["prefix_spills"] == 0 and cc["prefix_store_hits"] == 0),
            "at least 16 store hits": wc["prefix_store_hits"] >= 16,
            "one prefill chunk fewer per injected chunk, at least 4": (
                cc["prefill_chunks"] - wc["prefill_chunks"] == saved >= 4),
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"[chip_smoke] memory (b) failed: {failed}")
        print(f"[chip_smoke] memory (b): {', '.join(checks)}: all hold")

        cold, cold_tok, warm, warm_tok, _ = store_warm_start(
            torch, np, cfg, params, f"{tmp}/b2", 4, "memory (b')")
        tiers.report(np, "memory (b')", ("record write", "record load"))
        same, _, gap = grids_and_planes(np, cold, warm)
        launches += cfg.n_layers * (cold.counters["decode_steps"]
                                    + warm.counters["decode_steps"])
        # (Plane pools do not compare here: the cold run's four requests
        # each prefilled the system prompt into blocks of their own.)
        print(f"[chip_smoke] memory (b') measured: warm tokens "
              f"{'equal' if warm_tok == cold_tok else 'DIFFER from'} the "
              f"cold ones; scales {'all equal' if same else 'differ'}, "
              f"largest relative gap {gap:.6e}")

        launches += memory_host_tier(torch, np, cfg, params, f"{tmp}/c",
                                     tiers)
    return launches


def memory_host_tier(torch, np, cfg, params, store_dir, tiers):
    """(c) at the cut depth of the speculative fused-vs-plain check: a snug
    pool's LRU evicts registered blocks into a host tier of about one
    record, which spills on to disk; a warm engine on the flushed store
    gives a cold one's tokens.  Both serve at one slot, as the spilling
    engine does, so injection leaves the order of writes as it was.
    Returns the decode kernel's launches."""
    from repro_torch.serving import ServeConfig
    depth = min(4, cfg.n_layers)
    cut = cfg.replace(segments=((cfg.segments[0][0], depth),))
    cut_params = dict(params, seg0=params["seg0"][:depth])
    page = 16
    record = depth * (2 * page * cfg.n_kv_heads * cfg.head_dim * 4 + page * 4)
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, cfg.vocab, 2 * page, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, L,
                                                    dtype=np.int32)])
               for L in (18, 22, 20, 18, 22)]
    base = dict(max_slots=1, page_size=page, max_len=512, prefill_chunk=page)
    eng, tok, wall = serve_counted(
        torch, cut, cut_params, ServeConfig(
            **base, pool_blocks=8, prefix_store_dir=store_dir,
            prefix_host_bytes=record * 3 // 2), prompts, 16, "memory (c)")
    c, rep = eng.counters, eng.memory_report()
    launches = depth * c["decode_steps"]
    print(f"[chip_smoke] memory (c): depth {depth}, pool 8 blocks, host "
          f"tier {record * 3 // 2} bytes (a record is {record}); "
          f"{wall:.3f} s; {c['prefix_spills']} spills, host tier "
          f"evictions {eng._prefix_host.evict_count}; memory_report() {rep}")
    tiers.report(np, "memory (c) spilling", ("record write",))
    checks = {
        "a spill": c["prefix_spills"] >= 1,
        "a host-tier eviction": eng._prefix_host.evict_count >= 1,
        "bytes on disk": rep["disk_prefix_bytes"] > 0,
    }
    eng.flush_prefixes()
    cold, cold_tok, _ = serve_counted(torch, cut, cut_params,
                                      ServeConfig(**base), prompts, 16,
                                      "memory (c) cold")
    warm, warm_tok, _ = serve_counted(
        torch, cut, cut_params, ServeConfig(**base,
                                            prefix_store_dir=store_dir),
        prompts, 16, "memory (c) warm")
    tiers.report(np, "memory (c) flush and warm start",
                 ("record write", "record load"))
    launches += depth * (cold.counters["decode_steps"]
                         + warm.counters["decode_steps"])
    print(f"[chip_smoke] memory (c): warm {warm.counters['prefix_store_hits']}"
          f" store hits, {warm.counters['prefill_chunks']} prefill chunks "
          f"against {cold.counters['prefill_chunks']} cold")
    checks.update({
        "store hits when warm": warm.counters["prefix_store_hits"] >= 1,
        "the cold tokens when warm": warm_tok == cold_tok,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] memory (c) failed: {failed}")
    print(f"[chip_smoke] memory (c): {', '.join(checks)}: all hold")
    return launches


class ApiTimer:
    """Wall time (the card synchronized on both sides) of every call of
    the named engine-API methods of the engines it watches."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {}

    def watch(self, eng, *names):
        for name in names:
            real = getattr(eng, name)

            def timed(*a, _real=real, _name=name):
                self.torch.cuda.synchronize()
                t = time.perf_counter()
                out = _real(*a)
                self.torch.cuda.synchronize()
                self.ms.setdefault(_name, []).append(
                    (time.perf_counter() - t) * 1e3)
                return out

            setattr(eng, name, timed)

    def report(self, np, label):
        for name, ms in self.ms.items():
            print(f"[chip_smoke] {label}: {len(ms)} {name}() calls, "
                  f"{np.mean(ms):.3f} ms each on average (min "
                  f"{min(ms):.3f}, max {max(ms):.3f})")


def drain_streams(door, rids):
    """Run a started door's loop to the end of a drain and collect the
    streams of ``rids`` (each replays from token zero)."""
    import asyncio

    async def go():
        task = asyncio.create_task(door.run())

        async def collect(rid):
            return [tok async for tok in door.stream(rid)]

        gathered = asyncio.gather(*(collect(r) for r in rids))
        door.shutdown("drain")
        toks = await gathered
        await task
        return toks

    return asyncio.run(go())


def door_serve(torch, backend, prompts, new_tokens, clock=None, sla=None):
    """Submit every prompt to an ``AsyncFrontDoor`` over ``backend`` before
    its loop starts, drain it, and collect every stream.  Returns the door,
    the streamed tokens and the wall seconds."""
    from repro_torch.serving.frontdoor import AsyncFrontDoor
    door = AsyncFrontDoor(backend, clock=clock, sla=sla)
    door.start()
    rids = [door.submit(p, new_tokens) for p in prompts]
    t = time.perf_counter()
    toks = drain_streams(door, rids)
    torch.cuda.synchronize()
    return door, toks, time.perf_counter() - t


def first_and_finish(door):
    return {rid: (door.first_token_tick.get(rid),
                  door.finish_tick.get(rid))
            for rid in sorted(door.finish_tick)}


@phase("front door path")
def frontdoor_path_phase(torch, cfg, params, plain_reqs):
    """(a) the main trace through the async door over a paged engine, (b)
    disaggregated behind the door (a one-slot prefill engine hands detached
    prefixes to a four-slot decode engine), (c) at cut depth 4 the engine
    API loop and a snapshot shutdown with restore, (d) the traffic reports.
    Returns the decode kernel's launches."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.runtime import SystemClock
    from repro_torch.serving import PagedEngine, ServeConfig
    from repro_torch.serving.frontdoor import DisaggController, SlaMapper

    prompts = [r.prompt for r in plain_reqs]
    want = [r.generated for r in plain_reqs]
    new_tokens = len(want[0])

    def scfg(slots):
        return ServeConfig(max_slots=slots, page_size=16, max_len=512)

    # (a) The colocated door.
    eng = PagedEngine(cfg, params, scfg(4))
    clock = SystemClock()
    sla = SlaMapper(granularity=clock.granularity)
    pd.LAUNCHES = 0
    door, got, wall_a = door_serve(torch, eng, prompts, new_tokens, clock,
                                   sla)
    launches_a = pd.LAUNCHES
    n_tok = sum(len(t) for t in got)
    steps = eng.counters["decode_steps"]
    print(f"[chip_smoke] front door (a): {n_tok} tokens streamed in "
          f"{wall_a:.3f} s ({n_tok / wall_a:.2f} tok/s), {door.ticks_run} "
          f"ticks ({steps} decode, {eng.counters['prefill_chunks']} "
          f"prefill chunks), tick estimate {sla.tick_estimate * 1e3:.3f} "
          f"ms; (first-token tick, finish tick) by rid "
          f"{first_and_finish(door)}")
    print(f"[chip_smoke] front door (a): kv_bytes_resident() "
          f"{eng.kv_bytes_resident()} (peak), kv_bytes_contiguous_equiv() "
          f"{eng.kv_bytes_contiguous_equiv()}")
    checks = {
        "the main path's tokens": got == want,
        "admission in arrival order": (
            door.admission_log == list(range(len(prompts)))),
        "the pool drained": eng.pool.available() == eng.pool.capacity,
        "decode launches 24 x ticks": (
            launches_a == cfg.n_layers * steps and steps > 0),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] front door (a) failed: {failed}")
    print(f"[chip_smoke] front door (a): {', '.join(checks)}: all hold")

    # (b) Disaggregated behind the door.
    pre, dec = PagedEngine(cfg, params, scfg(1)), PagedEngine(cfg, params,
                                                              scfg(4))
    timer = ApiTimer(torch)
    timer.watch(pre, "prefill", "extract")
    timer.watch(dec, "insert")
    ctl = DisaggController(pre, dec)
    pd.LAUNCHES = 0
    door_b, got_b, wall_b = door_serve(torch, ctl, prompts, new_tokens)
    launches_b = pd.LAUNCHES
    x = ctl.xfer.counters
    blocks = sum(-(-len(p) // 16) for p in prompts)
    per_block = cfg.n_layers * (2 * 16 * cfg.n_kv_heads * cfg.head_dim * 4
                                + 16 * 4)
    n_tok = sum(len(t) for t in got_b)
    print(f"[chip_smoke] front door (b): {n_tok} tokens streamed in "
          f"{wall_b:.3f} s ({n_tok / wall_b:.2f} tok/s against "
          f"{sum(len(t) for t in got) / wall_a:.2f} colocated), "
          f"{door_b.ticks_run} controller ticks; decode engine "
          f"{dec.counters['decode_steps']} decode ticks (colocated {steps}),"
          f" prefill engine {pre.counters['prefill_chunks']} prefill chunks; "
          f"transfers {x}; (first-token tick, finish tick) by rid "
          f"{first_and_finish(door_b)}")
    timer.report(np, "front door (b)")
    same, _, gap = grids_and_planes(np, eng, dec)
    print(f"[chip_smoke] front door (b) measured: the decode engine's scales "
          f"{'all equal' if same else 'differ from'} the colocated "
          f"engine's, largest relative gap {gap:.6e}")
    checks = {
        "the main path's tokens": got_b == want,
        "8 prefixes transferred": x["prefixes_transferred"] == len(prompts),
        f"{blocks} blocks transferred": x["blocks_transferred"] == blocks,
        f"{blocks} x {per_block} payload bytes": (
            x["payload_bytes"] == blocks * per_block),
        "both pools drained": (
            pre.pool.available() == pre.pool.capacity
            and dec.pool.available() == dec.pool.capacity),
        "decode launches 24 x decode-engine ticks, none by prefill": (
            launches_b == cfg.n_layers * dec.counters["decode_steps"]
            and pre.counters["decode_steps"] == 0
            and dec.counters["decode_steps"] > 0),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        if got_b != want:
            diff = [(i, next(j for j, (a, b) in enumerate(zip(g, w))
                             if a != b))
                    for i, (g, w) in enumerate(zip(got_b, want)) if g != w]
            print(f"[chip_smoke] front door (b): (request, first differing "
                  f"token) {diff}")
        raise SystemExit(f"[chip_smoke] front door (b) failed: {failed}")
    print(f"[chip_smoke] front door (b): {', '.join(checks)}: all hold")

    launches_c = frontdoor_cut_depth(torch, np, cfg, params, prompts,
                                     new_tokens)

    # (d) The traffic reports (measured; the reference test's ranges).
    t = time.perf_counter()
    rep = eng.sparsity_report(prompts)
    torch.cuda.synchronize()
    print(f"[chip_smoke] front door (d): sparsity_report() of the 8 prompts "
          f"in {time.perf_counter() - t:.3f} s")
    keys = ("mean_rounds", "plane_fraction", "block_alive_fraction",
            "survivor_fraction")
    print(f"[chip_smoke] front door (d) aggregate: "
          f"{ {k: rep[k] for k in keys} }")
    for r in rep["per_request"]:
        print(f"[chip_smoke] front door (d) prompt {r['prompt_len']}: "
              f"{ {k: r[k] for k in keys + ('n_blocks', 'n_pairs')} }")
    if not all(0.0 < r[k] <= 1.0 for r in rep["per_request"]
               for k in ("plane_fraction", "survivor_fraction")):
        raise SystemExit("[chip_smoke] front door (d): a fraction outside "
                         "(0, 1]")
    return launches_a + launches_b + launches_c


def frontdoor_cut_depth(torch, np, cfg, params, prompts, new_tokens):
    """(c) at the cut depth of the speculative fused-vs-plain check: the
    prefill -> insert -> generate_step loop gives generate()'s tokens, and
    a door with a snapshot directory stopped by ``shutdown("snapshot")``
    once a stream holds 2 tokens restores in a fresh door whose streams
    replay from token zero to the undisturbed tokens.  Returns the decode
    kernel's launches."""
    import asyncio
    import tempfile
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    from repro_torch.serving.frontdoor import AsyncFrontDoor
    depth = min(4, cfg.n_layers)
    cut = cfg.replace(segments=((cfg.segments[0][0], depth),))
    cut_params = dict(params, seg0=params["seg0"][:depth])
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)

    def reqs():
        return [Request(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts]

    pd.LAUNCHES = 0
    ref_eng = PagedEngine(cut, cut_params, scfg)
    ref = reqs()
    ref_eng.generate(ref)
    want = [r.generated for r in ref]
    launches = pd.LAUNCHES
    ok = launches == depth * ref_eng.counters["decode_steps"]

    api = PagedEngine(cut, cut_params, scfg)
    api.begin(0)
    pending, live, out = reqs(), 0, {}
    order = list(pending)
    pd.LAUNCHES = 0
    t = time.perf_counter()
    while pending or live:
        while pending and api.free_slots():
            req = pending.pop(0)
            api.insert(api.prefill(req), api.free_slots()[0])
            out[req.rid] = list(req.generated)
            live += 1
        for ev in api.generate_step():
            out.setdefault(ev["rid"], []).extend(ev["tokens"])
            live -= ev["finished"]
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t
    launches += pd.LAUNCHES
    ok &= pd.LAUNCHES == depth * api.counters["decode_steps"]
    c = api.counters
    print(f"[chip_smoke] front door (c): depth {depth}, engine API loop "
          f"{api_s:.3f} s, {c['prefixes_prefilled']} prefilled, "
          f"{c['prefixes_inserted']} inserted, {c['decode_steps']} decode "
          f"ticks (generate(): {ref_eng.counters['decode_steps']})")
    checks = {
        "the API loop gives generate()'s tokens": (
            [out[r.rid] for r in order] == want
            and [r.generated for r in order] == want),
        "8 prefilled and inserted": (
            c["prefixes_prefilled"] == c["prefixes_inserted"] == len(want)),
        "the pool drained": api.pool.available() == api.pool.capacity,
    }

    with tempfile.TemporaryDirectory() as snap:
        door = AsyncFrontDoor(PagedEngine(cut, cut_params, scfg),
                              snapshot_dir=snap)
        door.start()
        rids = [door.submit(p, new_tokens) for p in prompts]
        partial = {rid: [] for rid in rids}

        async def phase1():
            async def collect(rid):
                async for tok in door.stream(rid):
                    partial[rid].append(tok)

            task = asyncio.create_task(door.run())
            collectors = [asyncio.create_task(collect(r)) for r in rids]
            for _ in range(2000):
                await asyncio.sleep(0)
                if any(len(v) >= 2 for v in partial.values()):
                    break
            door.shutdown("snapshot")
            await task
            await asyncio.gather(*collectors)

        pd.LAUNCHES = 0
        asyncio.run(phase1())
        launches += pd.LAUNCHES
        ok &= pd.LAUNCHES == depth * door.backend.counters["decode_steps"]
        stopped = door.backend.ticks
        t = time.perf_counter()
        door2 = AsyncFrontDoor(PagedEngine(cut, cut_params, scfg),
                               snapshot_dir=snap)
        restored = door2.start()
        restore_s = time.perf_counter() - t
        pd.LAUNCHES = 0
        full = drain_streams(door2, rids)
        torch.cuda.synchronize()
        launches += pd.LAUNCHES
        ok &= pd.LAUNCHES == depth * (door2.backend.counters["decode_steps"]
                                      - door.backend.counters["decode_steps"])
    print(f"[chip_smoke] front door (c): snapshot shutdown at engine tick "
          f"{stopped} with {sum(map(len, partial.values()))} tokens "
          f"streamed, {len(door.interrupted)} streams interrupted; restore "
          f"{restore_s:.3f} s, then {door2.ticks_run} ticks")
    checks.update({
        "a snapshot mid-flight": bool(door.interrupted) and any(
            partial.values()),
        "the restore took the snapshot": restored and door2.restored,
        "every stream replays to the undisturbed tokens": full == want,
        "replays begin with the tokens streamed before the stop": all(
            full[rids.index(rid)][:len(seen)] == seen
            for rid, seen in partial.items()),
        f"decode launches {depth} x ticks": ok,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] front door (c) failed: {failed}")
    print(f"[chip_smoke] front door (c): {', '.join(checks)}: all hold")
    return launches


class LogitTap:
    """The top-k logits of every row an engine samples, by (rid, token
    index): the near-tie test of the dense path's divergence check."""

    def __init__(self, torch, eng, k=8):
        import collections
        self.rows = collections.defaultdict(list)
        real = eng._sample_rows

        def tapped(logits, rids, counts):
            toks = real(logits, rids, counts)
            x = logits.float()
            vals, idx = torch.topk(x, k, dim=-1)
            amax = x.abs().amax(-1)
            for i, (r, c) in enumerate(zip(rids, counts)):
                self.rows[int(r), int(c)].append(
                    (vals[i].cpu().numpy(), idx[i].cpu().numpy(),
                     float(amax[i])))
            return toks

        eng._sample_rows = tapped

    def gap(self, rid, pos, tok_a, tok_b):
        """(logit gap between tok_a and tok_b, max |logit|) in the row whose
        argmax is tok_a (a greedy run's own row), or (inf, nan)."""
        for vals, idx, amax in self.rows[rid, pos]:
            if idx[0] == tok_a:
                hit = [j for j, t in enumerate(idx) if t == tok_b]
                return (float(vals[0] - vals[hit[0]]) if hit
                        else float("inf")), amax
        return float("inf"), float("nan")


def timed_ticks(torch, eng, prefill_key):
    """Wrap ``eng.step`` to time every tick (host clock, synchronised),
    sorted into pure prefill, pure decode and mixed ticks by the
    ``prefill_key`` and ``decode_steps`` counters."""
    ticks = {"prefill": [], "decode": [], "mixed": []}
    real = eng.step

    def step():
        p, d = eng.counters[prefill_key], eng.counters["decode_steps"]
        t = time.perf_counter()
        out = real()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        pre = eng.counters[prefill_key] > p
        dec = eng.counters["decode_steps"] > d
        if pre or dec:
            ticks["mixed" if pre and dec else
                  "prefill" if pre else "decode"].append(dt)
        return out

    eng.step = step
    return ticks


def mean_ms(xs) -> float:
    return float(sum(xs) / len(xs)) if xs else float("nan")


@phase("dense path")
def dense_path_phase(torch, cfg, params, plain_reqs):
    """The dense serving slice at full width and depth, on the main trace:
    (a) the paged engine on ``attn_impl="xla"``; (b) the contiguous engine
    on ``xla``, whose tokens must equal (a)'s or first differ where (a)'s
    logits are a near-tie; (c) the contiguous engine on ``bitstopper_xla``,
    its agreement with the main path printed; (d) the static engine on
    ``xla``, sampled, its sampler's bits for the first key equal to the
    CPU's; (e) the contiguous cache's resident bytes against the paged
    pool's peak.  The dense path runs no kernel of the port: every count is
    set to 0 before it and must read 0 after (the paged kernels serve
    BitStopper only)."""
    import numpy as np
    from repro_torch.kernels import (bitstopper_qk, flash_attention,
                                     paged_decode, paged_verify)
    from repro_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                     Request, ServeConfig,
                                     StaticBucketEngine)
    from repro_torch.serving import sampling as S
    mods = (paged_decode, paged_verify, bitstopper_qk, flash_attention)
    for m in mods:
        m.LAUNCHES = 0
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)
    dense = cfg.replace(attn_impl="xla")
    out = {}

    def serve(label, eng, prefill_key):
        reqs = make_requests(np, Request, 0, 8, 32, cfg.vocab)
        ticks = timed_ticks(torch, eng, prefill_key)
        t = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_tok = sum(len(r.generated) for r in reqs)
        print(f"[chip_smoke] dense {label}: {n_tok} new tokens in "
              f"{wall:.3f} s ({n_tok / wall:.2f} tok/s); "
              f"{len(ticks['decode'])} pure decode ticks at mean "
              f"{mean_ms(ticks['decode']):.2f} ms, {len(ticks['prefill'])} "
              f"pure prefill ticks at mean {mean_ms(ticks['prefill']):.2f} "
              f"ms, {len(ticks['mixed'])} mixed at mean "
              f"{mean_ms(ticks['mixed']):.2f} ms; counters {eng.counters}")
        out[label] = dict(tokens=[r.generated for r in reqs],
                          tok_s=n_tok / wall,
                          decode_ms=mean_ms(ticks["decode"]),
                          prefill_ms=mean_ms(ticks["prefill"]),
                          mixed_ms=mean_ms(ticks["mixed"]))
        return reqs

    # (a) paged on xla: a pure prefill tick is one 64-token chunk.
    paged = PagedEngine(dense, params, scfg)
    tap = LogitTap(torch, paged)
    serve("(a) paged xla", paged, "prefill_chunks")
    # (b) contiguous on xla: a tick that admits prefills whole prompts,
    # then decodes (mixed).
    contiguous = ContinuousBatchingEngine(dense, params, scfg)
    serve("(b) contiguous xla", contiguous, "prefill_tokens")
    a_toks, b_toks = out["(a) paged xla"]["tokens"], \
        out["(b) contiguous xla"]["tokens"]
    diverged = []
    for rid, (ta, tb) in enumerate(zip(a_toks, b_toks)):
        if ta == tb:
            continue
        pos = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
        gap, amax = tap.gap(rid, pos, ta[pos], tb[pos])
        print(f"[chip_smoke] dense (b) request {rid}: first differs from (a) "
              f"at token {pos} ({ta[pos]} vs {tb[pos]}); (a)'s logit gap "
              f"{gap:.6e}, max |logit| {amax:.6e}, ratio "
              f"{gap / amax:.3e}")
        if not gap <= 1e-3 * amax:
            raise SystemExit(f"[chip_smoke] dense: the contiguous engine's "
                             f"request {rid} leaves the paged engine's "
                             f"tokens at {pos} where (a)'s logits are no "
                             f"near-tie")
        diverged.append((rid, pos, gap, amax))
    print(f"[chip_smoke] dense (b) vs (a): {8 - len(diverged)} of 8 "
          f"requests equal token for token"
          + (f"; the others first differ at near-ties {diverged}"
             if diverged else ""))
    # (c) contiguous on bitstopper_xla, against the main path's tokens.
    serve("(c) contiguous bitstopper_xla",
          ContinuousBatchingEngine(cfg, params, scfg), "prefill_tokens")
    main = [r.generated for r in plain_reqs]
    c_toks = out["(c) contiguous bitstopper_xla"]["tokens"]
    same_req = sum(x == y for x, y in zip(c_toks, main))
    same_tok = sum(int(a == b) for x, y in zip(c_toks, main)
                   for a, b in zip(x, y))
    print(f"[chip_smoke] dense (c) vs the main path (paged BitStopper, "
          f"pool-wide scales; the contiguous engine scales per row): "
          f"{same_req} of 8 requests and {same_tok} of 256 tokens equal "
          f"(measured, not checked)")
    # (d) static on xla, sampled: buckets of two 128-token prompts, then
    # 256 and 384; the sampler's bits for the first key against the CPU.
    rng = np.random.default_rng(7)
    static_reqs = [Request(prompt=rng.integers(0, cfg.vocab, n,
                                               dtype=np.int32),
                           max_new_tokens=16) for n in (128, 128, 256, 384)]
    static = StaticBucketEngine(dense, params, ServeConfig(
        max_len=512, temperature=TEMPERATURE))
    first = []
    real_sample = static._sample

    def sample(logits, key):
        if not first:
            first.append((logits.detach().clone(), np.array(key)))
        return real_sample(logits, key)

    static._sample = sample
    t = time.perf_counter()
    static.generate(static_reqs, seed=SAMPLE_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    logits, key = first[0]
    want_key = S.fold_in(S.fold_in(S.prng_key(SAMPLE_SEED).numpy(), 0), 0)
    n = logits.numel()
    card_bits = S.random_bits(torch.as_tensor(key, device=logits.device),
                              n).cpu()
    cpu_bits = S.random_bits(torch.as_tensor(want_key), n)
    card_tok = S.categorical_block(key, logits, TEMPERATURE).cpu()
    cpu_tok = S.categorical_block(want_key, logits.cpu(), TEMPERATURE)
    if not (np.array_equal(key, want_key) and torch.equal(card_bits, cpu_bits)
            and torch.equal(card_tok, cpu_tok)):
        raise SystemExit("[chip_smoke] dense (d): the static sampler's key, "
                         "bits or tokens differ between the card and the CPU")
    n_tok = sum(len(r.generated) for r in static_reqs)
    print(f"[chip_smoke] dense (d) static xla at temperature {TEMPERATURE}, "
          f"seed {SAMPLE_SEED}: prompts {[len(r.prompt) for r in static_reqs]}"
          f", {n_tok} new tokens in {wall:.3f} s ({n_tok / wall:.2f} tok/s); "
          f"first key, {n} random bits and the first tokens equal to the "
          f"CPU's")
    if any(len(r.generated) != 16 for r in static_reqs):
        raise SystemExit("[chip_smoke] dense (d): a request fell short")
    # (e) resident KV bytes.
    cont_bytes = contiguous.kv_bytes_resident()
    paged_peak = paged.kv_bytes_resident()
    want = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 4 * 512 * 4
    print(f"[chip_smoke] dense (e): contiguous kv_bytes_resident "
          f"{cont_bytes} ({cfg.n_layers} x 2 x {cfg.n_kv_heads} x "
          f"{cfg.head_dim} x 4 B x 4 slots x 512 tokens), paged peak "
          f"{paged_peak} ({paged_peak / cont_bytes:.3f} of it)")
    if cont_bytes != want or not 0 < paged_peak < cont_bytes:
        raise SystemExit(f"[chip_smoke] dense (e): {cont_bytes} contiguous "
                         f"bytes (want {want}), paged peak {paged_peak}")
    launched = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in mods}
    print(f"[chip_smoke] dense path kernel launches {launched} (none of "
          f"the port's kernels serves a dense impl)")
    if any(launched.values()):
        raise SystemExit("[chip_smoke] dense path launched a kernel")
    for r in out.values():
        r.pop("tokens")
    return dict(out, static_tok_s=n_tok / wall, contiguous_bytes=cont_bytes,
                paged_peak_bytes=paged_peak, diverged=diverged)


@phase("profile")
def profile_phase(torch, cfg, params, decode_ticks=8, verify_ticks=3):
    """torch.profiler over steady decode ticks, one prefill chunk,
    speculative verify ticks and one cache-free forward per attention
    kernel: device time by kernel, and the device's busy share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)
    eng = PagedEngine(cfg, params, scfg)
    reqs = make_requests(np, Request, 0, 4, 48, cfg.vocab)
    for r in reqs:
        eng.submit(r)
    eng.step()                      # admit all four, first prefill chunk
    torch.cuda.synchronize()
    report_profile(torch, ProfilerActivity, profile, "prefill chunk",
                   eng._prefill_tick, 1)
    while eng._prefill_fifo:
        eng.step()
    report_profile(torch, ProfilerActivity, profile, "decode tick",
                   eng.step, decode_ticks)
    eng.run()

    # Verify ticks: the same requests, drafts replaying the plain tokens.
    spec = PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, speculative="draft",
        draft_k=SPEC_K), drafter=ReplayDrafter(np, reqs))
    for r in reqs:
        spec.submit(Request(prompt=r.prompt.copy(), max_new_tokens=48))
    while spec._prefill_fifo or not spec.counters["spec_ticks"]:
        spec.step()
    spec.step()
    before = dict(spec.counters)
    report_profile(torch, ProfilerActivity, profile, "verify tick",
                   spec.step, verify_ticks)
    d = {k: spec.counters[k] - before[k]
         for k in ("spec_ticks", "spec_bailouts", "decode_tokens")}
    print(f"[chip_smoke] profile verify window: {d['spec_ticks']} verify "
          f"ticks, {d['spec_bailouts']} bailouts, {d['decode_tokens']} "
          f"tokens")

    from repro_torch.models import transformer as T
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (FWD_B, FWD_S)), device="cuda")
    for impl in ("bitstopper", "flash"):
        c = cfg.replace(attn_impl=impl)
        T.forward(params, tokens, c)                  # warm-up
        report_profile(torch, ProfilerActivity, profile, f"forward {impl}",
                       lambda: T.forward(params, tokens, c), 1)


def report_profile(torch, ProfilerActivity, profile, name, fn, n):
    """Device time by kernel (device-side events only, so no operator is
    counted twice), the busy share of the window, and the host time spent
    waiting in device-to-host syncs."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows, sync_us, syncs = [], 0.0, 0
    for ev in prof.key_averages():
        if ev.key == "aten::_local_scalar_dense":
            sync_us += ev.self_cpu_time_total
            syncs += ev.count
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        rows.append((dev, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[chip_smoke] profile {name} x{n}: wall {wall_us / n / 1e3:.3f} "
          f"ms each, device kernels {busy / n / 1e3:.3f} ms each "
          f"({100 * busy / wall_us:.1f}% busy, "
          f"{100 - 100 * busy / wall_us:.1f}% idle); host syncs "
          f"{syncs // n} each, {sync_us / n / 1e3:.3f} ms of host time")
    for dev, count, key in rows[:12]:
        print(f"[chip_smoke]   {dev / n / 1e3:9.3f} ms  {count // n:6d} "
              f"launches  {key[:80]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile decode ticks, a prefill chunk, "
                         "verify ticks and cache-free forwards (prints no "
                         "result line)")
    args = ap.parse_args(argv)
    import torch
    name, smi = device_phase(torch)
    build_phase()
    if args.profile:
        print(smi)
        profile_phase(torch, *build_model(torch))
        return
    rows = [kernel_phase(torch), verify_kernel_phase(torch),
            qk_kernel_phase(torch), flash_kernel_phase(torch)]
    for wide in wide_kernel_phase(torch):
        rows[2].setdefault("wide", []).append(
            {k[3:]: v for k, v in wide.items() if k.startswith("qk_")}
            | {"d": wide["d"], "dv": wide["dv"]})
        rows[3].setdefault("wide", []).append(
            {k[6:]: v for k, v in wide.items() if k.startswith("flash_")}
            | {"d": wide["d"], "dv": wide["dv"]})
    for page in large_page_phase(torch):
        for row in rows[:2]:
            row.setdefault("pages", []).append(dict(page[row["name"]],
                                                    bs=page["bs"]))
    cfg, params = build_model(torch)
    rows[0]["launches"], plain_reqs, greedy_tick_ms = main_path_phase(
        torch, cfg, params)
    rows[0]["launches_large_page_engine"] = large_page_engine_phase(
        torch, cfg, params)
    rows[1]["launches"], ngram_prompts = speculative_phase(
        torch, cfg, params, plain_reqs)
    rows[2]["launches"], rows[3]["launches"] = forward_path_phase(
        torch, cfg, params)
    (rows[0]["launches_sampled_path"], rows[1]["launches_sampled_path"],
     want_sampled, recompute_chunks) = sampled_path_phase(
        torch, cfg, params, greedy_tick_ms)
    (rows[0]["launches_chaos_path"],
     rows[1]["launches_chaos_path"]) = chaos_path_phase(
        torch, cfg, params, plain_reqs, ngram_prompts)
    rows[0]["launches_memory_path"] = memory_path_phase(
        torch, cfg, params, want_sampled, recompute_chunks)
    rows[0]["launches_frontdoor_path"] = frontdoor_path_phase(
        torch, cfg, params, plain_reqs)
    dense = dense_path_phase(torch, cfg, params, plain_reqs)
    print(f"[chip_smoke] dense path summary: {json.dumps(dense)}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
